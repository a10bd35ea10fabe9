"""The port's series preparation (``spine_vision_torch/io/series.py``,
``ops/resample.py``, ``infer/pipeline.py::study_input_from_paths``) against
the JAX package's: the counterparts of ``tests/test_series.py``. The slice
as a whole, from volume files to study results, is
``tests/test_torch_pipeline.py::test_study_results_from_volume_files_match_jax``.

Tolerances:

- the fast middle slice against the naive whole-volume path
  (``resample_to_isotropic``, ``orient("LPI")``, the middle slice), both in
  the port: ``rtol=1e-4, atol=1e-2``, the JAX test's bound (the two paths
  interpolate in another order);
- the port against JAX on the same input, for the slice and the whole-volume
  resample: within 4 f32 ulps of the largest |value| (``4 * eps32 * max``).
  Both take the same f32 steps; the sums of the hat-matrix products and the
  lerps may round in another order or fused.
"""

from dataclasses import replace
from itertools import permutations, product

import numpy as np
import pytest
import torch

from spine_vision_torch import io as tio
from spine_vision_torch.infer import pipeline as tpipe
from spine_vision_torch.io.series import extract_isotropic_middle_slice
from spine_vision_torch.ops.resample import resample_to_isotropic, trilinear_resample
from spine_vision_tpu import io as jio
from spine_vision_tpu.infer import pipeline as jpipe
from spine_vision_tpu.io.series import extract_isotropic_middle_slice as jax_slice
from spine_vision_tpu.ops import resample_to_isotropic as jax_resample

EPS32 = float(np.finfo(np.float32).eps)


def _assert_ulps(got, want, ulps: int = 4):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    bound = ulps * EPS32 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bound, (float(np.abs(got - want).max()), bound)


def _naive(image, iso: float):
    resampled, new_zyx = resample_to_isotropic(
        image.array, image.spacing_zyx, (iso, iso, iso), device="cpu")
    iso_image = replace(image, array=resampled.numpy(),
                        spacing=(new_zyx[2], new_zyx[1], new_zyx[0]),
                        metadata=dict(image.metadata))
    return iso_image.extract_middle_slice(), iso_image.slice_spacing()


def _check_slice(array, spacing, direction, iso):
    image = tio.MedicalImage(array=array, spacing=spacing, direction=direction)
    got, got_spacing = extract_isotropic_middle_slice(image, iso=iso, device="cpu")
    want, want_spacing = _naive(image, iso)
    assert got_spacing == pytest.approx(want_spacing)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    jax_got, jax_spacing = jax_slice(
        jio.MedicalImage(array=array, spacing=spacing, direction=direction), iso=iso)
    assert jax_spacing == got_spacing
    _assert_ulps(got, jax_got)


_DIRECTIONS = [
    np.eye(3),
    np.diag([-1.0, 1.0, 1.0]),
    np.diag([1.0, -1.0, -1.0]),
    np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
]


@pytest.mark.parametrize("direction_idx", range(len(_DIRECTIONS)))
def test_fast_middle_slice_matches_naive(direction_idx):
    rng = np.random.default_rng(direction_idx)
    volume = rng.normal(100, 30, (7, 24, 20)).astype(np.float32)
    _check_slice(volume, (0.7, 0.9, 3.1), _DIRECTIONS[direction_idx], iso=0.5)


def _signed_permutations():
    for perm in permutations(range(3)):
        for signs in product((1.0, -1.0), repeat=3):
            m = np.zeros((3, 3))
            for col, (row, s) in enumerate(zip(perm, signs)):
                m[row, col] = s
            yield m


def _oblique(deg: float) -> np.ndarray:
    """A sagittal direction (x index along P, y along I, z along R, their
    cross product as in a DICOM series) tilted by ``deg`` about S."""
    t = np.deg2rad(deg)
    rot = np.array([[np.cos(t), -np.sin(t), 0.0], [np.sin(t), np.cos(t), 0.0], [0.0, 0.0, 1.0]])
    return rot @ np.array([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


ORIENTATIONS = list(_signed_permutations()) + [_oblique(5.0)]


@pytest.mark.parametrize("case", range(len(ORIENTATIONS)))
def test_fast_middle_slice_all_48_orientations_and_oblique(case):
    """Every signed-permutation direction matrix, and a 5 degree oblique
    sagittal one."""
    rng = np.random.default_rng(case)
    volume = rng.normal(100, 30, (6, 18, 14)).astype(np.float32)
    _check_slice(volume, (0.8, 1.1, 2.7), ORIENTATIONS[case], iso=0.6)


def test_fast_middle_slice_2d_resamples_in_plane():
    image = tio.MedicalImage(array=np.ones((10, 12), dtype=np.float32), spacing=(0.5, 0.8))
    got, spacing = extract_isotropic_middle_slice(image, device="cpu")
    assert got.shape == (27, 20) and spacing == (0.3, 0.3)
    np.testing.assert_allclose(got, 1.0, atol=1e-5)
    plane = np.random.default_rng(4).normal(50, 10, (10, 12)).astype(np.float32)
    want, _ = jax_slice(jio.MedicalImage(array=plane, spacing=(0.5, 0.8)))
    _assert_ulps(extract_isotropic_middle_slice(
        tio.MedicalImage(array=plane, spacing=(0.5, 0.8)), device="cpu")[0], want)


@pytest.mark.parametrize("shape,spacing", [((5, 9, 7), (2.5, 0.7, 0.9)), ((3, 4, 6), (1.0, 0.3, 0.31)),
                                           ((8, 6, 5), (0.2, 0.25, 0.4))])
def test_resample_matches_jax(shape, spacing):
    vol = np.random.default_rng(len(shape)).integers(-300, 3000, shape).astype(np.int16)
    got, new = resample_to_isotropic(vol, spacing, (0.5, 0.5, 0.5), device="cpu")
    want, jnew = jax_resample(vol, spacing, (0.5, 0.5, 0.5))
    assert new == jnew and got.device.type == "cpu"
    _assert_ulps(got.numpy(), want)
    again = trilinear_resample(torch.from_numpy(vol), [0.5 / s for s in spacing], got.shape)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def _write_study(root, name, rng, t1_fmt, t2_fmt, direction):
    """Two seeded int16 series of one study, a sagittal geometry."""
    paths = []
    for series, fmt in (("t1", t1_fmt), ("t2", t2_fmt)):
        vol = rng.normal(300, 80, (5, 20, 24)).clip(0, 4000).astype(np.int16)
        image = tio.MedicalImage(array=vol, spacing=(1.2, 1.5, 4.0), origin=(-20.0, 5.0, 30.0),
                                 direction=direction)
        path = root / f"{name}_{series}{fmt}"
        tio.write_medical_image(image, path)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def study_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("studies")
    rng = np.random.default_rng(11)
    return [
        _write_study(root, "s0", rng, "", ".nii.gz", _oblique(0.0)),
        _write_study(root, "s1", rng, ".mha", ".nrrd", _oblique(5.0)),
    ]


def test_study_input_from_paths(study_files):
    for t1, t2 in study_files:
        got = tpipe.study_input_from_paths(t1, t2, device="cpu")
        want = jpipe.study_input_from_paths(t1, t2)
        assert got.study_id == want.study_id == t2.stem  # "s0_t2.nii" for .nii.gz
        assert (got.t1_spacing, got.t2_spacing) == (want.t1_spacing, want.t2_spacing)
        _assert_ulps(got.t1_slice, want.t1_slice)
        _assert_ulps(got.t2_slice, want.t2_slice)
        assert got.t1_slice.shape == (100, 96)
    assert tpipe.study_input_from_paths(*study_files[0], study_id="x", device="cpu").study_id == "x"
    with pytest.raises(FileNotFoundError):
        tpipe.study_input_from_paths(study_files[0][0], "missing.mha", device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(study_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    image = tio.MedicalImage(array=np.zeros((3, 4, 5), np.int16))
    for call in (lambda: tpipe.study_input_from_paths(*study_files[0]),
                 lambda: extract_isotropic_middle_slice(image),
                 lambda: tio.prepare_series_slice(study_files[0][1]),
                 lambda: resample_to_isotropic(image.array, (1.0, 1.0, 1.0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
