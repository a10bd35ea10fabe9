"""The port's study inference slice against the JAX package's, end to end.

Tiny pipeline shape (loc 64^2, crop 32, padded 128), a ConvNeXt-tiny
localization model (JAX side with both Pallas kernels, interpret mode) and a
ResNet-18 grading model, f32, the same seeded weights in both, in both crop
modes; bucketing of a 3-study request; and the same graph fed from volume
files through ``study_input_from_paths``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.infer import pipeline as tpipe
from spine_vision_torch.models import classifier as tcls
from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
from spine_vision_tpu.infer import StudyInferencePipeline, StudyInput, StudyPipelineConfig
from spine_vision_tpu.models import Classifier, CoordinateRegressor

_CONFIG = {"loc_image_size": (64, 64), "crop_size": (32, 32), "padded_hw": (128, 128)}


@pytest.fixture(scope="module")
def models():
    loc = tcls.CoordinateRegressor("convnext_tiny", dtype=torch.float32, device="cpu")
    cls = tcls.Classifier("resnet18", dtype=torch.float32, device="cpu")
    trees = []
    for model, seed in ((loc, 0), (cls, 1)):
        params, stats = random_flax_variables(model, seed)
        load_flax_variables(model, params, stats)
        trees.append({"params": params, **({"batch_stats": stats} if stats else {})})
    jloc = CoordinateRegressor(backbone_name="convnext_tiny", dtype=jnp.float32, use_pallas=True)
    jcls = Classifier(backbone_name="resnet18", dtype=jnp.float32)
    return loc, cls, jloc, trees[0], jcls, trees[1]


def _studies(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        shapes = [(int(rng.integers(64, 128)), int(rng.integers(64, 128))) for _ in range(2)]
        out.append(dict(
            t1_slice=rng.normal(100, 30, shapes[0]).astype(np.float32),
            t2_slice=rng.normal(100, 30, shapes[1]).astype(np.float32),
            t1_spacing=(0.6, 0.6), t2_spacing=(0.7, 0.5), study_id=f"study{i}",
        ))
    return out


def _run_both(models, mode, studies):
    loc, cls, jloc, jloc_vars, jcls, jcls_vars = models
    port = tpipe.StudyInferencePipeline(
        loc, cls, config=tpipe.StudyPipelineConfig(crop_mode=mode, **_CONFIG), device="cpu"
    )
    ref = StudyInferencePipeline(
        jloc, jloc_vars, jcls, jcls_vars, config=StudyPipelineConfig(crop_mode=mode, **_CONFIG)
    )
    got = port.run([tpipe.StudyInput(**s) for s in studies])
    want = ref.run([StudyInput(**s) for s in studies])
    return got, want


@pytest.mark.parametrize("mode", ["horizontal", "rotated"])
def test_pipeline_matches_jax(models, mode):
    got, want = _run_both(models, mode, _studies(2, 0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.study_id == w.study_id
        np.testing.assert_allclose(g.coords, w.coords, atol=1e-4)
        np.testing.assert_allclose(g.angles, w.angles, atol=1e-2)
        diff = np.abs(g.crops.astype(int) - w.crops.astype(int))
        # Stated: <= 1 uint8 level on at most 1% of the crop pixels.
        assert g.crops.dtype == np.uint8 and diff.max() <= 1 and np.mean(diff > 0) <= 0.01
        assert set(g.logits) == set(w.logits)
        for k in w.logits:
            # f32 end to end; crops one level apart move logits by ~1e-3.
            np.testing.assert_allclose(g.logits[k], w.logits[k], atol=5e-3, err_msg=k)
            np.testing.assert_allclose(g.probabilities[k], w.probabilities[k], atol=5e-3)
            np.testing.assert_array_equal(g.predictions[k], w.predictions[k])


def test_three_studies_bucket_to_four(models):
    got, want = _run_both(models, "horizontal", _studies(3, 1))
    assert tpipe._bucket_count(3, True) == 4 and tpipe._bucket_count(5, True) == 8
    assert tpipe._bucket_count(3, False) == 3
    assert [r.study_id for r in got] == ["study0", "study1", "study2"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.coords, w.coords, atol=1e-4)
        for k in w.logits:
            np.testing.assert_allclose(g.logits[k], w.logits[k], atol=5e-3, err_msg=k)


def test_fetch_crops_false_leaves_crops_out(models):
    loc, cls = models[0], models[1]
    port = tpipe.StudyInferencePipeline(
        loc, cls, config=tpipe.StudyPipelineConfig(**_CONFIG), device="cpu"
    )
    studies = [tpipe.StudyInput(**s) for s in _studies(1, 2)]
    with_crops = port.run(studies)[0]
    without = port.run(studies, fetch_crops=False)[0]
    assert without.crops is None and with_crops.crops.shape == (2, 5, 32, 32)
    for k in with_crops.logits:
        np.testing.assert_array_equal(without.logits[k], with_crops.logits[k])


def test_oversized_slice_is_rejected(models):
    loc, cls = models[0], models[1]
    port = tpipe.StudyInferencePipeline(
        loc, cls, config=tpipe.StudyPipelineConfig(**_CONFIG), device="cpu"
    )
    study = tpipe.StudyInput(
        np.zeros((200, 10), np.float32), np.zeros((10, 10), np.float32), (1, 1), (1, 1)
    )
    with pytest.raises(ValueError, match="padded_hw"):
        port.run([study])


def test_study_results_from_volume_files_match_jax(tmp_path):
    """The slice as a whole: volume files (a DICOM series, ``.nii.gz``,
    ``.mha``, ``.nrrd``; one study 5 degrees oblique) ->
    ``study_input_from_paths`` -> ``StudyInferencePipeline`` at its default
    crop mode, the port on the CPU against the JAX package on the same files
    with the same Flax variables, within this file's tolerances. ResNet-18
    localization and grading keep the JAX compile short; the tests above
    hold the ConvNeXt kernels' path and both crop modes."""
    from spine_vision_torch import io as tio
    from spine_vision_tpu.infer import study_input_from_paths

    rng = np.random.default_rng(11)
    sagittal = np.array([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    t = np.deg2rad(5.0)
    tilt = np.array([[np.cos(t), -np.sin(t), 0.0], [np.sin(t), np.cos(t), 0.0], [0, 0, 1.0]])
    files = []
    for name, formats, direction in (("s0", ("", ".nii.gz"), sagittal),
                                     ("s1", (".mha", ".nrrd"), tilt @ sagittal)):
        pair = []
        for series, suffix in zip(("t1", "t2"), formats):
            vol = rng.normal(300, 80, (5, 20, 24)).clip(0, 4000).astype(np.int16)
            path = tmp_path / f"{name}_{series}{suffix}"
            tio.write_medical_image(tio.MedicalImage(
                array=vol, spacing=(1.2, 1.5, 4.0), origin=(-20.0, 5.0, 30.0),
                direction=direction), path)
            pair.append(path)
        files.append(pair)
    loc = tcls.CoordinateRegressor("resnet18", dtype=torch.float32, device="cpu")
    cls = tcls.Classifier("resnet18", dtype=torch.float32, device="cpu")
    trees = []
    for model, seed in ((loc, 0), (cls, 1)):
        params, stats = random_flax_variables(model, seed)
        load_flax_variables(model, params, stats)
        trees.append({"params": params, **({"batch_stats": stats} if stats else {})})
    port = tpipe.StudyInferencePipeline(
        loc, cls, config=tpipe.StudyPipelineConfig(**_CONFIG), device="cpu")
    ref = StudyInferencePipeline(
        CoordinateRegressor(backbone_name="resnet18", dtype=jnp.float32), trees[0],
        Classifier(backbone_name="resnet18", dtype=jnp.float32), trees[1],
        config=StudyPipelineConfig(**_CONFIG))
    got = port.run([tpipe.study_input_from_paths(a, b, device="cpu") for a, b in files])
    want = ref.run([study_input_from_paths(a, b) for a, b in files])
    assert [g.study_id for g in got] == [w.study_id for w in want] == ["s0_t2.nii", "s1_t2"]
    assert got[0].crops.shape == (2, 5, 32, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.coords, w.coords, atol=1e-4)
        np.testing.assert_allclose(g.angles, w.angles, atol=1e-2)
        diff = np.abs(g.crops.astype(int) - w.crops.astype(int))
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01
        for k in w.logits:
            np.testing.assert_allclose(g.logits[k], w.logits[k], atol=5e-3, err_msg=k)
            np.testing.assert_allclose(g.probabilities[k], w.probabilities[k], atol=5e-3)
            np.testing.assert_array_equal(g.predictions[k], w.predictions[k])
