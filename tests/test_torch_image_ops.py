"""The port's image ops (``spine_vision_torch/ops/image.py``) against
``spine_vision_tpu/ops/image.py`` on the same seeded numpy inputs, and
``save_normalized_png`` against the JAX builders' ``_save_normalized_png``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from spine_vision_torch.data.png import read_png, save_normalized_png
from spine_vision_torch.ops import image as ti
from spine_vision_tpu.data.builders.localization import _save_normalized_png
from spine_vision_tpu.ops import image as ji

SHAPES = [(37, 53), (5, 200)]
SIZES = [(48, 48), (17, 91)]


def _arrays(shape):
    rng = np.random.default_rng(sum(shape))
    return {
        "float": rng.normal(100, 30, shape).astype(np.float32),
        "constant": np.full(shape, 100.7, np.float32),
        "uint8": rng.integers(0, 256, shape).astype(np.uint8),
    }


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normalizations_match_jax_exactly(shape):
    for kind, arr in _arrays(shape).items():
        t = torch.from_numpy(arr)
        np.testing.assert_array_equal(ti.normalize_minmax(t).numpy(),
                                      np.asarray(ji.normalize_minmax(arr)), err_msg=kind)
        got = ti.normalize_to_uint8(t).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(ji.normalize_to_uint8(arr)), err_msg=kind)
    # A flat slice keeps its raw (truncated) values, as in the reference.
    assert ti.normalize_to_uint8(torch.full((3, 3), 100.7)).unique().tolist() == [100]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_resizes_match_jax(shape, size):
    """The source coordinates are equal; the jitted JAX lerps round in
    another order (XLA fuses them), a few f32 ulps of 255: bilinear values
    within 1e-3, letterboxed uint8 within one level on at most 1% of pixels."""
    oh, ow = size
    np.testing.assert_array_equal(ti._source_coords(oh, shape[0]).numpy(),
                                  np.asarray(ji._source_coords(oh, shape[0])))
    for kind, arr in _arrays(shape).items():
        t = torch.from_numpy(arr)
        got = ti.bilinear_resize(t, oh, ow).numpy()
        assert got.shape == (oh, ow) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(ji.bilinear_resize(arr, oh, ow)), atol=1e-3,
                                   err_msg=kind)
        boxed = ti.resize_with_padding(t, oh, ow).numpy()
        want = np.asarray(ji.resize_with_padding(arr, oh, ow))
        assert boxed.dtype == np.uint8 and boxed.shape == want.shape
        diff = np.abs(boxed.astype(int) - want.astype(int))
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01, (kind, diff.max())


def test_bilinear_sample_clamps_to_the_border_like_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (9, 11)).astype(np.float32)
    ys = rng.uniform(-3, 12, (40,)).astype(np.float32)
    xs = rng.uniform(-3, 14, (40,)).astype(np.float32)
    got = ti.bilinear_sample(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ji.bilinear_sample(img, ys, xs)),
                               atol=1e-3)


def test_grayscale_to_rgb01_matches_jax():
    u8 = np.random.default_rng(4).integers(0, 256, (7, 5)).astype(np.uint8)
    got = ti.grayscale_to_rgb01(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ji.grayscale_to_rgb01(u8)))


@pytest.mark.parametrize("kind", ["float", "constant", "uint8"])
def test_save_normalized_png_matches_the_jax_builder(tmp_path, kind):
    arr = _arrays((37, 53))[kind]
    save_normalized_png(arr, tmp_path / "port.png")
    _save_normalized_png(arr, tmp_path / "jax.png")
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), want)
    np.testing.assert_array_equal(read_png(tmp_path / "port.png", "gray"), want)
