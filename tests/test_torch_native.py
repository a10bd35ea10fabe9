"""The port's host ops (``spine_vision_torch/native``) against the JAX
package's library (``spine_vision_tpu/native``, built with g++): the
counterparts of ``tests/test_native.py``.

``normalize_minmax_u8``, ``assemble_t2t1t2`` and ``resize_bilinear_u8`` are
numpy in the port and equal the JAX library's output bit for bit; the C++
JPEG entropy decoder builds at first use into ``build/``, and a failed build
raises with the compiler's output.
"""

import numpy as np
import pytest

from spine_vision_torch import native
from spine_vision_tpu import native as jnative


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    assert jnative.is_available(), "the JAX package's host ops build here"


def test_build_and_load():
    lib = native.load()
    assert native.library_path().exists() and native.library_path().parent.name == (
        "spine_vision_torch")
    assert native.load() is lib and hasattr(lib, "jpegls_decode_diffs")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*host_ops.cpp"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


@pytest.mark.parametrize("shape", [(3, 37, 53, 24, 48), (2, 8, 8, 4, 4), (1, 5, 7, 13, 11)])
def test_resize_matches_the_jax_library(shape):
    n, h, w, oh, ow = shape
    images = np.random.default_rng(0).integers(0, 256, (n, h, w)).astype(np.uint8)
    got = native.resize_bilinear_u8(images, oh, ow)
    np.testing.assert_array_equal(got, jnative.resize_bilinear_u8(images, oh, ow))
    np.testing.assert_array_equal(native.resize_bilinear_u8(images[0], oh, ow), got[0])


@pytest.mark.parametrize("case", ["linspace", "normal", "constant", "int", "wide", "tiny_span"])
def test_normalize_minmax_matches_the_jax_library(case):
    """The f32 scale ``255 / (hi - lo)`` and truncation of the C++, bit for
    bit (the JAX numpy fallback scales in float64 and can differ)."""
    rng = np.random.default_rng(1)
    arr = {
        "linspace": np.linspace(-5.0, 10.0, 100, dtype=np.float32).reshape(10, 10),
        "normal": rng.normal(100, 30, (64, 48)).astype(np.float32),
        "constant": np.full((4, 4), 7.0),
        "int": rng.integers(-2000, 3000, (3, 20, 20)).astype(np.int16),
        "wide": rng.normal(0, 1e30, (50,)).astype(np.float32),
        "tiny_span": (1.0 + rng.integers(0, 5, (30,)) * 1e-7).astype(np.float32),
    }[case]
    got = native.normalize_minmax_u8(arr)
    want = jnative.normalize_minmax_u8(arr)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "linspace":
        assert got.min() == 0 and got.max() == 255
    if case == "constant":
        assert got.max() == 0


def test_assemble_t2t1t2():
    rng = np.random.default_rng(1)
    t1 = rng.integers(0, 256, (2, 5, 6)).astype(np.uint8)
    t2 = rng.integers(0, 256, (2, 5, 6)).astype(np.uint8)
    for a, b in ((t1, t2), (None, t2), (t1, None)):
        got = native.assemble_t2t1t2(a, b)
        assert got.shape == (2, 5, 6, 3)
        np.testing.assert_array_equal(got, jnative.assemble_t2t1t2(a, b))
    np.testing.assert_array_equal(native.assemble_t2t1t2(t1, t2)[..., 1], t1)
    with pytest.raises(ValueError, match="At least one"):
        native.assemble_t2t1t2(None, None)
