"""Corrupt and truncated files through the port's decoders and the JAX
package's: the counterparts of ``tests/test_io_fuzz.py``.

On every corrupted input both packages raise an exception of the same class
(by name: each package has its own ``DicomError``), from the family the JAX
fuzz tests allow (ValueError and its kin, never TypeError or a crash), or
both decode it to the same array. Each case runs under a wall-clock alarm,
so a decoder caught in a loop over garbage fails the test instead of
wedging the suite.
"""

from __future__ import annotations

import signal
import struct
import zlib
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

from spine_vision_torch import io as tio
from spine_vision_torch.io import jpeg_lossless as tjl
from spine_vision_torch.io.dicom_write import write_dicom_series
from spine_vision_tpu import io as jio
from spine_vision_tpu.io import jpeg_lossless as jjl

# The JAX fuzz tests' family, and zlib.error for a corrupt gzip or zlib body.
_CLEAN_ERRORS = (ValueError, KeyError, IndexError, struct.error, EOFError, OSError, zlib.error)


@contextmanager
def _deadline(seconds: int = 20):
    def _raise(signum, frame):  # pragma: no cover - only on hang
        raise TimeoutError("decoder exceeded fuzz deadline")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _flip_bytes(data: bytes, rng: np.random.Generator, n_flips: int) -> bytes:
    buf = bytearray(data)
    for _ in range(n_flips):
        i = int(rng.integers(0, len(buf)))
        buf[i] ^= int(rng.integers(1, 256))
    return bytes(buf)


def _outcome(fn):
    """(exception class name, None) or (None, the decoded array)."""
    with _deadline():
        try:
            out = fn()
        except _CLEAN_ERRORS as exc:
            return type(exc).__name__, None
    return None, np.asarray(getattr(out, "array", out))


def _assert_same_outcome(port_fn, jax_fn) -> bool:
    got_err, got = _outcome(port_fn)
    want_err, want = _outcome(jax_fn)
    assert got_err == want_err
    if got_err is None:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    return got_err is None


def test_jpeg_lossless_fuzz_corrupt_bytes():
    rng = np.random.default_rng(0)
    blob = tjl.encode_jpeg_lossless(rng.integers(0, 4096, size=(32, 32)).astype(np.uint16))
    decoded = 0
    for trial in range(60):
        bad = _flip_bytes(blob, rng, n_flips=1 + trial % 4)
        decoded += _assert_same_outcome(lambda: tjl.decode_jpeg_lossless(bad),
                                        lambda: jjl.decode_jpeg_lossless(bad))
    assert 0 < decoded < 60  # both outcomes are exercised


def test_jpeg_lossless_fuzz_truncation():
    rng = np.random.default_rng(1)
    blob = tjl.encode_jpeg_lossless(rng.integers(0, 65536, size=(16, 24)).astype(np.uint16))
    for cut in range(2, len(blob), max(1, len(blob) // 40)):
        _assert_same_outcome(lambda: tjl.decode_jpeg_lossless(blob[:cut]),
                             lambda: jjl.decode_jpeg_lossless(blob[:cut]))


@pytest.mark.parametrize("jpeg_lossless", [False, True])
def test_dicom_fuzz_corrupt_bytes(tmp_path: Path, jpeg_lossless: bool):
    rng = np.random.default_rng(2)
    img = tio.MedicalImage(array=rng.integers(0, 4096, size=(1, 24, 24)).astype(np.int16),
                           spacing=(0.7, 0.7, 3.0))
    path = write_dicom_series(img, tmp_path / "src", jpeg_lossless=jpeg_lossless)[0]
    blob = path.read_bytes()
    np.testing.assert_array_equal(tio.read_dicom_file(path).array, img.array)
    bad_path = tmp_path / "bad.dcm"
    for trial in range(60):
        bad_path.write_bytes(_flip_bytes(blob, rng, n_flips=1 + trial % 8))
        _assert_same_outcome(lambda: tio.read_dicom_file(bad_path),
                             lambda: jio.read_dicom_file(bad_path))


def test_dicom_fuzz_truncation(tmp_path: Path):
    rng = np.random.default_rng(3)
    img = tio.MedicalImage(array=rng.integers(0, 4096, size=(1, 16, 16)).astype(np.int16))
    path = tmp_path / "slice.dcm"
    tio.write_medical_image(img, path)
    blob = path.read_bytes()
    bad_path = tmp_path / "cut.dcm"
    for cut in range(8, len(blob), max(1, len(blob) // 40)):
        bad_path.write_bytes(blob[:cut])
        _assert_same_outcome(lambda: tio.read_dicom_file(bad_path),
                             lambda: jio.read_dicom_file(bad_path))


@pytest.mark.parametrize("suffix", ["nii", "nii.gz"])
def test_nifti_fuzz_corrupt_bytes(tmp_path: Path, suffix: str):
    rng = np.random.default_rng(4)
    img = tio.MedicalImage(array=rng.normal(size=(4, 12, 12)).astype(np.float32),
                           spacing=(1.0, 1.0, 2.0))
    path = tmp_path / f"vol.{suffix}"
    tio.write_medical_image(img, path)
    blob = path.read_bytes()
    bad_path = tmp_path / f"bad.{suffix}"
    for trial in range(40):
        bad_path.write_bytes(_flip_bytes(blob, rng, n_flips=1 + trial % 4))
        _assert_same_outcome(lambda: tio.read_nifti(bad_path), lambda: jio.read_nifti(bad_path))
    for cut in range(4, len(blob), max(1, len(blob) // 25)):
        bad_path.write_bytes(blob[:cut])
        _assert_same_outcome(lambda: tio.read_nifti(bad_path), lambda: jio.read_nifti(bad_path))


@pytest.mark.parametrize("ext", ["mha", "nrrd"])
def test_mha_nrrd_fuzz_corrupt_bytes(tmp_path: Path, ext: str):
    rng = np.random.default_rng(5)
    img = tio.MedicalImage(array=rng.integers(0, 1000, size=(3, 10, 10)).astype(np.int16),
                           spacing=(1.0, 1.0, 2.0))
    path = tmp_path / f"vol.{ext}"
    tio.write_medical_image(img, path, use_compression=False)
    blob = path.read_bytes()
    bad_path = tmp_path / f"bad.{ext}"
    for trial in range(40):
        bad_path.write_bytes(_flip_bytes(blob, rng, n_flips=1 + trial % 4))
        _assert_same_outcome(lambda: tio.read_medical_image(bad_path),
                             lambda: jio.read_medical_image(bad_path))
    for cut in range(4, len(blob), max(1, len(blob) // 25)):
        bad_path.write_bytes(blob[:cut])
        _assert_same_outcome(lambda: tio.read_medical_image(bad_path),
                             lambda: jio.read_medical_image(bad_path))
