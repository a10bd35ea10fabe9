"""The port's JPEG Lossless codec (``spine_vision_torch/io/jpeg_lossless.py``)
and its C++ entropy decoder (``spine_vision_torch/native``) against the JAX
package's: the counterparts of ``tests/test_jpeg_lossless.py``.

Lossless means exact: every decode equals the image bit for bit. The port's
encoder writes the JAX encoder's bytes; each package decodes the other's
streams; the hand-derived ITU-T T.81 vectors decode to their pixels in both;
and the C++ entropy decoder equals the Python one (the plain version) and
the JAX package's library on every stream, restart intervals included, or
raises the same error.
"""

import struct

import numpy as np
import pytest

from spine_vision_torch import native
from spine_vision_torch.io import dicom as tdcm
from spine_vision_torch.io import jpeg_lossless as tjl
from spine_vision_tpu import native as jnative
from spine_vision_tpu.io import jpeg_lossless as jjl

RNG = np.random.default_rng(42)


def _both_decode(data: bytes) -> np.ndarray:
    got = tjl.decode_jpeg_lossless(data)
    want = jjl.decode_jpeg_lossless(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("psv", [1, 2, 3, 4, 5, 6, 7])
def test_roundtrip_all_predictors(psv):
    img = RNG.integers(0, 65536, size=(23, 31), dtype=np.uint16)
    data = tjl.encode_jpeg_lossless(img, psv=psv)
    assert data == jjl.encode_jpeg_lossless(img, psv=psv)
    np.testing.assert_array_equal(_both_decode(data), img)


def test_roundtrip_smooth_and_extremes():
    yy, xx = np.mgrid[0:40, 0:28]
    smooth = ((np.sin(yy / 5.0) + np.cos(xx / 7.0) + 2) * 16000).astype(np.uint16)
    extremes = np.zeros((8, 8), np.uint16)
    extremes[::2, ::2] = 65535  # max-magnitude differences incl. SSSS=16
    for img in (smooth, extremes, np.zeros((1, 1), np.uint16), np.full((3, 1), 7, np.uint16)):
        data = tjl.encode_jpeg_lossless(img)
        assert data == jjl.encode_jpeg_lossless(img)
        np.testing.assert_array_equal(_both_decode(data), img)


@pytest.mark.parametrize("precision", [8, 12])
def test_roundtrip_low_precision(precision):
    img = RNG.integers(0, 1 << precision, size=(16, 16), dtype=np.uint16)
    data = tjl.encode_jpeg_lossless(img, precision=precision)
    assert data == jjl.encode_jpeg_lossless(img, precision=precision)
    np.testing.assert_array_equal(_both_decode(data), img)


def test_rejects_non_lossless_sof():
    data = bytearray(tjl.encode_jpeg_lossless(np.zeros((4, 4), np.uint16)))
    idx = bytes(data).find(b"\xff\xc3")
    data[idx + 1] = 0xC0
    with pytest.raises(ValueError, match="SOF"):
        tjl.decode_jpeg_lossless(bytes(data))
    for bad in (b"\x00\x00", b"\xff\xd8\xff\xd9", b"\xff\xd8\x00\x01\x02\x03"):
        with pytest.raises(tjl.JpegLosslessError):
            tjl.decode_jpeg_lossless(bad)
        with pytest.raises(jjl.JpegLosslessError):
            jjl.decode_jpeg_lossless(bad)


def _element(group, elem, vr, value: bytes) -> bytes:
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def _common_body(instance: bytes, rows: int, cols: int) -> bytes:
    return b"".join([
        _element(0x0008, 0x0060, b"CS", b"MR"),
        _element(0x0020, 0x000E, b"UI", b"9.8.7\x00"),
        _element(0x0020, 0x0013, b"IS", instance),
        _element(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _element(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _element(0x0028, 0x0030, b"DS", b"0.5\\0.5 "),
        _element(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        _element(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
    ])


def _write(path, pixels: np.ndarray, instance: bytes, jpeg: bool):
    ts = b"1.2.840.10008.1.2.4.70\x00" if jpeg else b"1.2.840.10008.1.2.1\x00"
    body = _common_body(instance, *pixels.shape)
    if jpeg:
        frag = tjl.encode_jpeg_lossless(pixels, psv=1)
        frag += b"\x00" * (len(frag) % 2)
        body += (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
                 + struct.pack("<HHI", 0xFFFE, 0xE000, 0)
                 + struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag
                 + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    else:
        body += _element(0x7FE0, 0x0010, b"OW", pixels.astype("<u2").tobytes())
    path.write_bytes(b"\x00" * 128 + b"DICM" + _element(0x0002, 0x0010, b"UI", ts) + body)


def test_jpegll_dicom_matches_uncompressed_twin(tmp_path):
    from spine_vision_tpu.io.dicom import read_dicom_series as jread

    (tmp_path / "plain").mkdir()
    (tmp_path / "jll").mkdir()
    for i in range(3):
        pixels = RNG.integers(0, 4096, size=(12, 10), dtype=np.uint16)
        inst = f"{i + 1} ".encode()[:2]
        _write(tmp_path / "plain" / f"s{i}.dcm", pixels, inst, jpeg=False)
        _write(tmp_path / "jll" / f"s{i}.dcm", pixels, inst, jpeg=True)
    single = tdcm.DicomFile(sorted((tmp_path / "jll").iterdir())[0])
    assert single.transfer_syntax == "1.2.840.10008.1.2.4.70"
    plain = tdcm.read_dicom_series(tmp_path / "plain")
    jll = tdcm.read_dicom_series(tmp_path / "jll")
    np.testing.assert_array_equal(plain.array, jll.array)
    np.testing.assert_allclose(plain.spacing, jll.spacing)
    np.testing.assert_array_equal(jll.array, jread(tmp_path / "jll").array)


def _restart_stream(img: np.ndarray, slab: int, psv: int = 1) -> bytes:
    """A scan with DRI = ``slab`` rows: each interval's entropy is that of
    the slab encoded alone (prediction resets at each RSTn, T.81 H.2.2)."""
    rows, cols = img.shape
    parts = [tjl.encode_jpeg_lossless(img[r:r + slab], psv=psv) for r in range(0, rows, slab)]
    entropy = []
    for part in parts:
        sos = part.index(b"\xff\xda")
        start = sos + 2 + struct.unpack(">H", part[sos + 2:sos + 4])[0]
        entropy.append(part[start:-2])
    head = parts[0][:parts[0].index(b"\xff\xda")]
    sof = head.index(b"\xff\xc3")
    head = head[:sof + 5] + struct.pack(">HH", rows, cols) + head[sof + 9:]
    dri = b"\xff\xdd" + struct.pack(">HH", 4, slab * cols)
    sos = b"\xff\xda" + struct.pack(">H", 8) + bytes([1, 1, 0x00, psv, 0, 0x00])
    body = b"".join(e + bytes([0xFF, 0xD0 + k % 8]) for k, e in enumerate(entropy[:-1]))
    return head + dri + sos + body + entropy[-1] + b"\xff\xd9"


@pytest.mark.parametrize("slab", [1, 3, 8])
def test_restart_intervals_decode_in_both(slab):
    img = RNG.integers(0, 65536, size=(17, 9), dtype=np.uint16)
    np.testing.assert_array_equal(_both_decode(_restart_stream(img, slab)), img)


def _random_entropy(rng, n: int) -> bytes:
    """Random entropy bytes: stuffed 0xFF00 pairs and RSTn markers among
    them, never another marker."""
    out = bytearray()
    for b in rng.integers(0, 256, n):
        out.append(int(b))
        if b == 0xFF:
            out.append(0x00 if rng.random() < 0.7 else 0xD0 + int(rng.integers(0, 8)))
    return bytes(out)


def _diffs_outcome(decode):
    try:
        return None, decode()
    except ValueError as exc:
        return str(exc), None


@pytest.mark.parametrize("seed", range(8))
def test_native_entropy_decoder_matches_python_and_jax(seed):
    """The C++ decoder against the plain Python one and the JAX package's
    library on the same random streams (every bit pattern is a code of the
    encoder's complete table), with and without restart intervals, one to
    three components: equal differences, or the same error."""
    rng = np.random.default_rng(seed)
    luts = [tjl._build_decode_lut(tjl._ENC_BITS, tjl._ENC_VALUES)] * (1 + seed % 3)
    ncomp = len(luts)
    entropy = _random_entropy(rng, 200 + 50 * seed)
    ri = (0, 7, 16, 40)[seed % 4]
    total = int(rng.integers(20, 120))
    got = _diffs_outcome(lambda: native.jpegls_decode_diffs(
        *native.jpegls_unstuff_split(entropy), luts, ri, total, ncomp))
    plain = _diffs_outcome(lambda: tjl._decode_diffs(
        tjl._split_restart_intervals(entropy), luts, ri, total, ncomp))
    want = _diffs_outcome(lambda: jnative.jpegls_decode_diffs_raw(
        *jnative.jpegls_unstuff_split(entropy), luts, ri, total, ncomp))
    for other in (plain, want):
        assert got[0] == other[0]
        if got[0] is None:
            np.testing.assert_array_equal(got[1], other[1])


def test_native_decode_matches_python_on_a_slice():
    """A 64x64 12-bit slice: the C++ differences equal the Python decoder's
    bit for bit, and an incomplete table raises the same invalid-code error."""
    img = RNG.integers(0, 4096, size=(64, 64)).astype(np.uint16)
    data = tjl.encode_jpeg_lossless(img)
    _, scans = tjl._parse_markers(data)
    _, _, _, _, entropy, luts, ri = scans[0]
    got = native.jpegls_decode_diffs(*native.jpegls_unstuff_split(entropy), luts, ri, 4096, 1)
    want = tjl._decode_diffs(tjl._split_restart_intervals(entropy), luts, ri, 4096, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tjl.decode_jpeg_lossless(data), img)
    sparse = [tjl._build_decode_lut([1] + [0] * 15, [0])]
    with pytest.raises(ValueError, match="Invalid Huffman code"):
        native.jpegls_decode_diffs(*native.jpegls_unstuff_split(b"\xf0"), sparse, 0, 4, 1)
    with pytest.raises(ValueError, match="Invalid Huffman code"):
        tjl._decode_diffs([b"\xf0"], sparse, 0, 4, 1)


def _marker(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", 2 + len(payload)) + payload


def _sv1_stream(entropy, bits16, values, rows, cols, precision=8, dri=None) -> bytes:
    parts = [b"\xff\xd8", _marker(0xC4, bytes([0x00]) + bytes(bits16) + bytes(values))]
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    parts.append(_marker(0xC3, sof))
    if dri is not None:
        parts.append(_marker(0xDD, struct.pack(">H", dri)))
    parts.append(_marker(0xDA, bytes([1, 1, 0x00, 1, 0, 0x00])))
    parts += [entropy, b"\xff\xd9"]
    return b"".join(parts)


T81_VECTORS = {
    # 2x2 PSV1, codes cat0="0", cat1="10", cat2="110": diffs 0, +1, -1, 0.
    "basic_sv1": (bytes([0x58]), [1, 1, 1] + [0] * 13, [0, 1, 2], 2, 2, None,
                  [[128, 129], [127, 127]]),
    # 1x2: +127 (cat7 "11111110" + "1111111") and -1, a stuffed 0xFF00, 1-pads.
    "stuffing_padding": (bytes([0xFE, 0xFF, 0x00, 0x3F]), [1] * 8 + [0] * 8, list(range(8)),
                         1, 2, None, [[255, 254]]),
    # DRI 2: the second row predicts 128 again after RST0.
    "restart_interval": (bytes([0xFE, 0x90, 0xFF, 0xD0, 0xF8, 0x6F]), [1] * 8 + [0] * 8,
                         list(range(8)), 2, 2, 2, [[200, 200], [100, 100]]),
}


@pytest.mark.parametrize("name", list(T81_VECTORS))
def test_t81_vectors(name):
    entropy, bits16, values, rows, cols, dri, pixels = T81_VECTORS[name]
    data = _sv1_stream(entropy, bits16, values, rows, cols, dri=dri)
    np.testing.assert_array_equal(_both_decode(data), np.array(pixels, dtype=np.uint16))


@pytest.mark.parametrize("tail", [b"\x58\x00", b"\x50", b"\x58\xff\x00"])
def test_t81_dirty_entropy_tail_rejected(tail):
    """Pad bits that are not all 1s, or a whole spare byte, raise in both."""
    data = _sv1_stream(tail, [1, 1, 1] + [0] * 13, [0, 1, 2], rows=2, cols=2)
    with pytest.raises(tjl.JpegLosslessError, match="Corrupt entropy tail"):
        tjl.decode_jpeg_lossless(data)
    with pytest.raises(jjl.JpegLosslessError, match="Corrupt entropy tail"):
        jjl.decode_jpeg_lossless(data)


def test_truncated_scan_and_bad_restart_interval():
    img = RNG.integers(0, 4096, size=(6, 5)).astype(np.uint16)
    data = tjl.encode_jpeg_lossless(img)
    cut = data[:len(data) // 2] + b"\xff\xd9"
    for mod in (tjl, jjl):
        with pytest.raises(mod.JpegLosslessError, match="Truncated scan|Corrupt"):
            mod.decode_jpeg_lossless(cut)
    # Intervals of 7 samples over rows of 5: each interval a run of the
    # default value (every difference 0), decodable, but not row-aligned.
    flat = [tjl._entropy_bits(np.full((1, n), 1 << 15, np.uint16), 1, 16) for n in (7,) * 4 + (2,)]
    entropy = b"".join(e + bytes([0xFF, 0xD0 + k]) for k, e in enumerate(flat[:-1])) + flat[-1]
    odd = _sv1_stream(entropy, tjl._ENC_BITS, tjl._ENC_VALUES, 6, 5, precision=16, dri=7)
    for mod in (tjl, jjl):
        with pytest.raises(mod.JpegLosslessError, match="not a multiple"):
            mod.decode_jpeg_lossless(odd)
