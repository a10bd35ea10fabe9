"""``spine_vision_torch/io/jpeg.py`` against Pillow, bit for bit.

The port decodes baseline and progressive JPEG where the JAX package calls
``np.asarray(Image.open(f))`` and ``.convert("L")`` or ``.convert("RGB")``.
Every case encodes a seeded image with Pillow and holds the port's decode
(the C++ entropy decoder and its plain Python version) and its ``to_mode``
to Pillow's. The committed fixtures (``tests/fixtures/torch_jpeg``) are held
to the record of Pillow's decodes that ``generate.py`` wrote.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from spine_vision_torch import native
from spine_vision_torch.io import jpeg as tj

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_jpeg"
RECORD = json.loads((FIXTURES / "record.json").read_text())
SAMPLINGS = {"gray": None, "444": 0, "422": 1, "420": 2}


def _image(shape, seed):
    """A smooth image with noise (not pure noise: real JPEG content)."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    planes = [127 + 100 * np.sin(x / (3 + k) + y / (5 + k)) + rng.normal(0, 20, (h, w))
              for k in range(shape[2] if len(shape) == 3 else 1)]
    img = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    return img if len(shape) == 3 else img[..., 0]


def _encode(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow(data: bytes, mode=None) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    return np.asarray(im if mode is None else im.convert(mode))


def _assert_matches_pillow(data: bytes):
    want = _pillow(data)
    for plain in (False, True):
        got = tj.decode_jpeg(data, plain=plain)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    for mode in ("L", "RGB"):
        np.testing.assert_array_equal(tj.to_mode(got, mode), _pillow(data, mode))


@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("size", [(1, 1), (17, 8), (37, 53)])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_decode_matches_pillow(sampling, size, quality):
    shape = size if sampling == "gray" else (*size, 3)
    kw = {} if sampling == "gray" else {"subsampling": SAMPLINGS[sampling]}
    _assert_matches_pillow(_encode(_image(shape, quality + size[0]), quality=quality, **kw))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}])
@pytest.mark.parametrize("sampling", ["gray", "420"])
def test_restart_intervals(sampling, restart):
    shape = (45, 67) if sampling == "gray" else (45, 67, 3)
    kw = {} if sampling == "gray" else {"subsampling": 2}
    data = _encode(_image(shape, 5), quality=80, **restart, **kw)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI and RST0
    _assert_matches_pillow(data)


@pytest.mark.parametrize("sampling", ["gray", "422"])
def test_16_bit_quantization_tables(sampling):
    """Tables above 255 are written as 16-bit DQT entries in an SOF1 frame."""
    shape = (30, 41) if sampling == "gray" else (30, 41, 3)
    kw = {} if sampling == "gray" else {"subsampling": 1}
    tables = [list(range(250, 314)), [300] * 64]
    data = _encode(_image(shape, 6), qtables=tables, **kw)
    assert b"\xff\xc1" in data and b"\xff\xdb\x00\x83\x10" in data  # SOF1, Pq=1
    _assert_matches_pillow(data)


def test_color_spaces_from_markers():
    """No JFIF marker: component ids 'R','G','B' mean RGB samples (no
    YCbCr transform), as libjpeg decides; an Adobe marker's transform flag
    decides over the ids."""
    data = bytearray(_encode(_image((16, 24, 3), 7), quality=90, subsampling=0))
    app0 = data.index(b"\xff\xe0")
    length = int.from_bytes(data[app0 + 2:app0 + 4], "big")
    del data[app0:app0 + 2 + length]  # drop JFIF
    sof = data.index(b"\xff\xc0")
    for i, cid in enumerate(b"RGB"):
        data[sof + 10 + 3 * i] = cid
    sos = data.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        data[sos + 5 + 2 * i] = cid
    _assert_matches_pillow(bytes(data))
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x01"  # transform 1: YCbCr
    _assert_matches_pillow(bytes(data[:2]) + adobe + bytes(data[2:]))


def _scans(data: bytes):
    """Each scan of a stream as the decoder entropy-decodes it."""
    calls = []
    real = tj._decode_entropy

    def spy(entropy, luts, block_comp, restart_interval, n_mcus, plain):
        calls.append((entropy, luts, block_comp, restart_interval, n_mcus))
        return real(entropy, luts, block_comp, restart_interval, n_mcus, plain)

    tj._decode_entropy = spy
    try:
        tj.decode_jpeg(data)
    finally:
        tj._decode_entropy = real
    return calls


@pytest.mark.parametrize("case", ["gray", "420_restarts", "422", "corrupt"])
def test_cpp_entropy_decode_matches_python(case):
    """The C++ scan decoder against its plain version on each scan's
    coefficients, and on corrupt streams: the same error."""
    if case == "gray":
        data = _encode(_image((64, 72), 8), quality=90)
    elif case == "422":
        data = _encode(_image((40, 56, 3), 9), quality=50, subsampling=1)
    else:
        data = _encode(_image((40, 56, 3), 10), quality=70, subsampling=2,
                       restart_marker_blocks=2)
    for entropy, luts, block_comp, ri, n in _scans(data):
        streams = [entropy]
        if case == "corrupt":
            rng = np.random.default_rng(0)
            streams = [entropy[: len(entropy) // 2]]
            for _ in range(8):
                flip = bytearray(entropy)
                flip[rng.integers(0, len(flip))] ^= 1 << int(rng.integers(0, 8))
                streams.append(bytes(flip))
        for stream in streams:
            try:
                want = tj._decode_scan(tj._split_restart_intervals(stream), luts, block_comp,
                                       ri, n)
            except ValueError as exc:
                with pytest.raises(ValueError, match=str(exc).split(":")[0]):
                    native.jpeg_decode_scan(*native.jpegls_unstuff_split(stream), luts,
                                            block_comp, ri, n)
                continue
            got = native.jpeg_decode_scan(*native.jpegls_unstuff_split(stream), luts,
                                          block_comp, ri, n)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(RECORD["files"]))
def test_committed_fixtures_decode_to_the_record(name):
    entry = RECORD["files"][name]
    data = (FIXTURES / name).read_bytes()
    got = tj.decode_jpeg(data)
    assert list(got.shape) == entry["shape"] and {2: "L", 3: "RGB"}[got.ndim] == entry["mode"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    np.testing.assert_array_equal(got, _pillow(data))


@pytest.mark.parametrize("restart", [{}, {"restart_marker_blocks": 1},
                                     {"restart_marker_rows": 1}])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("quality", [5, 75, 100])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_progressive_matches_pillow(sampling, quality, optimize, restart):
    """Progressive JPEG (libjpeg's scan script: spectral selection and
    successive approximation): gray and each chroma sampling, at odd sizes;
    a complete file is never block-smoothed, so it is Pillow's bit for bit.
    The plain Python decoder runs on the two smallest sizes."""
    for size in ((1, 1), (17, 9), (37, 53)):
        shape = size if sampling == "gray" else (*size, 3)
        kw = {} if sampling == "gray" else {"subsampling": SAMPLINGS[sampling]}
        data = _encode(_image(shape, quality + size[1]), quality=quality, progressive=True,
                       optimize=optimize, **restart, **kw)
        assert b"\xff\xc2" in data
        if size == (37, 53):
            np.testing.assert_array_equal(tj.decode_jpeg(data), _pillow(data))
            for mode in ("L", "RGB"):
                np.testing.assert_array_equal(tj.to_mode(tj.decode_jpeg(data), mode),
                                              _pillow(data, mode))
        else:
            _assert_matches_pillow(data)


def test_progressive_native_matches_plain_on_corrupt_scans():
    """The C++ progressive decoder and the Python version on scans with
    flipped bytes: the same coefficients, or the same error."""
    rng = np.random.default_rng(21)
    data = _encode(_image((24, 40, 3), 22), quality=90, progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    outcomes = set()
    for trial in range(12):
        bad = bytearray(data)
        start = sos[trial % len(sos)] + 14
        for at in rng.integers(start, min(start + 30, len(data) - 2), 3):
            bad[at] = rng.integers(0, 255) if bad[at - 1] != 0xFF else bad[at]
        results = []
        for plain in (False, True):
            try:
                results.append(tj.decode_jpeg(bytes(bad), plain=plain))
            except tj.JpegError as exc:
                results.append(str(exc))
        if isinstance(results[0], str):  # the same error (the C++ one counts no MCUs)
            assert results[0].split(":")[:2] == results[1].split(":")[:2]
        else:
            np.testing.assert_array_equal(results[0], results[1])
        outcomes.add(isinstance(results[0], str))
    assert outcomes == {False, True}


def test_fixture_generator_record():
    from fixtures.torch_jpeg import generate

    assert generate.series_slices().shape == (17, 512, 512)
    with Image.open(FIXTURES / "series" / "slice_00.jpg") as im:
        assert im.size == (512, 512) and im.mode == "L"
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*")) < 1.5e6


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    at = data.index(old)
    return data[:at] + new + data[at + len(old):]


@pytest.mark.parametrize("case", ["progressive", "arithmetic", "12_bit", "cmyk", "lossless",
                                  "sampling_4"])
def test_unsupported_frames_raise_item_13(case):
    """Frames the port has no decoder for raise item 13; progressive frames,
    which it now decodes, decode to Pillow's array instead."""
    img = _image((24, 24, 3), 11)
    data = _encode(img, quality=80)
    if case == "progressive":
        _assert_matches_pillow(_encode(img, quality=80, progressive=True))
        return
    if case == "arithmetic":
        data = _patched(data, b"\xff\xc0", b"\xff\xc9")
    elif case == "12_bit":
        data = _patched(data, b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c")
    elif case == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif case == "lossless":
        data = _patched(data, b"\xff\xc0", b"\xff\xc3")
    else:  # luma sampled 4x1
        sof = data.index(b"\xff\xc0")
        data = data[:sof + 11] + b"\x41" + data[sof + 12:]
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tj.decode_jpeg(data)


def test_malformed_streams_raise_an_oserror():
    data = _encode(_image((32, 32, 3), 12), quality=80)
    for bad in (b"\xff\xd8\xff", data[: len(data) // 2], data[:-2], b"not a jpeg"):
        with pytest.raises(OSError):
            _pillow(bad)
        with pytest.raises(tj.JpegError):
            tj.decode_jpeg(bad)
    assert tj.is_jpeg(data) and not tj.is_jpeg(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("mode", ["color", "gray"])
def test_dataset_image_store_reads_jpeg_as_cv2(tmp_path, mode):
    """The datasets' image store reads a baseline or progressive JPEG as the
    JAX datasets' ``cv2.imread`` does: libjpeg's RGB, or its grayscale output
    (the Y plane, not Pillow's ``convert("L")``); 8-bit JPEG Lossless, which
    cv2 does not read, raises."""
    import cv2

    from spine_vision_torch.data.datasets import read_image
    from spine_vision_torch.io.jpeg_lossless import encode_jpeg_lossless

    flag = cv2.IMREAD_COLOR if mode == "color" else cv2.IMREAD_GRAYSCALE
    for i, (shape, kw) in enumerate([((40, 52), {}), ((40, 52, 3), {"subsampling": 2}),
                                     ((33, 47, 3), {"subsampling": 0}),
                                     ((33, 47, 3), {"subsampling": 1}), ((9, 8, 3), {}),
                                     ((40, 52), {"progressive": True}),
                                     ((33, 47, 3), {"progressive": True, "subsampling": 2}),
                                     ((21, 30, 3), {"progressive": True, "subsampling": 0,
                                                    "restart_marker_blocks": 2})]):
        path = tmp_path / f"{i}.jpg"
        path.write_bytes(_encode(_image(shape, 20 + i), quality=80, **kw))
        want = cv2.imread(str(path), flag)
        got = read_image(path, mode)
        np.testing.assert_array_equal(got, want[..., ::-1] if mode == "color" else want)
    lossless = tmp_path / "l.jpg"
    lossless.write_bytes(encode_jpeg_lossless(np.full((8, 8), 9, np.uint16), precision=8))
    assert cv2.imread(str(lossless), flag) is None
    with pytest.raises(NotImplementedError, match="item 13"):
        read_image(lossless, mode)
