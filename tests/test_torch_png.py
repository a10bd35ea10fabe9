"""The port's PNG codec (``spine_vision_torch/data/png.py``) against cv2 and PIL.

Reads equal ``cv2.imread`` bit for bit in both of the datasets' modes
(``IMREAD_COLOR`` + BGR->RGB, ``IMREAD_GRAYSCALE``) over PIL-written files of
every colour type at odd widths and one-row heights; the encoder's files,
with each row filter forced, are read back equal by cv2 and PIL; and
malformed files raise.
"""

import ast
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from spine_vision_torch.data import png

SHAPES = [(37, 53), (1, 17), (19, 1), (64, 64)]


def _pil_image(kind: str, shape, rng) -> Image.Image:
    h, w = shape
    if kind == "L":
        return Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8))
    if kind == "L_smooth":  # PIL picks Sub, Up and Paeth rows here
        yy, xx = np.mgrid[0:h, 0:w]
        return Image.fromarray(((np.sin(yy / 7) + np.cos(xx / 5)) * 60 + 128).astype(np.uint8))
    if kind == "RGB":
        return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    if kind == "RGBA":
        return Image.fromarray(rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
    if kind == "LA":
        return Image.fromarray(rng.integers(0, 256, (h, w, 2), dtype=np.uint8), "LA")
    if kind.startswith("P"):  # 256 colours at 8 bits; 13 at 4 bits, 4 at 2 bits
        rgb = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        return rgb.convert("P", palette=Image.ADAPTIVE, colors=int(kind[1:]))
    if kind == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w), dtype=np.uint8) * 255).convert("1")
    if kind == "I16":
        return Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16))
    raise ValueError(kind)


def _cv2(path: Path, mode: str) -> np.ndarray:
    if mode == "gray":
        return cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["L", "L_smooth", "RGB", "RGBA", "LA", "P256", "P13", "P4",
                                  "1", "I16"])
def test_read_equals_cv2_imread(tmp_path, kind, shape):
    """Bit for bit in both modes, the RGB-as-gray reads (libpng's truncating
    15-bit rgb_to_gray) included."""
    path = tmp_path / f"{kind}.png"
    _pil_image(kind, shape, np.random.default_rng(sum(shape))).save(path)
    for mode in ("color", "gray"):
        want = _cv2(path, mode)
        got = png.read_png(path, mode)
        assert got.dtype == np.uint8 and got.shape == want.shape, (mode, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=mode)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("channels", [1, 3])
def test_encoder_filters_read_back_by_cv2_and_pil(tmp_path, filter_type, channels):
    rng = np.random.default_rng(7)
    shape = (29, 31) if channels == 1 else (29, 31, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[:10] = 200  # flat rows, where the filters differ most
    path = tmp_path / "x.png"
    png.write_png(path, img, filter_type)
    data = path.read_bytes()
    lines = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:-16]), np.uint8)
    filters = set(lines.reshape(29, -1)[:, 0].tolist())
    assert filters == {filter_type} if filter_type is not None else filters <= set(range(5))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    mode = "gray" if channels == 1 else "color"
    np.testing.assert_array_equal(_cv2(path, mode), img)
    np.testing.assert_array_equal(png.read_png(path, mode), img)


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24), channels=st.sampled_from([1, 3]),
       filter_type=st.sampled_from([0, 1, 2, 3, 4, None]), seed=st.integers(0, 2**31 - 1))
def test_round_trip(h, w, channels, filter_type, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w) if channels == 1 else (h, w, 3), dtype=np.uint8)
    got = png.decode_png(png.encode_png(img, filter_type), "gray" if channels == 1 else "color")
    np.testing.assert_array_equal(got, img)


def _valid_png() -> bytes:
    return png.encode_png(np.arange(64, dtype=np.uint8).reshape(8, 8))


def _with_ihdr(data: bytes, **changes) -> bytes:
    """``data`` with IHDR fields replaced and its CRC recomputed."""
    fields = dict(zip(("width", "height", "depth", "ctype", "compression", "filter",
                       "interlace"), struct.unpack(">IIBBBBB", data[16:29]), strict=True))
    fields.update(changes)
    payload = struct.pack(">IIBBBBB", *fields.values())
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + payload))
    return data[:16] + payload + crc + data[33:]


@pytest.mark.parametrize("fault,match", [
    ("interlaced", "interlaced"), ("bad_crc", "CRC mismatch"), ("truncated", "truncated"),
    ("short_data", "truncated image data"), ("signature", "not a PNG"),
    ("depth", "unsupported colour type"),
])
def test_malformed_files_raise_naming_the_file(tmp_path, fault, match):
    data = _valid_png()
    if fault == "interlaced":
        data = _with_ihdr(data, interlace=1)
    elif fault == "bad_crc":
        i = data.index(b"IDAT") + 6
        data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
    elif fault == "truncated":
        data = data[:-20]
    elif fault == "short_data":
        data = _with_ihdr(data, height=9)
    elif fault == "signature":
        data = b"GIF89a" + data[6:]
    elif fault == "depth":
        data = _with_ihdr(data, depth=3)
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as info:
        png.read_png(path)
    assert str(path) in str(info.value)


def test_missing_file_raises_as_the_jax_readers_do(tmp_path):
    with pytest.raises(FileNotFoundError, match="Could not read image: .*nope.png"):
        png.read_png(tmp_path / "nope.png")


def test_encoder_rejects_what_the_builders_never_write():
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="filter_type"):
        png.encode_png(np.zeros((4, 4), np.uint8), filter_type=5)


def test_png_module_imports_neither_cv2_nor_pil():
    tree = ast.parse(Path(png.__file__).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"cv2", "PIL"}, roots
