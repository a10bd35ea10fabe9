"""PNG codec on the standard library's ``zlib`` and numpy.

The JAX package reads its datasets' images with ``cv2.imread``
(``spine_vision_tpu/data/datasets.py:58-75``) and its builders write them
with PIL (``Image.fromarray(u8).save(path)``). This module does both without
either library:

- :func:`read_png` reproduces ``cv2.imread`` in the two modes the datasets
  use: ``"color"`` (``IMREAD_COLOR`` then ``COLOR_BGR2RGB``, ``[H, W, 3]``
  RGB) and ``"gray"`` (``IMREAD_GRAYSCALE``, ``[H, W]``). It reads colour
  types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA) at bit
  depth 8, gray and palette at 1, 2 and 4 bits too, and keeps the high byte
  of 16-bit samples, as cv2 does without ``IMREAD_ANYDEPTH``. Alpha is
  dropped, not composited. A colour image read as gray goes through
  libpng's ``png_set_rgb_to_gray`` arithmetic, as cv2's reader does.
- :func:`write_png` writes 8-bit gray (``L``) or RGB arrays, with one filter
  type for the whole image or, by default, a per-row choice by the smallest
  sum of absolute filtered bytes.

Interlaced (Adam7) files, chunks whose CRC does not match, truncated files
and malformed headers raise ``ValueError`` naming the file; a missing file
raises ``FileNotFoundError("Could not read image: ...")`` as the JAX readers
do.

Unfiltering is sequential along a row (Sub, Average and Paeth read the
reconstructed left neighbour) and down the columns (Up, Average and Paeth
read the row above), but pixel (y, x) needs only (y, x-1), (y-1, x) and
(y-1, x-1). So every anti-diagonal x + y = d is reconstructed at once: H + W
- 1 numpy steps, each a strided view of the padded image.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) as 15-bit fixed
# point: each coefficient * 32768 / 100000, truncated; blue takes the rest.
_RGB_TO_GRAY = (9797, 19234, 32768 - 9797 - 19234)


def _chunks(data: bytes, name: str):
    """``(type, payload)`` of each chunk, each CRC checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG (chunk {ctype!r} runs past the end)")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{name}: CRC mismatch in chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 neighbours: left ``a``, up ``b``,
    up-left ``c``."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct ``[H, W, bpp]`` uint8 from the filtered bytes ``raw`` of
    the same shape and each row's filter type, one anti-diagonal at a time.

    ``W`` counts filter units of ``bpp`` bytes (pixels, or single bytes of
    packed sub-byte rows)."""
    h, w, _ = raw.shape
    stride = w + 1
    # Zero row above and zero unit left of the image: out-of-image neighbours.
    out = np.zeros(((h + 1) * stride, bpp), np.int16)
    rawf = np.zeros_like(out)
    rawf.reshape(h + 1, stride, bpp)[1:, 1:] = raw
    ftype = np.zeros(h + 1, np.int8)
    ftype[1:] = filters
    present = set(np.unique(filters).tolist())
    step = stride - 1  # from (y, x) to (y + 1, x - 1)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)  # rows on this diagonal
        start = (y0 + 1) * stride + (d - y0 + 1)
        sl = slice(start, start + (y1 - y0 - 1) * step + 1, step)
        left = slice(start - 1, sl.stop - 1, step)
        up = slice(start - stride, sl.stop - stride, step)
        upleft = slice(start - stride - 1, sl.stop - stride - 1, step)
        a, b, c = out[left], out[up], out[upleft]
        f = ftype[y0 + 1:y1 + 1, None]
        pred = np.zeros_like(a)
        if FILTER_SUB in present:
            pred = np.where(f == FILTER_SUB, a, pred)
        if FILTER_UP in present:
            pred = np.where(f == FILTER_UP, b, pred)
        if FILTER_AVERAGE in present:
            pred = np.where(f == FILTER_AVERAGE, (a + b) >> 1, pred)
        if FILTER_PAETH in present:
            pred = np.where(f == FILTER_PAETH, _paeth(a, b, c), pred)
        out[sl] = (rawf[sl] + pred) & 0xFF
    return out.reshape(h + 1, stride, bpp)[1:, 1:].astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered row bytes ``[H, stride]`` -> ``[H, W, channels]`` uint8
    samples; of 16-bit samples the high byte (libpng's ``png_set_strip_16``)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, width, channels, 2)[..., 0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :width]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None]


def decode_png(data: bytes, mode: str = "color", name: str = "<bytes>") -> np.ndarray:
    """Decode a PNG held in ``data`` as ``cv2.imread`` would read it in
    ``mode`` ``"color"`` (``[H, W, 3]`` RGB) or ``"gray"`` (``[H, W]``)."""
    if mode not in ("color", "gray"):
        raise ValueError(f"mode must be 'color' or 'gray', not {mode!r}")
    header = palette = None
    idat = []
    for ctype, payload in _chunks(data, name):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise ValueError(f"{name}: malformed IHDR chunk")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{name}: unsupported colour type {ctype} at bit depth {depth}")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{name}: unknown compression or filter method")
    if interlace != 0:
        raise ValueError(f"{name}: interlaced (Adam7) PNGs are not supported")
    if width == 0 or height == 0:
        raise ValueError(f"{name}: empty image {width}x{height}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    try:
        flat = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{name}: corrupt image data ({exc})") from None
    if len(flat) < height * (stride + 1):
        raise ValueError(f"{name}: truncated image data ({len(flat)} of "
                         f"{height * (stride + 1)} bytes)")
    lines = np.frombuffer(flat, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    filters = lines[:, 0]
    if filters.max() > FILTER_PAETH:
        raise ValueError(f"{name}: unknown row filter type {int(filters.max())}")
    bpp = max(1, bits // 8)
    rows = _unfilter(lines[:, 1:].reshape(height, stride // bpp, bpp), filters, bpp)
    px = _samples(rows.reshape(height, stride), width, channels, depth)
    if ctype == 0 and depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))  # png_set_expand_gray_1_2_4_to_8
    if ctype == 3:
        index = px[..., 0]
        if index.max() >= len(palette):
            raise ValueError(f"{name}: palette index past the PLTE chunk")
        px = palette[index]
    elif ctype in (4, 6):
        px = px[..., :-1]  # alpha stripped, not composited
    if px.shape[-1] == 1:
        gray = px[..., 0]
        return gray if mode == "gray" else np.repeat(gray[..., None], 3, axis=-1)
    if mode == "color":
        return np.ascontiguousarray(px)
    return _rgb_to_gray(px)


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's ``png_do_rgb_to_gray`` on 8-bit samples without gamma: gray
    pixels stay, others take the truncated 15-bit weighted sum."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    rc, gc, bc = _RGB_TO_GRAY
    mixed = ((rc * r + gc * g + bc * b) >> 15).astype(np.uint8)
    return np.where((r == g) & (r == b), rgb[..., 0], mixed)


def read_png(path: str | Path, mode: str = "color") -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR)`` + BGR->RGB (``mode="color"``) or
    ``cv2.imread(path, IMREAD_GRAYSCALE)`` (``mode="gray"``) of a PNG file."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except (FileNotFoundError, IsADirectoryError):
        raise FileNotFoundError(f"Could not read image: {path}") from None
    return decode_png(data, mode, name=str(path))


def _filter_rows(img: np.ndarray, bpp: int) -> np.ndarray:
    """The five filters of every row: ``[5, H, W * bpp]`` uint8."""
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    preds = (0, left, up, (left + up) >> 1, _paeth(left, up, upleft))
    return np.stack([(x - p) & 0xFF for p in preds]).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int | None = None) -> bytes:
    """PNG bytes of an 8-bit gray ``[H, W]`` or RGB ``[H, W, 3]`` array.

    ``filter_type`` (0-4) filters every row alike; None picks each row's
    filter by the smallest sum of absolute filtered bytes (as signed),
    libpng's heuristic. The data is deflated at zlib's level 6, PIL's
    default."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"expected uint8 [H, W] or [H, W, 3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"cannot encode an empty image {img.shape}")
    bpp = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, w * bpp)
    candidates = _filter_rows(rows, bpp)
    if filter_type is None:
        cost = np.abs(candidates.view(np.int8).astype(np.int32)).sum(axis=-1)  # [5, H]
        choice = cost.argmin(axis=0)
    elif filter_type in range(5):
        choice = np.full(h, filter_type)
    else:
        raise ValueError(f"filter_type must be 0-4 or None, not {filter_type!r}")
    lines = np.empty((h, w * bpp + 1), np.uint8)
    lines[:, 0] = choice
    lines[:, 1:] = candidates[choice, np.arange(h)]

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(ctype + payload)
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(lines.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray, filter_type: int | None = None) -> None:
    """Write ``img`` (uint8 gray or RGB) to ``path`` as PNG, as
    ``PIL.Image.fromarray(img).save(path)`` would for the JAX builders."""
    Path(path).write_bytes(encode_png(img, filter_type))


def save_normalized_png(arr: np.ndarray, output_path: str | Path) -> None:
    """Min-max normalise ``arr`` to uint8 (``ops/image.py::normalize_to_uint8``,
    on the CPU) and save it as PNG: the builders' ``_save_normalized_png``."""
    import torch

    from spine_vision_torch.ops.image import normalize_to_uint8

    u8 = normalize_to_uint8(torch.as_tensor(np.asarray(arr))).numpy()
    write_png(output_path, u8)
