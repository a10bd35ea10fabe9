"""Host ops of the input path: the JPEG-Lossless, JPEG and JPEG 2000 entropy
decoders in C++, and the image helpers in numpy.

Counterpart of ``spine_vision_tpu/native/__init__.py``:

- ``jpegls_unstuff_split`` and ``jpegls_decode_diffs`` call the C++ of
  ``src/host_ops.cpp`` (a copy of the JAX package's JPEG functions) through
  ctypes, ``jpeg_decode_scan`` and ``jpeg_decode_progressive`` its
  sequential and progressive Huffman decoders (the port's own; the JAX
  package hands these JPEGs to Pillow), ``j2k_t1_decode``
  its JPEG 2000 tier-1 (the MQ decoder and the coding passes, OpenMP over
  code-blocks; the JAX package hands JPEG 2000 to Pillow), ``pdf_coverage``,
  ``pdf_composite``, ``pdf_resample_axes``, ``pdf_resample_affine`` and
  ``pdf_g4_decode`` the PDF rasteriser's scan converter, compositor, image
  resamplers and CCITT Group 4 decoder (the JAX package hands PDF to
  PyMuPDF). It compiles with
  ``g++ -O3 -fopenmp -shared -fPIC`` at first use into
  ``build/spine_vision_torch/libhost_ops-<hash>.so`` at the repository root
  (the hash covers the source and the flags, so an edited source rebuilds).
  A failed build raises, naming the compiler and its output: there is no
  quiet Python fallback (``io/jpeg_lossless.py`` and ``io/jpeg.py`` keep
  the Python decoders as the tests' plain versions).
- ``normalize_minmax_u8``, ``assemble_t2t1t2`` and ``resize_bilinear_u8``
  are numpy with the C++ library's f32 arithmetic, so their bits equal the
  JAX package's whenever its library is built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from spine_vision_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "src" / "host_ops.cpp"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of this source and these flags is (or will be) built."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhost_ops-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; return its path. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: it builds spine_vision_torch/native")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build {SOURCE.name} ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.jpegls_unstuff_split.argtypes = [u8, i64, u8, i64p, i64]
            lib.jpegls_unstuff_split.restype = i64
            lib.jpegls_decode_diffs.argtypes = [
                u8, i64p, i64, ctypes.POINTER(ctypes.c_uint16), i64, i64, i64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.jpegls_decode_diffs.restype = i64
            lib.jpeg_decode_scan.argtypes = [
                u8, i64p, i64, ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
                i64, i64, i64, ctypes.POINTER(ctypes.c_int16),
            ]
            lib.jpeg_decode_scan.restype = i64
            lib.jpeg_decode_progressive.argtypes = [
                u8, i64p, i64, ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
                i64, i64, i64, i64, i64, i64, i64, ctypes.POINTER(ctypes.c_int16),
            ]
            lib.jpeg_decode_progressive.restype = i64
            lib.j2k_t1_decode.argtypes = [u8, i64p, i64, ctypes.POINTER(ctypes.c_int32)]
            lib.j2k_t1_decode.restype = i64
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.pdf_coverage.argtypes = [i32p, i64, ctypes.c_int32, i64, i64, i64, i64, u8]
            lib.pdf_coverage.restype = i64
            lib.pdf_composite.argtypes = [u8, i64, i64, i64, i64, i64, i64, u8, u8, u8,
                                          ctypes.c_int32, u8, i64, i64, i64, i64]
            lib.pdf_composite.restype = i64
            lib.pdf_resample_axes.argtypes = [u8, i64, i64, i64, i32p, i32p, i64, i64, i32p,
                                              i32p, i64, i64, u8]
            lib.pdf_resample_axes.restype = i64
            lib.pdf_resample_affine.argtypes = [u8, i64, i64, i64, i64p, i64, i64, i64, i64,
                                                u8, u8]
            lib.pdf_resample_affine.restype = i64
            lib.pdf_g4_decode.argtypes = [u8, i64, i64, i64, ctypes.c_int32, i32p, i32p, i32p,
                                          u8, i64, i64p]
            lib.pdf_g4_decode.restype = i64
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def jpegls_unstuff_split(entropy: bytes) -> tuple[np.ndarray, np.ndarray]:
    """0xFF00-unstuff a JPEG entropy segment and split it at RSTn markers.

    Returns (data uint8 [n_unstuffed], offsets int64 [n_chunks + 1])."""
    raw = np.frombuffer(entropy, dtype=np.uint8)
    out = np.empty(max(1, raw.size), dtype=np.uint8)
    max_chunks = raw.size // 2 + 3  # every RSTn takes two bytes
    offsets = np.zeros(max_chunks + 1, dtype=np.int64)
    n_chunks = load().jpegls_unstuff_split(
        _ptr(raw, ctypes.c_uint8), raw.size, _ptr(out, ctypes.c_uint8),
        _ptr(offsets, ctypes.c_int64), max_chunks,
    )
    return out[: offsets[n_chunks]], offsets[: n_chunks + 1]


def jpegls_decode_diffs(
    data: np.ndarray,
    offsets: np.ndarray,
    luts: list[np.ndarray],
    counts_per_interval: int,
    total: int,
    ncomp: int,
) -> np.ndarray:
    """Entropy-decode every difference value, int32 ``[total, ncomp]`` in
    MCU order, from ``jpegls_unstuff_split``'s chunks. ``luts`` holds each
    component's 16-bit peek table, entry ``(code_length << 8) | ssss``;
    ``counts_per_interval`` is the restart interval in MCUs (0: none).
    Raises ``ValueError`` as the Python decoder does: an invalid Huffman
    code, a restart interval whose padding is not 1s, a truncated scan."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    luts_arr = np.ascontiguousarray(np.stack(luts), dtype=np.uint16)
    if luts_arr.shape != (ncomp, 1 << 16):
        raise ValueError(f"expected {ncomp} tables of 65536 entries, got {luts_arr.shape}")
    out = np.empty((total, ncomp), dtype=np.int32)
    got = load().jpegls_decode_diffs(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), len(offsets) - 1,
        _ptr(luts_arr, ctypes.c_uint16), ncomp, counts_per_interval, total,
        _ptr(out, ctypes.c_int32),
    )
    if got == -2:
        raise ValueError("Corrupt entropy tail")
    if got < 0:
        raise ValueError("Invalid Huffman code")
    if got < total:
        raise ValueError(f"Truncated scan: {got}/{total} samples")
    return out


def jpeg_decode_scan(
    data: np.ndarray,
    offsets: np.ndarray,
    luts: np.ndarray,
    block_comp: np.ndarray,
    restart_interval: int,
    n_mcus: int,
) -> np.ndarray:
    """Entropy-decode one baseline (Huffman) scan: int16 ``[n_mcus *
    blocks_per_mcu, 64]``, each block's quantized coefficients in natural
    order, from ``jpegls_unstuff_split``'s chunks. ``luts`` holds the DC then
    the AC 16-bit peek table of each scan component (``[2 * ns, 65536]``,
    entry ``(code_length << 8) | symbol``), ``block_comp`` the scan component
    of each block of an MCU; ``restart_interval`` is in MCUs (0: none).
    Raises ``ValueError`` as ``io/jpeg.py::_decode_scan`` does: an invalid
    Huffman code, a run past the last coefficient, a truncated scan."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    luts = np.ascontiguousarray(luts, dtype=np.uint16)
    block_comp = np.ascontiguousarray(block_comp, dtype=np.int32)
    if luts.ndim != 2 or luts.shape[1] != 1 << 16 or luts.shape[0] < 2 * (block_comp.max() + 1):
        raise ValueError(f"expected [2 * ns, 65536] tables, got {luts.shape}")
    out = np.empty((n_mcus * len(block_comp), 64), dtype=np.int16)
    got = load().jpeg_decode_scan(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), len(offsets) - 1,
        _ptr(luts, ctypes.c_uint16), _ptr(block_comp, ctypes.c_int32), len(block_comp),
        restart_interval, n_mcus, _ptr(out, ctypes.c_int16),
    )
    if got == -1:
        raise ValueError("Invalid Huffman code")
    if got == -2:
        raise ValueError("Coefficient run past the end of a block")
    if got == -3 or got < n_mcus:
        raise ValueError(f"Truncated scan: {max(got, 0)}/{n_mcus} MCUs")
    return out


def jpeg_decode_progressive(
    data: np.ndarray,
    offsets: np.ndarray,
    luts: np.ndarray,
    block_comp: np.ndarray,
    restart_interval: int,
    n_mcus: int,
    progression: tuple,
    blocks: np.ndarray,
) -> np.ndarray:
    """Entropy-decode one progressive (SOF2, Huffman) scan into ``blocks``
    (int16 ``[n_mcus * blocks_per_mcu, 64]``, natural order, the coefficients
    decoded so far; updated and returned). ``progression`` is the scan's (Ss,
    Se, Ah, Al); the other arguments are ``jpeg_decode_scan``'s. Raises
    ``ValueError`` as ``io/jpeg.py::_decode_progressive`` does."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    luts = np.ascontiguousarray(luts, dtype=np.uint16)
    block_comp = np.ascontiguousarray(block_comp, dtype=np.int32)
    if luts.ndim != 2 or luts.shape[1] != 1 << 16 or luts.shape[0] < 2 * (block_comp.max() + 1):
        raise ValueError(f"expected [2 * ns, 65536] tables, got {luts.shape}")
    if blocks.dtype != np.int16 or not blocks.flags.c_contiguous \
            or blocks.shape != (n_mcus * len(block_comp), 64):
        raise ValueError(f"expected contiguous int16 blocks [{n_mcus * len(block_comp)}, 64]")
    ss, se, ah, al = (int(v) for v in progression)
    got = load().jpeg_decode_progressive(
        _ptr(data, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), len(offsets) - 1,
        _ptr(luts, ctypes.c_uint16), _ptr(block_comp, ctypes.c_int32), len(block_comp),
        restart_interval, n_mcus, ss, se, ah, al, _ptr(blocks, ctypes.c_int16),
    )
    if got == -1:
        raise ValueError("Invalid Huffman code")
    if got == -2:
        raise ValueError("Coefficient run past the end of a block")
    if got == -3 or got < n_mcus:
        raise ValueError(f"Truncated scan: {max(got, 0)}/{n_mcus} MCUs")
    return blocks


def j2k_t1_decode(data: np.ndarray, blocks: np.ndarray, total: int) -> np.ndarray:
    """JPEG 2000 tier-1 of every code-block of a tile (code-block style 0),
    OpenMP over the blocks: int32 ``[total]``, each block's ``[height,
    width]`` values in the decoder's doubled magnitudes at its output
    offset. ``blocks`` rows: data offset, length, width, height, orientation
    (0 LL, 1 HL, 2 LH, 3 HH), bit-planes (0: not included), coding passes,
    output offset. ``io/jpeg2000.py::_t1_decode_block`` is the plain
    version."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    blocks = np.ascontiguousarray(blocks, dtype=np.int64).reshape(-1, 8)
    if blocks.size and (int((blocks[:, 0] + blocks[:, 1]).max()) > data.size
                        or int((blocks[:, 7] + blocks[:, 2] * blocks[:, 3]).max()) > total):
        raise ValueError("a code-block outside the data or the output")
    out = np.zeros(max(total, 1), dtype=np.int32)
    load().j2k_t1_decode(_ptr(data, ctypes.c_uint8), _ptr(blocks, ctypes.c_int64),
                         len(blocks), _ptr(out, ctypes.c_int32))
    return out[:total]


def _c(arr: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=dtype)


def _opt(arr: np.ndarray | None, ctype):
    return None if arr is None else _ptr(arr, ctype)


def pdf_coverage(edges: np.ndarray, even_odd: bool, box: tuple) -> np.ndarray:
    """Antialiased coverage, uint8 ``[bh, bw]``, of the pixels of ``box``
    (bx, by, bw, bh) by the polygons of ``edges`` (int32 ``[n, 5]``: x0, y0,
    x1, y1 in 1/256 pixel with y0 < y1, and the winding), 16 x 16 samples a
    pixel, nonzero or even-odd. ``io/pdf_render.py::coverage_plain`` is the
    plain version."""
    edges = _c(edges, np.int32).reshape(-1, 5)
    bx, by, bw, bh = (int(v) for v in box)
    cov = np.zeros((bh, bw), np.uint8)
    if bw > 0 and bh > 0:
        load().pdf_coverage(_ptr(edges, ctypes.c_int32), len(edges), int(even_odd), bx, by, bw,
                            bh, _ptr(cov, ctypes.c_uint8))
    return cov


def pdf_composite(page: np.ndarray, box: tuple, cov: np.ndarray, src: np.ndarray | None,
                  rgb: tuple, alpha: int, clip: tuple | None) -> None:
    """Composite ``src`` (uint8 ``[bh, bw, 3]``) or the colour ``rgb`` with
    coverage ``cov`` onto ``page`` (uint8 ``[H, W, 3]``, in place) at
    ``box``, under ``clip`` ((cx, cy, mask) or None) and ``alpha`` (0-255).
    ``io/pdf_render.py::composite_plain`` is the plain version."""
    if not page.flags.c_contiguous or page.dtype != np.uint8:
        raise ValueError("the page must be contiguous uint8")
    bx, by, bw, bh = (int(v) for v in box)
    cov = _c(cov, np.uint8)
    src = None if src is None else _c(src, np.uint8)
    colour = np.asarray((0, 0, 0) if rgb is None else rgb, np.uint8)
    cx = cy = cw = ch = 0
    mask = None
    if clip is not None:
        cx, cy, mask = clip
        mask = _c(mask, np.uint8)
        ch, cw = mask.shape
    load().pdf_composite(_ptr(page, ctypes.c_uint8), page.shape[1], page.shape[0], bx, by, bw,
                         bh, _ptr(cov, ctypes.c_uint8), _opt(src, ctypes.c_uint8),
                         _ptr(colour, ctypes.c_uint8), int(alpha), _opt(mask, ctypes.c_uint8),
                         int(cx), int(cy), cw, ch)


def pdf_resample_axes(src: np.ndarray, xtab: tuple, ytab: tuple) -> np.ndarray:
    """Separable resampling of ``src`` (uint8 ``[sh, sw, nc]``) by weight
    tables (indices and 14-bit weights, int32 ``[n, taps]``, a row summing
    to 1 << 14): uint8 ``[bh, bw, nc]``. ``io/pdf_render.py::resample_axes_plain``
    is the plain version."""
    src = _c(src, np.uint8)
    sh, sw, nc = src.shape
    xi, xw = (_c(t, np.int32) for t in xtab)
    yi, yw = (_c(t, np.int32) for t in ytab)
    out = np.empty((yi.shape[0], xi.shape[0], nc), np.uint8)
    load().pdf_resample_axes(_ptr(src, ctypes.c_uint8), sh, sw, nc, _ptr(xi, ctypes.c_int32),
                             _ptr(xw, ctypes.c_int32), xi.shape[0], xi.shape[1],
                             _ptr(yi, ctypes.c_int32), _ptr(yw, ctypes.c_int32), yi.shape[0],
                             yi.shape[1], _ptr(out, ctypes.c_uint8))
    return out


def pdf_resample_affine(src: np.ndarray, m: np.ndarray, box: tuple) -> tuple:
    """Bilinear resampling of ``src`` (uint8 ``[sh, sw, nc]``) through the
    fixed-point map ``m`` (int64 [6]: a page pixel's centre in 1/65536
    source pixels) over ``box``: (uint8 ``[bh, bw, nc]``, mask ``[bh, bw]``).
    ``io/pdf_render.py::resample_affine_plain`` is the plain version."""
    src = _c(src, np.uint8)
    sh, sw, nc = src.shape
    m = _c(m, np.int64)
    bx, by, bw, bh = (int(v) for v in box)
    out = np.empty((bh, bw, nc), np.uint8)
    mask = np.empty((bh, bw), np.uint8)
    load().pdf_resample_affine(_ptr(src, ctypes.c_uint8), sh, sw, nc, _ptr(m, ctypes.c_int64),
                               bx, by, bw, bh, _ptr(out, ctypes.c_uint8),
                               _ptr(mask, ctypes.c_uint8))
    return out, mask


def pdf_g4_decode(data: bytes, columns: int, rows: int, byte_align: bool = False) -> np.ndarray:
    """CCITT Group 4 decode: uint8 ``[rows, columns]``, 1 where a pixel is
    black (``rows`` 0: to the end of the data). Raises as
    ``io/pdf_parse.py::g4_decode_plain``, its plain version, does."""
    from spine_vision_torch.io.pdf_parse import PdfError, g4_tables, unsupported

    white, black, modes = g4_tables()
    raw = np.frombuffer(bytes(data), np.uint8)
    max_rows = rows if rows > 0 else max(1, raw.size * 8)
    out = np.zeros((max_rows, columns), np.uint8)
    bad = np.zeros(1, np.int64)
    got = load().pdf_g4_decode(_ptr(_c(raw, np.uint8), ctypes.c_uint8), raw.size, columns, rows,
                               int(byte_align), _ptr(white, ctypes.c_int32),
                               _ptr(black, ctypes.c_int32), _ptr(modes, ctypes.c_int32),
                               _ptr(out, ctypes.c_uint8), max_rows, _ptr(bad, ctypes.c_int64))
    if got == -2:
        raise unsupported("a CCITT extension code")
    if got < 0:
        raise PdfError(f"corrupt CCITT G4 data at row {int(bad[0])}")
    return out if rows > 0 else out[:got]


def normalize_minmax_u8(array: np.ndarray) -> np.ndarray:
    """Min-max normalise any array to uint8 in the C++ library's f32 steps:
    ``inv = 255 / (hi - lo)`` in f32, then ``(x - lo) * inv`` truncated; a
    constant array maps to 0."""
    arr = np.ascontiguousarray(array, dtype=np.float32)
    if arr.size == 0:
        return np.zeros(arr.shape, dtype=np.uint8)
    lo, hi = arr.min(), arr.max()
    with np.errstate(over="ignore"):
        span = hi - lo
    if not span > 0:
        return np.zeros(arr.shape, dtype=np.uint8)
    inv = np.float32(255.0) / span
    return ((arr - lo) * inv).astype(np.uint8)


def assemble_t2t1t2(t1: np.ndarray | None, t2: np.ndarray | None) -> np.ndarray:
    """[T2, T1, T2] channels ``[N, H, W, 3]`` from ``[N, H, W]`` uint8 pairs;
    a missing series is replaced by the other."""
    if t1 is None and t2 is None:
        raise ValueError("At least one of t1/t2 must be given")
    a = np.asarray(t2 if t2 is not None else t1, dtype=np.uint8)
    b = np.asarray(t1 if t1 is not None else t2, dtype=np.uint8)
    return np.stack([a, b, a], axis=-1)


def resize_bilinear_u8(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Batched bilinear resize of ``[N, H, W]`` (or ``[H, W]``) uint8 images.

    The C++ library's ``resize_bilinear_u8_batch`` in numpy, f32 arithmetic
    in its order: half-pixel source coordinates clamped to the edge, the two
    lerps, then ``+ 0.5`` truncated."""
    arr = np.ascontiguousarray(images, dtype=np.uint8)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[None]
    _, in_h, in_w = arr.shape
    f32 = np.float32

    def axis(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        scale = f32(n_in) / f32(n_out)
        src = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        src = np.minimum(np.maximum(src, f32(0.0)), f32(n_in - 1))
        i0 = src.astype(np.int64)
        return i0, np.minimum(i0 + 1, n_in - 1), src - i0.astype(f32)

    y0, y1, wy = axis(in_h, out_h)
    x0, x1, wx = axis(in_w, out_w)
    wy, wx = wy[None, :, None], wx[None, None, :]
    a = arr[:, y0[:, None], x0[None, :]].astype(f32)
    b = arr[:, y0[:, None], x1[None, :]].astype(f32)
    c = arr[:, y1[:, None], x0[None, :]].astype(f32)
    d = arr[:, y1[:, None], x1[None, :]].astype(f32)
    top = a * (f32(1) - wx) + b * wx
    bot = c * (f32(1) - wx) + d * wx
    out = (top * (f32(1) - wy) + bot * wy + f32(0.5)).astype(np.uint8)
    return out[0] if squeeze else out


__all__ = [
    "assemble_t2t1t2",
    "build",
    "j2k_t1_decode",
    "jpeg_decode_progressive",
    "jpegls_decode_diffs",
    "jpegls_unstuff_split",
    "load",
    "normalize_minmax_u8",
    "pdf_composite",
    "pdf_coverage",
    "pdf_g4_decode",
    "pdf_resample_affine",
    "pdf_resample_axes",
    "resize_bilinear_u8",
]
