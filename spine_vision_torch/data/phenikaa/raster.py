"""The raster operations of the OCR renderer, in numpy on the host.

Counterparts of the Pillow operations that ``spine_vision_tpu``'s
``data/phenikaa/synth.py`` applies to 8-bit gray images, with Pillow's own
arithmetic so that a rendered line or page comes out as Pillow makes it:

- :func:`transform`: ``Image.transform`` with ``AFFINE`` or ``PERSPECTIVE``
  coefficients (the output pixel centre mapped to the source), ``BILINEAR``
  sampling in double precision, and a fill colour where the source point
  falls outside the image (Pillow's ``Geometry.c``);
- :func:`resize_bilinear`: ``Image.resize(..., BILINEAR)``, Pillow's
  separable triangle filter, whose support widens by the scale when it
  shrinks, in 22-bit fixed point (``Resample.c``; kept in
  ``data/pillow_resize.py`` beside its bicubic filter);
- :func:`min_filter3` and :func:`max_filter3`: ``ImageFilter.MinFilter(3)``
  and ``MaxFilter(3)``, edges replicated;
- :func:`gaussian_blur`: ``ImageFilter.GaussianBlur``, an extended box blur
  of three passes per axis in 24-bit fixed point (``BoxBlur.c``);
- :func:`jpeg_roundtrip`: the lossy half of saving a gray image as a
  baseline JPEG at quality ``q`` and reading it back with libjpeg(-turbo):
  edge replication to whole 8x8 blocks, the integer ("islow") forward DCT,
  quantization with the IJG luminance table scaled for ``q`` (libjpeg-turbo's
  reciprocal division), dequantization and the islow inverse DCT (shared
  with the baseline decoder, ``io/jpeg.py``). Huffman coding is lossless and
  is left out.

Every function takes and returns ``uint8`` ``[H, W]`` arrays.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from spine_vision_torch.data.pillow_resize import resize_bilinear  # noqa: F401
from spine_vision_torch.io.jpeg import (  # the islow DCT's constants, shared with the decoder
    _CONST_BITS,
    _FIX_0_298631336,
    _FIX_0_390180644,
    _FIX_0_541196100,
    _FIX_0_765366865,
    _FIX_0_899976223,
    _FIX_1_175875602,
    _FIX_1_501321110,
    _FIX_1_847759065,
    _FIX_1_961570560,
    _FIX_2_053119869,
    _FIX_2_562915447,
    _FIX_3_072711026,
    _PASS1_BITS,
    _descale,
    idct_islow,
)

# ---------------------------------------------------------------------------
# Geometric transforms (Geometry.c: ImagingGenericTransform, bilinear_filter8)
# ---------------------------------------------------------------------------


def transform(
    img: np.ndarray,
    size: tuple[int, int],
    coeffs,
    fill: int,
    perspective: bool = False,
) -> np.ndarray:
    """``Image.transform(size, AFFINE or PERSPECTIVE, coeffs, BILINEAR,
    fillcolor=fill)`` of a uint8 image; ``size`` is ``(width, height)``."""
    src = np.asarray(img, np.uint8)
    h_in, w_in = src.shape
    w_out, h_out = size
    xin = np.arange(w_out, dtype=np.float64)[None, :] + 0.5
    yin = np.arange(h_out, dtype=np.float64)[:, None] + 0.5
    a = [float(c) for c in coeffs]
    xs = a[0] * xin + a[1] * yin + a[2]
    ys = a[3] * xin + a[4] * yin + a[5]
    if perspective:
        den = a[6] * xin + a[7] * yin + 1
        xs, ys = xs / den, ys / den
    xs, ys = np.broadcast_to(xs, (h_out, w_out)), np.broadcast_to(ys, (h_out, w_out))
    inside = (xs >= 0.0) & (xs < w_in) & (ys >= 0.0) & (ys < h_in)
    xf, yf = xs - 0.5, ys - 0.5
    x0, y0 = np.floor(xf), np.floor(yf)
    dx, dy = xf - x0, yf - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = np.clip(x0, 0, w_in - 1), np.clip(x0 + 1, 0, w_in - 1)
    ya, yb = np.clip(y0, 0, h_in - 1), np.clip(y0 + 1, 0, h_in - 1)
    s = src.astype(np.float64)
    top = s[ya, xa] + (s[ya, xb] - s[ya, xa]) * dx
    bot = s[yb, xa] + (s[yb, xb] - s[yb, xa]) * dx
    # Pillow blends the second row only where it lies inside the image.
    v = np.where((y0 + 1 >= 0) & (y0 + 1 < h_in), top + (bot - top) * dy, top)
    out = np.full((h_out, w_out), fill, np.uint8)
    out[inside] = v[inside].astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# Rank and blur filters (Filter.c ImagingExpand + RankFilter, BoxBlur.c)
# ---------------------------------------------------------------------------


def _windows3(img: np.ndarray) -> np.ndarray:
    p = np.pad(np.asarray(img, np.uint8), 1, mode="edge")
    h, w = img.shape
    return np.stack([p[i : i + h, j : j + w] for i in range(3) for j in range(3)])


def min_filter3(img: np.ndarray) -> np.ndarray:
    """``ImageFilter.MinFilter(3)``: the 3x3 minimum, edges replicated."""
    return _windows3(img).min(0)


def max_filter3(img: np.ndarray) -> np.ndarray:
    """``ImageFilter.MaxFilter(3)``: the 3x3 maximum, edges replicated."""
    return _windows3(img).max(0)


def _box_blur_radius(radius: float, passes: int) -> np.float32:
    """BoxBlur.c's ``_gaussian_blur_radius``, in its float/double mix."""
    f32 = np.float32
    sigma2 = f32(f32(radius) * f32(radius) / f32(passes))
    big_l = f32(np.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f32(np.floor((float(big_l) - 1.0) / 2.0))
    a = f32(f32(2) * small_l + f32(1)) * f32(small_l * f32(small_l + f32(1)) - f32(3) * sigma2)
    a = f32(a / f32(f32(6) * f32(sigma2 - f32(small_l + f32(1)) * f32(small_l + f32(1)))))
    return f32(small_l + a)


def _box_blur_rows(img: np.ndarray, float_radius: np.float32) -> np.ndarray:
    radius = int(float_radius)
    ww = int(np.float32(1 << 24) / np.float32(float_radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (radius * 2 + 1) * ww) // 2
    w = img.shape[1]
    src = img.astype(np.int64)
    idx = np.arange(w)
    acc = sum(src[:, np.clip(idx + k, 0, w - 1)] for k in range(-radius, radius + 1))
    far = src[:, np.clip(idx - radius - 1, 0, w - 1)] + src[:, np.clip(idx + radius + 1, 0, w - 1)]
    return ((acc * ww + far * fw + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """``ImageFilter.GaussianBlur(radius)``: ``passes`` extended box blurs
    along the rows, then as many along the columns."""
    out = np.asarray(img, np.uint8)
    r = _box_blur_radius(radius, passes)
    if float(r) == 0.0:
        return out.copy()
    for _ in range(passes):
        out = _box_blur_rows(out, r)
    out = out.T
    for _ in range(passes):
        out = _box_blur_rows(out, r)
    return np.ascontiguousarray(out.T)


# ---------------------------------------------------------------------------
# JPEG round trip (jcparam.c, jfdctint.c, jcdctmgr.c, jidctint.c)
# ---------------------------------------------------------------------------

# The IJG luminance quantization table (JPEG Annex K), in natural order.
_STD_LUMINANCE = np.array(
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    dtype=np.int64,
).reshape(8, 8)

@lru_cache(maxsize=128)
def jpeg_quant_table(quality: int) -> np.ndarray:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``'s luminance table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((_STD_LUMINANCE * scale + 50) // 100, 1, 255)


def _fdct_1d(d: list, final: bool) -> list:
    """One pass of jpeg_fdct_islow over the 8 entries ``d[0..7]``."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = _CONST_BITS + _PASS1_BITS if final else _CONST_BITS - _PASS1_BITS
    out = [None] * 8
    if final:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * _FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * _FIX_0_765366865, shift)
    out[6] = _descale(z1 - tmp12 * _FIX_1_847759065, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _FIX_1_175875602
    tmp4, tmp5 = tmp4 * _FIX_0_298631336, tmp5 * _FIX_2_053119869
    tmp6, tmp7 = tmp6 * _FIX_3_072711026, tmp7 * _FIX_1_501321110
    z1, z2 = z1 * -_FIX_0_899976223, z2 * -_FIX_2_562915447
    z3, z4 = z3 * -_FIX_1_961570560 + z5, z4 * -_FIX_0_390180644 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return out


@lru_cache(maxsize=128)
def _reciprocals(quality: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libjpeg-turbo's ``compute_reciprocal`` (jcdctmgr.c, 16-bit DCTELEM)
    for each divisor (the table scaled by 8, as the islow DCT's output is):
    (reciprocal, correction, shift)."""
    divisor = (jpeg_quant_table(quality) << 3).astype(np.int64)
    r = 16 + np.floor(np.log2(divisor)).astype(np.int64)
    fq = (np.int64(1) << r) // divisor
    fr = (np.int64(1) << r) % divisor
    c = divisor // 2
    pow2 = fr == 0
    below_half = ~pow2 & (fr <= divisor // 2)
    fq = np.where(pow2, fq >> 1, np.where(below_half, fq, fq + 1))
    r = np.where(pow2, r - 1, r)
    c = np.where(below_half, c + 1, c)
    return fq, c, r - 16


def _quantize(coef: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg-turbo's ``quantize``: ``(|coef| + c) * fq >> (shift + 16)``,
    the sign restored."""
    fq, c, shift = _reciprocals(quality)
    mag = ((np.abs(coef) + c) * fq) >> (shift + 16)
    return np.where(coef < 0, -mag, mag)


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """A gray image saved as a baseline JPEG at ``quality`` and decoded."""
    src = np.asarray(img, np.uint8)
    h, w = src.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    padded = np.pad(src, ((0, hp - h), (0, wp - w)), mode="edge").astype(np.int64) - 128
    # [rows of blocks, cols of blocks, 8, 8]
    blocks = padded.reshape(hp // 8, 8, wp // 8, 8).transpose(0, 2, 1, 3)
    rows = _fdct_1d([blocks[..., i] for i in range(8)], final=False)
    data = np.stack(rows, -1)
    cols = _fdct_1d([data[..., i, :] for i in range(8)], final=True)
    coef = np.stack(cols, -2)
    deq = _quantize(coef, quality) * jpeg_quant_table(quality)
    out = idct_islow(deq).transpose(0, 2, 1, 3).reshape(hp, wp)
    return np.ascontiguousarray(out[:h, :w])
