"""Pillow's ``Image.resize`` of 8-bit images, in numpy on the host.

Pillow's resampling (``Resample.c``) is separable: a horizontal pass, then a
vertical one, each rounded to uint8. Each output sample weighs the source
samples under a filter centred at ``(x + 0.5) * scale``, whose support
widens by the scale when the image shrinks; the weights are normalised over
the taps inside the image and held in 22-bit fixed point. Two filters:

- ``"bilinear"``: the triangle, support 1 (``Image.BILINEAR``);
- ``"bicubic"``: Keys' cubic with ``a = -0.5``, support 2
  (``Image.BICUBIC``, the default filter of ``Image.resize`` for RGB and
  gray images).

Images are ``uint8`` ``[H, W]`` or ``[H, W, C]``; each channel is resampled
alike.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


@lru_cache(maxsize=4096)
def _resample_coeffs(in_size: int, out_size: int,
                     method: str = "bilinear") -> tuple[np.ndarray, np.ndarray]:
    """Pillow's filter taps for one axis: the first source index of each
    output and its ``[out, ksize]`` fixed-point weights (zero past the tap
    count)."""
    kernel, base_support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    ss = 1.0 / filterscale
    w = kernel((taps[None] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    # Pillow sums the taps in order; a running sum adds them one by one too.
    ww = np.cumsum(w, axis=1)[:, -1:]
    kk = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    scaled = kk * (1 << _PRECISION_BITS)
    fixed = np.where(kk < 0, (-0.5 + scaled).astype(np.int64), (0.5 + scaled).astype(np.int64))
    return xmin, fixed


def _resample_rows(src: np.ndarray, out_w: int, method: str) -> np.ndarray:
    """Resample axis 1 of ``[H, W, ...]``."""
    in_w = src.shape[1]
    xmins, kk = _resample_coeffs(in_w, out_w, method)
    idx = np.minimum(xmins[:, None] + np.arange(kk.shape[1])[None, :], in_w - 1)
    weights = kk.reshape(kk.shape + (1,) * (src.ndim - 2))
    acc = (src.astype(np.int64)[:, idx] * weights[None]).sum(2) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int], method: str = "bicubic") -> np.ndarray:
    """``Image.resize((width, height), method)`` of a uint8 image."""
    out = np.asarray(img, np.uint8)
    w, h = size
    if out.shape[1] != w:
        out = _resample_rows(out, w, method)
    if out.shape[0] != h:
        out = _resample_rows(out.swapaxes(0, 1), h, method).swapaxes(0, 1)
    return np.ascontiguousarray(out)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``Image.resize((width, height), BILINEAR)`` of a uint8 image."""
    return resize(img, size, "bilinear")
