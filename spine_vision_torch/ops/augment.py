"""Coordinate-aware data augmentation on the device.

Counterpart of ``spine_vision_tpu/ops/augment.py``. One sampled affine
transform (horizontal flip, rotation about the image centre, translation as a
fraction of the size, isotropic scale) warps the images by inverse bilinear
sampling and maps the normalised coordinates forward, so the labels stay
consistent; then brightness and contrast jitter. Images are ``[B, H, W, C]``
floats in [0, 1], coordinates ``[B, L, 2]`` normalised (x, y).

The parameters are drawn by :func:`affine_params` from a ``torch.Generator``
(other numbers than ``jax.random``'s from the same seed); :func:`augment_with`
applies given parameters, so a test can hand both packages the same draws.
With a ``DrawShard`` (``ops/draws.py``) the draws are the global batch's and a
rank keeps its rows, as the JAX package draws inside its data-parallel step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from spine_vision_torch.ops.draws import DrawShard, rand


class AugmentConfig(NamedTuple):
    """Augmentation hyperparameters (torchvision-parity defaults)."""

    hflip_prob: float = 0.5
    degrees: float = 10.0
    translate: float = 0.05
    scale_min: float = 0.95
    scale_max: float = 1.05
    brightness: float = 0.2
    contrast: float = 0.2
    flip_coords: bool = True  # transform coords under flip (localization)


class AffineParams(NamedTuple):
    """Per-image draws, each ``[B]``: angle (radians), translation, scale,
    flip (bool), brightness and contrast factors."""

    theta: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    scale: torch.Tensor
    flip: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor


def affine_params(
    generator: torch.Generator, batch: int, cfg: AugmentConfig, device,
    shard: DrawShard | None = None,
) -> AffineParams:
    """Draw one transform per image, uniform in the configured ranges; with
    ``shard``, this rank's ``batch`` rows of the global batch's draws."""

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = rand((batch,), generator, device, shard)
        return lo + (hi - lo) * u

    theta = uniform(-cfg.degrees, cfg.degrees) * (math.pi / 180.0)
    tx = uniform(-cfg.translate, cfg.translate)
    ty = uniform(-cfg.translate, cfg.translate)
    scale = uniform(cfg.scale_min, cfg.scale_max)
    flip = rand((batch,), generator, device, shard) < cfg.hflip_prob
    brightness = uniform(1.0 - cfg.brightness, 1.0 + cfg.brightness)
    contrast = uniform(1.0 - cfg.contrast, 1.0 + cfg.contrast)
    return AffineParams(theta, tx, ty, scale, flip, brightness, contrast)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def warp_images(images: torch.Tensor, p: AffineParams) -> torch.Tensor:
    """Inverse-warp ``[B, H, W, C]`` images under flip + rotate + scale +
    translate, bilinear, edge-clamped."""
    b, h, w, c = images.shape
    dev = images.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yc = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[None, :, None]
    xc = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, None, :]
    xs_t = xc - _col(p.tx) * w
    ys_t = yc - _col(p.ty) * h
    cos_t, sin_t = _col(torch.cos(p.theta)), _col(torch.sin(p.theta))
    inv_scale = 1.0 / _col(p.scale)
    xs = (cos_t * xs_t + sin_t * ys_t) * inv_scale + cx
    ys = (-sin_t * xs_t + cos_t * ys_t) * inv_scale + cy
    xs = torch.where(_col(p.flip), (w - 1.0) - xs, xs)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    ys = torch.clamp(ys, 0.0, h - 1.0)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[..., None], (xs - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    flat = images.reshape(b, h * w, c)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x1i) * wx
    bot = gather(y1i, x0i) * (1 - wx) + gather(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def transform_coords(
    coords: torch.Tensor, p: AffineParams, h: int, w: int, flip_coords: bool = True
) -> torch.Tensor:
    """Forward-map ``[B, L, 2]`` normalised coordinates under the same
    transform; the rotation runs in pixel-proportional space, as the warp."""
    flip = p.flip if flip_coords else torch.zeros_like(p.flip)
    x = torch.where(flip[:, None], 1.0 - coords[..., 0], coords[..., 0])
    xp = (x - 0.5) * w
    yp = (coords[..., 1] - 0.5) * h
    cos_t, sin_t = torch.cos(p.theta)[:, None], torch.sin(p.theta)[:, None]
    s = p.scale[:, None]
    xr = (cos_t * xp - sin_t * yp) * s
    yr = (sin_t * xp + cos_t * yp) * s
    return torch.stack([xr / w + 0.5 + p.tx[:, None], yr / h + 0.5 + p.ty[:, None]], dim=-1)


def augment_with(
    images: torch.Tensor,
    coords: torch.Tensor | None,
    p: AffineParams,
    cfg: AugmentConfig = AugmentConfig(),
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Warp, then colour-jitter (brightness, then contrast about the image
    mean), clipped to [0, 1]; coordinates mapped consistently."""
    if cfg.hflip_prob <= 0.0:
        p = p._replace(flip=torch.zeros_like(p.flip))
    warped = warp_images(images, p)
    bright = warped * p.brightness[:, None, None, None]
    mean = bright.mean(dim=(1, 2, 3), keepdim=True)
    out = torch.clamp((bright - mean) * p.contrast[:, None, None, None] + mean, 0.0, 1.0)
    if coords is None:
        return out, None
    h, w = images.shape[1], images.shape[2]
    return out, transform_coords(coords, p, h, w, cfg.flip_coords)


def augment_batch(
    generator: torch.Generator,
    images: torch.Tensor,
    coords: torch.Tensor | None = None,
    cfg: AugmentConfig = AugmentConfig(),
    shard: DrawShard | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Draw a transform per image from ``generator`` (this rank's rows of the
    global batch's draws with ``shard``) and apply it."""
    p = affine_params(generator, images.shape[0], cfg, images.device, shard)
    return augment_with(images, coords, p, cfg)
