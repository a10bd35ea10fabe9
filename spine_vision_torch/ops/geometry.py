"""Crop geometry on tensors: mm -> pixel deltas and spine-tangent angles.

Batched counterparts of ``spine_vision_tpu/ops/geometry.py``
(``mm_to_pixels_jax``, ``rotation_angles_jax``).
"""

from __future__ import annotations

import torch


def mm_to_pixels(delta_mm: torch.Tensor, spacing_rc: torch.Tensor) -> torch.Tensor:
    """Crop deltas (left, right, top, bottom) in pixels.

    Args:
        delta_mm: ``[4]`` deltas in mm.
        spacing_rc: ``[M, 2]`` (row, col) spacing in mm/pixel.

    Returns:
        ``[M, 4]`` float deltas, rounded half to even: horizontal deltas
        divide by the column spacing, vertical ones by the row spacing.
    """
    sp = spacing_rc.float()
    divisor = torch.stack([sp[:, 1], sp[:, 1], sp[:, 0], sp[:, 0]], dim=-1)
    return torch.round(delta_mm.float().to(sp.device) / divisor)


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)), torch.zeros_like(a))


def rotation_angles(
    centers_xy: torch.Tensor, image_hw: torch.Tensor, last_disc_angle_boost: float = 1.0
) -> torch.Tensor:
    """Rotation angles (degrees) from the spine tangent at each disc.

    Args:
        centers_xy: ``[M, L, 2]`` normalised (x, y), ordered top to bottom.
        image_hw: ``[M, 2]`` (H, W) used to denormalise.
        last_disc_angle_boost: Multiplier of the last disc's angle.

    Returns:
        ``[M, L]`` angles: forward difference at the first disc, central
        differences inside, the derivative of the quadratic through the last
        three discs at the last one; negated, the last scaled by the boost.
    """
    c = centers_xy.float()
    hw = image_hw.float()
    x = c[..., 0] * hw[:, 1:2]
    y = c[..., 1] * hw[:, 0:1]
    num = x.shape[-1]
    first = _safe_div(x[:, 1] - x[:, 0], y[:, 1] - y[:, 0])[:, None]
    if num > 2:
        interior = _safe_div(x[:, 2:] - x[:, :-2], y[:, 2:] - y[:, :-2])
        y0, y1, y2 = y[:, -3], y[:, -2], y[:, -1]
        x0, x1, x2 = x[:, -3], x[:, -2], x[:, -1]
        f01 = _safe_div(x1 - x0, y1 - y0)
        f12 = _safe_div(x2 - x1, y2 - y1)
        a = _safe_div(f12 - f01, y2 - y0)
        last = (f01 + a * (2.0 * y2 - y0 - y1))[:, None]
        dxdy = torch.cat([first, interior, last], dim=1)
    else:
        last = _safe_div(x[:, -1] - x[:, -2], y[:, -1] - y[:, -2])[:, None]
        dxdy = torch.cat([first, last], dim=1)[:, :num]
    angles = -torch.rad2deg(torch.arctan(dxdy))
    boost = torch.ones(num, dtype=torch.float32, device=angles.device)
    boost[-1] = float(last_disc_angle_boost)
    return angles * boost
