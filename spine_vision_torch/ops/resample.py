"""Isotropic volume resampling (trilinear), on the volume's device.

Counterpart of ``spine_vision_tpu/ops/resample.py``: SimpleITK's resample
with an identity transform, the same origin and direction, a new spacing and
linear interpolation, which reduces to a per-axis index scale

    src_index[k] = out_index[k] * new_spacing[k] / old_spacing[k]

(corner-aligned, clamped to the volume), with an extent of
``round(size * old_spacing / new_spacing)`` per axis.

The JAX code gathers the 8 corner lattices at the output size and blends
them along x, then y, then z. Here the x lerp runs once over the input's
(z, y) rows, the y lerp once over its z planes, then the z lerp: every
output element takes the same f32 operations on the same operands, in the
same order, with two intermediates smaller than the output instead of eight
gathers of its size.
"""

from __future__ import annotations

import numpy as np
import torch

from spine_vision_torch.device import resolve_device


def _axis(n_in: int, n_out: int, scale: torch.Tensor) -> tuple:
    """Source indices and weight of one axis: (i0, i1, w) of ``n_out``."""
    pos = torch.arange(n_out, dtype=torch.float32, device=scale.device) * scale
    pos = torch.clamp(pos, 0.0, n_in - 1.0)
    i0 = torch.floor(pos).to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=n_in - 1), pos - i0


def trilinear_resample(
    volume: torch.Tensor,
    scale_zyx: torch.Tensor | tuple[float, float, float],
    out_shape: tuple[int, int, int],
) -> torch.Tensor:
    """Trilinear-resample ``[D, H, W]`` by per-axis index scales (the ratio
    new/old spacing in (z, y, x) order) to ``out_shape``; f32 on the
    volume's device."""
    volume = volume.to(torch.float32)
    scale = torch.as_tensor(scale_zyx, dtype=torch.float32, device=volume.device)
    d, h, w = volume.shape
    od, oh, ow = out_shape
    z0, z1, wz = _axis(d, od, scale[0])
    y0, y1, wy = _axis(h, oh, scale[1])
    x0, x1, wx = _axis(w, ow, scale[2])
    vx = volume[:, :, x0] * (1 - wx) + volume[:, :, x1] * wx  # [D, H, W']
    wy = wy[:, None]
    vxy = vx[:, y0] * (1 - wy) + vx[:, y1] * wy  # [D, H', W']
    wz = wz[:, None, None]
    return vxy[z0] * (1 - wz) + vxy[z1] * wz


def resample_to_isotropic(
    volume: np.ndarray | torch.Tensor,
    spacing_zyx: tuple[float, float, float],
    new_spacing_zyx: tuple[float, float, float] = (0.3, 0.3, 0.3),
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, tuple[float, float, float]]:
    """Resample a ``[D, H, W]`` volume to ``new_spacing_zyx`` (default 0.3 mm
    isotropic) on ``device``; returns (f32 tensor there, the new spacing)."""
    if not isinstance(volume, torch.Tensor):
        volume = torch.from_numpy(np.ascontiguousarray(volume))
    vol = volume.to(resolve_device(device))
    out_shape = tuple(
        int(round(sz * osp / nsp))
        for sz, osp, nsp in zip(vol.shape, spacing_zyx, new_spacing_zyx)
    )
    scale = [nsp / osp for osp, nsp in zip(spacing_zyx, new_spacing_zyx)]
    return trilinear_resample(vol, scale, out_shape), tuple(new_spacing_zyx)
