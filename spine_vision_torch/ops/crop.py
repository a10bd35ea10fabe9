"""Fused IVD crop: rotate + crop + normalise + letterbox, batched on tensors.

Counterpart of ``spine_vision_tpu/ops/crop.py::crop_ivd_regions_impl`` in both
modes, over a batch of slices and all levels at once. The arithmetic is the
JAX package's, step for step:

1. Rotated mode pre-rotates each slice about its disc centre with the
   3-shear decomposition ``Sx(-tan(t/2)) . Sy(sin t) . Sx(-tan(t/2))``. Each
   shear is a 1-D resample with a per-row shift; rows go in blocks of 64 that
   share an integer base shift, and hat-weighted taps of the block's window
   add the rest. The JAX package reads each block's window with a dynamic
   slice, which clamps its start into bounds, and sums a static band of
   taps (gathers are slow on a TPU); here the two taps with a nonzero weight
   are gathered, from a window start clamped the same way explicitly.
2. The crop's min/max is a masked reduce over the work image inside the
   axis-aligned crop rectangle.
3. The letterboxed output grid is sampled with separable hat-matrix products.

Outputs clip to [0, 255] and then truncate to uint8.
"""

from __future__ import annotations

import math

import torch

from spine_vision_torch.ops.image import hat_matrix

_SHEAR_BLOCK = 64
_BIG = 3.4e38


def _replicate_extend(image: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fill each buffer beyond its (h, w) extent with its edge values.

    image ``[N, Hp, Wp]``; h, w ``[N]`` integer extents."""
    n, hp, wp = image.shape
    dev = image.device
    ri = torch.clamp(h - 1, 0, hp - 1).long()
    edge_row = image[torch.arange(n, device=dev), ri][:, None, :]
    rows = torch.arange(hp, device=dev)[None, :, None]
    image = torch.where(rows < h[:, None, None], image, edge_row)
    ci = torch.clamp(w - 1, 0, wp - 1).long()
    edge_col = image[torch.arange(n, device=dev), :, ci][:, :, None]
    cols = torch.arange(wp, device=dev)[None, None, :]
    return torch.where(cols < w[:, None, None], image, edge_col)


def _shear_cols(
    img: torch.Tensor, slope: torch.Tensor, line_center: torch.Tensor,
    max_slope: float, max_shift: float,
) -> torch.Tensor:
    """Horizontal shear ``out[n, y, x] = img[n, y, x + slope[n]*(y - c[n])]``
    with bilinear taps and edge replication, shifts clamped to ``max_shift``.

    The JAX package sums a static band of ``2*t_band + 1`` hat-weighted taps
    of each block's window; at most two of them have a nonzero weight (the
    hat's support is two samples wide), so this reads just those two with a
    gather and gets the same sum.
    """
    n, hp, wp = img.shape
    g = _SHEAR_BLOCK
    nb = -(-hp // g)
    hpad = nb * g
    t_band = int(math.ceil(max_slope * g / 2.0)) + 2
    pmax = int(math.ceil(max_shift)) + t_band + 2
    dev = img.device
    img_p = torch.nn.functional.pad(
        img[:, None], (pmax, pmax, 0, hpad - hp), mode="replicate"
    )[:, 0]  # [N, hpad, wp + 2*pmax]
    slope = slope[:, None]
    centre = line_center[:, None]
    ys = torch.arange(hpad, dtype=torch.float32, device=dev)[None]
    shift = torch.clamp(slope * (ys - centre), -max_shift, max_shift)  # [N, hpad]
    y0 = torch.arange(nb, dtype=torch.float32, device=dev)[None] * g
    base = torch.floor(torch.clamp(slope * (y0 + g / 2.0 - centre), -max_shift, max_shift))
    # Each block's window starts at its base shift, clamped into the padded
    # row as a dynamic slice would be.
    width = img_p.shape[-1]
    start = torch.clamp((pmax - t_band) + base.long(), 0, width - (wp + 2 * t_band))
    start = start.repeat_interleave(g, dim=1)  # [N, hpad]
    rel = shift - base.repeat_interleave(g, dim=1) + t_band  # tap position in the window
    t0 = torch.floor(rel)
    cols = torch.arange(wp, device=dev)
    out = torch.zeros((n, hpad, wp), dtype=torch.float32, device=dev)
    for step in (0.0, 1.0):
        tap = t0 + step
        wgt = torch.clamp(1.0 - torch.abs(rel - tap), min=0.0)
        wgt = torch.where((tap >= 0) & (tap <= 2 * t_band), wgt, torch.zeros_like(wgt))
        first = start + torch.clamp(tap, 0, 2 * t_band).long()
        vals = torch.gather(img_p, 2, first[:, :, None] + cols)
        out = out + vals * wgt[:, :, None]
    return out[:, :hp]


def _rotate_about_replicate(
    image: torch.Tensor, h: torch.Tensor, w: torch.Tensor, cx: torch.Tensor,
    cy: torch.Tensor, angle_deg: torch.Tensor, max_angle_deg: float, reach_px: float,
) -> torch.Tensor:
    """cv2-style rotation about (cx, cy) with edge replication, as three shears,
    correct within ``reach_px`` of the centre."""
    angle = torch.clamp(angle_deg, -max_angle_deg, max_angle_deg)
    theta = torch.deg2rad(angle)
    alpha = -torch.tan(theta / 2.0)
    beta = torch.sin(theta)
    max_alpha = math.tan(math.radians(max_angle_deg) / 2.0)
    max_beta = math.sin(math.radians(max_angle_deg))
    r = float(reach_px)
    s3_max = max_alpha * r
    r2x = r + s3_max
    s2_max = max_beta * r2x
    r1y = r + s2_max
    s1_max = max_alpha * r1y
    work = _replicate_extend(image, h, w)
    work = _shear_cols(work, alpha, cy, max_alpha, s1_max)
    work = _shear_cols(work.transpose(1, 2), beta, cx, max_beta, s2_max).transpose(1, 2)
    return _shear_cols(work, alpha, cy, max_alpha, s3_max)


def crop_ivd_regions(
    images: torch.Tensor,
    centers_xy: torch.Tensor,
    angles_deg: torch.Tensor,
    crop_delta_px: torch.Tensor,
    image_hw: torch.Tensor,
    crop_h: int = 256,
    crop_w: int = 256,
    separable: bool = False,
    max_angle_deg: float = 40.0,
    max_crop_px: int = 384,
) -> torch.Tensor:
    """Crop every level of every slice in one batched pass.

    Args:
        images: ``[M, Hp, Wp]`` padded slices.
        centers_xy: ``[M, L, 2]`` normalised (x, y) disc centres.
        angles_deg: ``[M, L]`` rotation angles (0 in horizontal mode).
        crop_delta_px: ``[M, 4]`` (left, right, top, bottom) in pixels.
        image_hw: ``[M, 2]`` true (h, w) extents.
        crop_h, crop_w: Output crop size.
        separable: Horizontal mode: skip the (identity) pre-rotation.
        max_angle_deg, max_crop_px: Static bounds of the rotation (angles and
            deltas are clamped to them in rotated mode).

    Returns:
        ``[M, L, crop_h, crop_w]`` uint8 letterboxed crops.
    """
    m, hp, wp = images.shape
    num_levels = centers_xy.shape[1]
    dev = images.device
    image = images.float()
    h = image_hw[:, 0].long()
    w = image_hw[:, 1].long()
    hf = image_hw[:, 0].float()[:, None]  # [M, 1]
    wf = image_hw[:, 1].float()[:, None]
    centers = centers_xy.float()
    cx = torch.floor(centers[..., 0] * wf)  # [M, L]
    cy = torch.floor(centers[..., 1] * hf)

    delta = crop_delta_px.float()[:, None, :]  # [M, 1, 4]
    if not separable:
        delta = torch.clamp(delta, max=float(max_crop_px))
    left, right, top, bottom = delta.unbind(-1)
    x1 = torch.clamp(cx - left, min=0.0)
    x2 = torch.minimum(wf.expand_as(cx), cx + right)
    y1 = torch.clamp(cy - top, min=0.0)
    y2 = torch.minimum(hf.expand_as(cy), cy + bottom)
    ch = torch.clamp(y2 - y1, min=1.0)
    cw = torch.clamp(x2 - x1, min=1.0)

    if separable:
        work = image[:, None].expand(m, num_levels, hp, wp)
    else:
        rep = lambda t: t.repeat_interleave(num_levels)  # noqa: E731
        work = _rotate_about_replicate(
            image.repeat_interleave(num_levels, dim=0), rep(h), rep(w),
            cx.reshape(-1), cy.reshape(-1), angles_deg.float().reshape(-1),
            max_angle_deg, float(max_crop_px),
        ).reshape(m, num_levels, hp, wp)

    # Pass A: min/max over the crop rectangle (rows and columns separable).
    gy = torch.arange(hp, dtype=torch.float32, device=dev)
    gx = torch.arange(wp, dtype=torch.float32, device=dev)
    row_in = (gy >= y1[..., None]) & (gy <= y2[..., None] - 1.0) & (gy < hf[..., None])
    col_in = (gx >= x1[..., None]) & (gx <= x2[..., None] - 1.0) & (gx < wf[..., None])
    inside = row_in[..., :, None] & col_in[..., None, :]  # [M, L, Hp, Wp]
    crop_min = torch.where(inside, work, _BIG).amin(dim=(2, 3))
    crop_max = torch.where(inside, work, -_BIG).amax(dim=(2, 3))
    rng = crop_max - crop_min
    inv_range = torch.where(rng > 0, 1.0 / torch.clamp(rng, min=1e-12), torch.zeros_like(rng))

    # Pass B: letterbox sampling of the output grid.
    scale = torch.minimum(crop_h / ch, crop_w / cw)
    new_h = torch.round(ch * scale)
    new_w = torch.round(cw * scale)
    y_off = torch.floor((crop_h - new_h) / 2.0)
    x_off = torch.floor((crop_w - new_w) / 2.0)
    oy = torch.arange(crop_h, dtype=torch.float32, device=dev)
    ox = torch.arange(crop_w, dtype=torch.float32, device=dev)
    e = lambda t: t[..., None]  # noqa: E731
    row_ok = (oy >= e(y_off)) & (oy < e(y_off + new_h))  # [M, L, crop_h]
    col_ok = (ox >= e(x_off)) & (ox < e(x_off + new_w))
    ycr = (oy - e(y_off) + 0.5) * e(ch / torch.clamp(new_h, min=1.0)) - 0.5
    xcr = (ox - e(x_off) + 0.5) * e(cw / torch.clamp(new_w, min=1.0)) - 0.5
    ycr = torch.minimum(torch.clamp(ycr, min=0.0), e(ch - 1.0))
    xcr = torch.minimum(torch.clamp(xcr, min=0.0), e(cw - 1.0))
    ys_o = torch.minimum(torch.clamp(e(y1) + ycr, min=0.0), e(hf - 1.0))
    xs_o = torch.minimum(torch.clamp(e(x1) + xcr, min=0.0), e(wf - 1.0))
    r_mat = hat_matrix(ys_o, hp)  # [M, L, crop_h, Hp]
    c_mat = hat_matrix(xs_o, wp)  # [M, L, crop_w, Wp]
    vals = (r_mat @ work) @ c_mat.transpose(-1, -2)

    norm = (vals - crop_min[..., None, None]) * inv_range[..., None, None] * 255.0
    valid = row_ok[..., :, None] & col_ok[..., None, :]
    out = torch.where(valid, norm, torch.zeros_like(norm))
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)
