"""Perspective rectification of text polygons.

Counterpart of ``spine_vision_tpu/ops/warp.py``: the homography that maps
the output rectangle onto each quadrilateral is solved as an 8x8 linear
system (one batched ``torch.linalg.solve`` over the quads), and the output
grid is bilinearly sampled through it with ``ops/image.py::bilinear_sample``.
Everything runs on the device the image lies on.
"""

from __future__ import annotations

import torch

from spine_vision_torch.ops.image import bilinear_sample


def perspective_matrix(src_quads: torch.Tensor, dst_quads: torch.Tensor) -> torch.Tensor:
    """Homographies ``H`` with ``H @ [dst, 1] ~ [src, 1]``, one a quad.

    Args:
        src_quads: ``[N, 4, 2]`` (or ``[4, 2]``) source (x, y) corners.
        dst_quads: the destination corners, broadcastable to ``src_quads``.

    Returns:
        ``[N, 3, 3]`` (or ``[3, 3]``) float32, destination -> source.
    """
    src = src_quads.float()
    dst = torch.broadcast_to(dst_quads.to(src), src.shape)
    dx, dy = dst[..., 0], dst[..., 1]
    sx, sy = src[..., 0], src[..., 1]
    one, zero = torch.ones_like(dx), torch.zeros_like(dx)
    r1 = torch.stack([dx, dy, one, zero, zero, zero, -dx * sx, -dy * sx], dim=-1)
    r2 = torch.stack([zero, zero, zero, dx, dy, one, -dx * sy, -dy * sy], dim=-1)
    a = torch.stack([r1, r2], dim=-2).reshape(*src.shape[:-2], 8, 8)
    b = torch.stack([sx, sy], dim=-1).reshape(*src.shape[:-2], 8)
    h8 = torch.linalg.solve(a, b)
    return torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1).reshape(*src.shape[:-2], 3, 3)


def rectify_polygons(
    image: torch.Tensor,
    quads: torch.Tensor,
    out_h: int,
    out_w: int,
    bounds: torch.Tensor | None = None,
    offsets: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rectify a batch of quadrilaterals from one image.

    Args:
        image: ``[H, W]`` source image.
        quads: ``[N, 4, 2]`` corners TL, TR, BR, BL as (x, y), in the local
            coordinates of each quad's region when ``offsets`` is given.
        out_h, out_w: The rectified patch size.
        bounds: Optional ``[N, 2]`` per-quad ``(y_hi, x_hi)`` clamp of the
            local sample coordinates (the lows are 0): when pages are stacked
            into one tall image, a box that hangs past its page's edge
            repeats that page's border, not the next page's rows.
        offsets: Optional ``[N, 2]`` per-quad ``(dy, dx)`` added to the
            sample coordinates after the solve and the clamp: the solve stays
            in local coordinates, where an f32 8x8 system is well conditioned,
            and the page placement is an exact shift.

    Returns:
        ``[N, out_h, out_w]`` float32 patches.
    """
    dev = image.device
    quads = quads.to(device=dev, dtype=torch.float32)
    dst = torch.tensor(
        [[0.0, 0.0], [out_w - 1.0, 0.0], [out_w - 1.0, out_h - 1.0], [0.0, out_h - 1.0]],
        dtype=torch.float32, device=dev,
    )
    h = perspective_matrix(quads, dst)[:, :, :, None, None]  # [N, 3, 3, 1, 1]
    gy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    mapped = [h[:, r, 0] * gx + h[:, r, 1] * gy + h[:, r, 2] for r in range(3)]
    sx, sy = mapped[0] / mapped[2], mapped[1] / mapped[2]  # [N, out_h, out_w]
    if bounds is not None:
        bounds = bounds.to(device=dev, dtype=torch.float32)[:, :, None, None]
        sy = torch.minimum(torch.clamp(sy, min=0.0), bounds[:, 0])
        sx = torch.minimum(torch.clamp(sx, min=0.0), bounds[:, 1])
    if offsets is not None:
        offsets = offsets.to(device=dev, dtype=torch.float32)[:, :, None, None]
        sy = sy + offsets[:, 0]
        sx = sx + offsets[:, 1]
    return bilinear_sample(image, sy, sx)
