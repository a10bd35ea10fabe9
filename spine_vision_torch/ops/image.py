"""Image ops: normalisation, bilinear resize, letterboxing.

Counterparts of ``spine_vision_tpu/ops/image.py``, plain functions on
tensors that run on the device their input lies on:

- ``normalize_minmax``, ``normalize_to_uint8`` (min-max to [0, 1] and to
  uint8, a constant image keeping its raw values in the latter);
- ``bilinear_sample``, ``bilinear_resize`` (cv2's half-pixel-centre
  ``INTER_LINEAR`` with edge clamping) and ``resize_with_padding`` (the
  letterbox of the reference's crops);
- ``resize_dynamic``, batched over a leading axis: the study graph's resize
  of a padded buffer's valid extent, two f32 products with hat-function
  matrices as in the JAX package (callers on the card keep TF32 off, the
  PyTorch default for ``torch.matmul``, so the weights stay exact);
- ``imagenet_normalize`` and ``grayscale_to_rgb01``.
"""

from __future__ import annotations

import torch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_minmax(arr: torch.Tensor) -> torch.Tensor:
    """Min-max normalise to [0, 1] float32 (zeros if constant)."""
    arr = arr.float()
    rng = arr.max() - arr.min()
    return torch.where(rng > 0, (arr - arr.min()) / torch.clamp(rng, min=1e-12), arr * 0.0)


def normalize_to_uint8(arr: torch.Tensor) -> torch.Tensor:
    """Min-max normalise to [0, 255] uint8, truncating toward zero; a
    constant array keeps its raw values (a flat slice of 100.0 stays 100)."""
    arr = arr.float()
    amin = arr.min()
    rng = arr.max() - amin
    scaled = (arr - amin) / torch.clamp(rng, min=1e-12) * 255.0
    return torch.clamp(torch.where(rng > 0, scaled, arr), 0.0, 255.0).to(torch.uint8)


def _source_coords(out_size: int, in_size: int, device=None) -> torch.Tensor:
    """Half-pixel-centre source coordinates ``(dst + 0.5) * in / out - 0.5``."""
    scale = torch.tensor(in_size, dtype=torch.float32) / out_size
    idx = torch.arange(out_size, dtype=torch.float32, device=device)
    return (idx + 0.5) * scale.to(device) - 0.5


def bilinear_sample(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of a 2D ``image`` at the broadcastable float
    coordinates ``ys``, ``xs``, clamped to the border (cv2's
    ``BORDER_REPLICATE``); float32 of the coordinates' shape."""
    image = image.float()
    h, w = image.shape
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    top = image[y0i, x0i] * (1.0 - wx) + image[y0i, x1i] * wx
    bot = image[y1i, x0i] * (1.0 - wx) + image[y1i, x1i] * wx
    return top * (1.0 - wy) + bot * wy


def bilinear_resize(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of a 2D image (cv2 ``INTER_LINEAR``), float32."""
    ys = _source_coords(out_h, image.shape[0], image.device)
    xs = _source_coords(out_w, image.shape[1], image.device)
    return bilinear_sample(image, ys[:, None], xs[None, :])


def resize_with_padding(image: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Letterbox a 2D image onto a zero canvas of ``(target_h, target_w)``,
    aspect kept and centred, as uint8. A uint8 input keeps its values; any
    other dtype is min-max normalised to [0, 255] first (a constant image
    keeping its raw values)."""
    h, w = image.shape
    scale = min(target_h / h, target_w / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    y_off, x_off = (target_h - new_h) // 2, (target_w - new_w) // 2
    dev = image.device
    oy = torch.arange(target_h, dtype=torch.float32, device=dev)[:, None]
    ox = torch.arange(target_w, dtype=torch.float32, device=dev)[None, :]
    sy = (oy - y_off + 0.5) * (h / new_h) - 0.5
    sx = (ox - x_off + 0.5) * (w / new_w) - 0.5
    valid = (oy >= y_off) & (oy < y_off + new_h) & (ox >= x_off) & (ox < x_off + new_w)
    f = image.float()
    if image.dtype != torch.uint8:
        f = torch.where(f.max() - f.min() > 0, normalize_minmax(image) * 255.0, f)
    sampled = bilinear_sample(f, sy.expand(target_h, target_w), sx.expand(target_h, target_w))
    out = torch.where(valid, sampled, torch.zeros((), device=dev))
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def hat_matrix(src: torch.Tensor, size: int) -> torch.Tensor:
    """``[..., n, size]`` bilinear weights ``max(0, 1 - |src - j|)`` of each
    source coordinate in ``src [..., n]`` against positions ``j < size``."""
    pos = torch.arange(size, dtype=torch.float32, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., :, None] - pos), min=0.0)


def resize_dynamic(
    images: torch.Tensor, hw: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """Bilinear-resize the valid ``[0:h, 0:w]`` region of padded buffers.

    Args:
        images: ``[M, Hp, Wp]`` padded buffers.
        hw: ``[M, 2]`` true (h, w) extents.
        out_h, out_w: Output size.

    Returns:
        ``[M, out_h, out_w]`` float32. Source coordinates are half-pixel
        centred and clamped to the valid extent, never the padded buffer.
    """
    images = images.float()
    _, hp, wp = images.shape
    hf = hw[:, 0:1].float()
    wf = hw[:, 1:2].float()
    dev = images.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (hf / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (wf / out_w) - 0.5
    ys = torch.minimum(torch.clamp(ys, min=0.0), hf - 1.0)
    xs = torch.minimum(torch.clamp(xs, min=0.0), wf - 1.0)
    r_mat = hat_matrix(ys, hp)  # [M, out_h, Hp]
    c_mat = hat_matrix(xs, wp)  # [M, out_w, Wp]
    return r_mat @ images @ c_mat.transpose(1, 2)


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """Normalise ``[..., 3]`` images in [0, 1] with the ImageNet statistics."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(_IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def grayscale_to_rgb01(image_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[H, W]`` gray -> float32 ``[H, W, 3]`` in [0, 1]."""
    f = image_u8.float() / 255.0
    return torch.stack([f, f, f], dim=-1)
