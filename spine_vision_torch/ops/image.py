"""Image ops of the study graph: dynamic-extent bilinear resize and ImageNet
normalisation. Counterparts of ``spine_vision_tpu/ops/image.py``
(``resize_dynamic``, ``imagenet_normalize``), batched over a leading axis.

The resize is two f32 products with hat-function matrices, as in the JAX
package; callers on the card keep TF32 off (the PyTorch default for
``torch.matmul``) so the weights stay exact.
"""

from __future__ import annotations

import torch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


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
