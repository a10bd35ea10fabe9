"""Inference BatchNorm as one scale-shift pass (NHWC, trailing channel axis).

Counterpart of ``spine_vision_tpu/ops/batchnorm.py`` at inference
(``batch_norm_inference`` and ``TpuBatchNorm(use_running_average=True)``): the
running statistics and the affine parameters fold into per-channel f32
scalars ``A``, ``B``, and the activation takes one pass ``x * A + B`` computed
in f32 and stored in its own dtype. Training statistics wait for the training
slice.
"""

from __future__ import annotations

import torch
from torch import nn


def fold_scale_shift(
    mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold (mean, var, scale, bias) into per-channel ``y = x*A + B``."""
    a = scale * torch.rsqrt(var + eps)
    return a, bias - mean * a


def batch_norm_inference(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
) -> torch.Tensor:
    """One fused scale-shift pass from running statistics."""
    a, b = fold_scale_shift(mean, var, scale, bias, eps)
    return (x.float() * a + b).to(x.dtype)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the trailing axis. Parameters ``scale``/``bias``
    and buffers ``mean``/``var`` are f32, named as the Flax variables."""

    def __init__(self, features: int, eps: float = 1e-5, device=None) -> None:
        super().__init__()
        self.eps = eps
        f32 = {"dtype": torch.float32, "device": device}
        self.scale = nn.Parameter(torch.ones(features, **f32), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, **f32), requires_grad=False)
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_inference(x, self.scale, self.bias, self.mean, self.var, self.eps)
