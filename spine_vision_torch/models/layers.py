"""Small NHWC layers with the Flax modules' numerics and variable names.

Activations stay NHWC (channels innermost) through the models, as in the JAX
package. Each layer stores its weights in the layout its forward reads, in
``param_dtype`` (by default the dtype it computes in, as inference keeps them;
f32 master weights for training, as Flax's ``param_dtype=float32``), and casts
them to its compute ``dtype`` in ``forward`` (a no-op when the two agree).
``models/convert.py`` fills them from Flax trees.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal(shape, fan_in: int, generator: torch.Generator | None) -> torch.Tensor:
    return torch.randn(shape, generator=generator) / math.sqrt(fan_in)


def _param(t: torch.Tensor, dtype, device) -> nn.Parameter:
    return nn.Parameter(t.to(dtype=dtype, device=device))


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA "SAME" padding (low, high) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """NHWC convolution, weight ``[out, in/groups, kh, kw]`` in
    ``param_dtype``, computed in ``dtype``.

    ``padding`` is an int (symmetric) or ``"SAME"`` (Flax's default)."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
        padding: int | str = 0, groups: int = 1, bias: bool = True,
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
        param_dtype=None,
    ) -> None:
        super().__init__()
        self.stride, self.padding, self.groups, self.kernel = stride, padding, groups, kernel
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        fan_in = in_ch // groups * kernel * kernel
        self.weight = _param(
            _lecun_normal((out_ch, in_ch // groups, kernel, kernel), fan_in, generator),
            param_dtype, device,
        )
        self.bias = _param(torch.zeros(out_ch), param_dtype, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        pad = self.padding
        if pad == "SAME":
            ph = same_padding(x.shape[2], self.kernel, self.stride)
            pw = same_padding(x.shape[3], self.kernel, self.stride)
            if any(ph + pw):
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        y = F.conv2d(x, self.weight.to(self.dtype), bias, self.stride, pad, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """``x @ W.T + b`` with weight ``[out, in]``, product and bias add in
    ``dtype`` (as ``flax.linen.Dense(dtype=...)``)."""

    def __init__(
        self, in_dim: int, out_dim: int, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.weight = _param(
            _lecun_normal((out_dim, in_dim), in_dim, generator), param_dtype, device
        )
        self.bias = _param(torch.zeros(out_dim), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t()) + self.bias.to(
            self.dtype
        )


class LayerNorm(nn.Module):
    """Channel LayerNorm computed in f32 (Flax ``LayerNorm(dtype=float32)``),
    returning f32."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None) -> None:
        super().__init__()
        self.eps = eps
        self.scale = _param(torch.ones(dim), torch.float32, device)
        self.bias = _param(torch.zeros(dim), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, self.eps)
