"""Small NHWC layers with the Flax modules' numerics and variable names.

Activations stay NHWC (channels innermost) through the models, as in the JAX
package. Each layer stores its weights in the layout its forward reads and in
the dtype it computes in; ``models/convert.py`` fills them from Flax trees.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal(shape, fan_in: int, generator: torch.Generator | None) -> torch.Tensor:
    return torch.randn(shape, generator=generator) / math.sqrt(fan_in)


def _param(t: torch.Tensor, dtype, device) -> nn.Parameter:
    return nn.Parameter(t.to(dtype=dtype, device=device), requires_grad=False)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA "SAME" padding (low, high) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """NHWC convolution, weight ``[out, in/groups, kh, kw]`` in ``dtype``.

    ``padding`` is an int (symmetric) or ``"SAME"`` (Flax's default)."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
        padding: int | str = 0, groups: int = 1, bias: bool = True,
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.stride, self.padding, self.groups, self.kernel = stride, padding, groups, kernel
        fan_in = in_ch // groups * kernel * kernel
        self.weight = _param(
            _lecun_normal((out_ch, in_ch // groups, kernel, kernel), fan_in, generator),
            dtype, device,
        )
        self.bias = _param(torch.zeros(out_ch), dtype, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        pad = self.padding
        if pad == "SAME":
            ph = same_padding(x.shape[2], self.kernel, self.stride)
            pw = same_padding(x.shape[3], self.kernel, self.stride)
            if any(ph + pw):
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        y = F.conv2d(x, self.weight, self.bias, self.stride, pad, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """``x @ W.T + b`` with weight ``[out, in]``, product and bias add in
    ``dtype`` (as ``flax.linen.Dense(dtype=...)``)."""

    def __init__(
        self, in_dim: int, out_dim: int, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.weight = _param(_lecun_normal((out_dim, in_dim), in_dim, generator), dtype, device)
        self.bias = _param(torch.zeros(out_dim), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.weight.dtype), self.weight.t()) + self.bias


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
