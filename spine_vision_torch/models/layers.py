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

from spine_vision_torch.ops.batchnorm import BatchNorm

# The std of a unit normal truncated to [-2, 2] (Flax's variance_scaling).
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, generator: torch.Generator | None) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    t = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * (1.0 / (math.sqrt(fan_in) * _TRUNCATED_STD))


def _param(t: torch.Tensor, dtype, device) -> nn.Parameter:
    return nn.Parameter(t.to(dtype=dtype, device=device))


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and held in f32: a Flax model's explicit cast to
    bf16 as XLA runs it, the arithmetic after it in f32."""
    return x.to(torch.bfloat16).float()


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA "SAME" padding (low, high) for one spatial axis at that
    axis's stride."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """NHWC convolution, weight ``[out, in/groups, kh, kw]`` in
    ``param_dtype``, computed in ``dtype``.

    ``stride`` is an int or a per-axis ``(sh, sw)`` pair; ``padding`` an int
    (symmetric) or ``"SAME"`` (Flax's default), each axis at its stride."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel: int, stride: int | tuple[int, int] = 1,
        padding: int | str = 0, groups: int = 1, bias: bool = True,
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
        param_dtype=None,
    ) -> None:
        super().__init__()
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        self.padding, self.groups, self.kernel = padding, groups, kernel
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
            ph = same_padding(x.shape[2], self.kernel, self.stride[0])
            pw = same_padding(x.shape[3], self.kernel, self.stride[1])
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


class FlaxBatchNorm(BatchNorm):
    """Flax ``nn.BatchNorm(use_running_average=True, dtype=float32)``: the
    running statistics applied in Flax's order, ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` in f32, returning f32. Unlike the folded
    ``x * A + B`` of ``ops/batchnorm.py`` (the JAX ``TpuBatchNorm``'s form),
    this rounds as Flax does, which a thresholded output (the text
    detector's) needs. Inference only, in either module mode: Flax's
    training BatchNorm (``norm_impl="flax"``) is ROADMAP Queue 1 item 12."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.float() - self.mean) * (torch.rsqrt(self.var + self.eps) * self.scale) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """Flax 0.12's ``nn.MultiHeadDotProductAttention(num_heads,
    dtype=bfloat16)`` self-attention in inference, as XLA runs it, with its
    variables in Flax's layout: ``query``, ``key``, ``value`` kernels ``[C,
    heads, d]`` with biases ``[heads, d]``, the ``out`` kernel ``[heads, d,
    C]`` with bias ``[C]``, stored in bf16 (Flax casts them to bf16).

    Plain ops in ``dot_product_attention_weights``'s order: the projections,
    the query divided by ``sqrt(d)``, the logits, the softmax ``exp(l - max)
    / sum`` (``force_fp32_for_softmax=False``), the weighted values and the
    output projection. Each is computed in f32 and rounded to bf16 where XLA
    rounds it: every product and sum, except the exponentials that the
    softmax's sum upcasts (summed unrounded) and the output's bias add, which
    is returned in f32 for the caller to add to its f32 stream (or to round).
    ``F.scaled_dot_product_attention`` computes its softmax otherwise, so it
    is not used."""

    def __init__(
        self, dim: int, num_heads: int, device=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        d = dim // num_heads
        bf16 = torch.bfloat16
        for name in ("query", "key", "value"):
            setattr(self, f"{name}_kernel", _param(
                _lecun_normal((dim, num_heads, d), dim, generator), bf16, device))
            setattr(self, f"{name}_bias", _param(torch.zeros(num_heads, d), bf16, device))
        self.out_kernel = _param(_lecun_normal((num_heads, d, dim), dim, generator), bf16, device)
        self.out_bias = _param(torch.zeros(dim), bf16, device)

    def _project(self, x: torch.Tensor, name: str) -> torch.Tensor:
        kernel = getattr(self, f"{name}_kernel").float()
        y = bf16_round(torch.einsum("btc,chd->bthd", x, kernel))
        return bf16_round(y + getattr(self, f"{name}_bias").float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = bf16_round(x)
        q, k, v = (self._project(x, name) for name in ("query", "key", "value"))
        scale = bf16_round(torch.tensor(math.sqrt(q.shape[-1]), device=q.device))
        q = bf16_round(q / scale)
        logits = bf16_round(torch.einsum("bqhd,bkhd->bhqk", q, k))
        e = torch.exp(bf16_round(logits - logits.amax(-1, keepdim=True)))
        weights = bf16_round(bf16_round(e) / bf16_round(e.sum(-1, keepdim=True)))
        y = bf16_round(torch.einsum("bhqk,bkhd->bqhd", weights, v))
        out = bf16_round(torch.einsum("bqhd,hdc->bqc", y, self.out_kernel.float()))
        return out + self.out_bias.float()
