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
    bf16 as XLA runs it, the arithmetic after it in f32. Its backward rounds
    the cotangent to bf16 too, as the cast's transpose does where XLA keeps
    it (the recognizer's dense and attention products)."""
    return x.to(torch.bfloat16).float()


class _RoundForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (held in f32), its cotangent passed back
    unrounded: a convolution's bf16 input or kernel as XLA runs the train
    step, whose backward convolutions keep their f32 sums (read from the
    optimized HLO of the JAX OCR train steps)."""
    return _RoundForward.apply(x)


def bf16_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged, its cotangent rounded to bf16: the transpose of a
    bf16 -> f32 cast whose forward XLA elides (a bf16 convolution's output
    read in f32)."""
    return _RoundBackward.apply(x)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA "SAME" padding (low, high) for one spatial axis at that
    axis's stride."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """NHWC convolution, weight ``[out, in/groups, kh, kw]`` in
    ``param_dtype``, computed in ``dtype``; with ``bf16_kernel`` the weight
    is rounded to bf16 first (:func:`bf16_input`, Flax's cast of an f32
    kernel to a bf16 convolution's dtype).

    ``stride`` is an int or a per-axis ``(sh, sw)`` pair; ``padding`` an int
    (symmetric) or ``"SAME"`` (Flax's default), each axis at its stride."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel: int, stride: int | tuple[int, int] = 1,
        padding: int | str = 0, groups: int = 1, bias: bool = True,
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
        param_dtype=None, bf16_kernel: bool = False,
    ) -> None:
        super().__init__()
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        self.padding, self.groups, self.kernel = padding, groups, kernel
        self.dtype, self.bf16_kernel = dtype, bf16_kernel
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
        weight = bf16_input(self.weight) if self.bf16_kernel else self.weight
        y = F.conv2d(x, weight.to(self.dtype), bias, self.stride, pad, groups=self.groups)
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
    """Flax ``nn.BatchNorm(dtype=float32)`` (flax 0.12 defaults, momentum
    0.99, epsilon 1e-5), returning f32.

    With the running statistics (``train=False``, the default): ``(x -
    mean) * (rsqrt(var + eps) * scale) + bias`` in f32, Flax's order. Unlike
    the folded ``x * A + B`` of ``ops/batchnorm.py`` (the JAX
    ``TpuBatchNorm``'s form), this rounds as Flax does, which a thresholded
    output (the text detector's) needs.

    Training (``train=True``): the batch statistics over every axis but the
    last, in f32, with Flax's fast variance ``max(0, E[x²] - E[x]²)``;
    autograd differentiates through them, as JAX does. The input is a bf16
    convolution's output read in f32: Flax casts it to f32 twice (for the
    statistics and for the normalisation), so each branch's cotangent is
    rounded to bf16 and their sum rounded again (:func:`bf16_grad`, read
    from the optimized HLO of the JAX train step). The running statistics
    move as ``momentum * old + (1 - momentum) * batch``."""

    MOMENTUM = 0.99  # Flax's default (the ResNet's TpuBatchNorm uses 0.9)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return (x.float() - self.mean) * (torch.rsqrt(self.var + self.eps) * self.scale) \
                + self.bias
        x = bf16_grad(x.float())
        xs, xn = bf16_grad(x), bf16_grad(x)
        dims = tuple(range(x.ndim - 1))
        mean = xs.mean(dims)
        var = torch.clamp(xs.square().mean(dims) - mean.square(), min=0.0)
        with torch.no_grad():
            self.mean.copy_(self.MOMENTUM * self.mean + (1 - self.MOMENTUM) * mean)
            self.var.copy_(self.MOMENTUM * self.var + (1 - self.MOMENTUM) * var)
        return (xn - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


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
    is not used. ``param_dtype=torch.float32`` keeps f32 master variables
    for training (Flax's default), rounded to bf16 where they are used."""

    def __init__(
        self, dim: int, num_heads: int, device=None,
        generator: torch.Generator | None = None, param_dtype=torch.bfloat16,
    ) -> None:
        super().__init__()
        d = dim // num_heads
        for name in ("query", "key", "value"):
            setattr(self, f"{name}_kernel", _param(
                _lecun_normal((dim, num_heads, d), dim, generator), param_dtype, device))
            setattr(self, f"{name}_bias", _param(torch.zeros(num_heads, d), param_dtype, device))
        self.out_kernel = _param(
            _lecun_normal((num_heads, d, dim), dim, generator), param_dtype, device)
        self.out_bias = _param(torch.zeros(dim), param_dtype, device)

    def _project(self, x: torch.Tensor, name: str) -> torch.Tensor:
        kernel = bf16_round(getattr(self, f"{name}_kernel"))
        y = bf16_round(torch.einsum("btc,chd->bthd", x, kernel))
        return bf16_round(y + bf16_round(getattr(self, f"{name}_bias")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = bf16_round(x)
        q, k, v = (self._project(x, name) for name in ("query", "key", "value"))
        scale = bf16_round(torch.tensor(math.sqrt(q.shape[-1]), device=q.device))
        q = bf16_round(q / scale)
        logits = bf16_round(torch.einsum("bqhd,bkhd->bhqk", q, k))
        e = torch.exp(bf16_round(logits - logits.amax(-1, keepdim=True)))
        weights = bf16_round(bf16_round(e) / bf16_round(e.sum(-1, keepdim=True)))
        y = bf16_round(torch.einsum("bhqk,bkhd->bqhd", weights, v))
        out = bf16_round(torch.einsum("bqhd,hdc->bqc", y, bf16_round(self.out_kernel)))
        return out + bf16_round(self.out_bias)
