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
from spine_vision_torch.ops.draws import rand

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
    ``dtype`` (as ``flax.linen.Dense(dtype=...)``); ``bias=False`` drops
    the bias (``use_bias=False``)."""

    def __init__(
        self, in_dim: int, out_dim: int, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None, bias: bool = True,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.weight = _param(
            _lecun_normal((out_dim, in_dim), in_dim, generator), param_dtype, device
        )
        self.bias = _param(torch.zeros(out_dim), param_dtype, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y if self.bias is None else y + self.bias.to(self.dtype)


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
    """Flax ``nn.BatchNorm(momentum, epsilon, dtype)``; by default flax
    0.12's defaults (momentum 0.99, epsilon 1e-5) with ``dtype=float32``, as
    the OCR nets use it. The ResNet's ``norm_impl="flax"`` takes momentum 0.9
    and the model's dtype, the heads' ``ConvHead`` the head's dtype.

    With the running statistics (``train=False``): ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32, Flax's order, cast to
    ``dtype``. Unlike the folded ``x * A + B`` of ``ops/batchnorm.py`` (the
    JAX ``TpuBatchNorm``'s form), this rounds as Flax does, which a
    thresholded output (the text detector's) needs.

    Training (``train=True``): the batch statistics over every axis but the
    last, in f32, with Flax's fast variance ``max(0, E[x²] - E[x]²)``;
    autograd differentiates through them, as JAX does. With
    ``round_grads`` the input is taken as a bf16 convolution's output read
    in f32: Flax casts it to f32 twice (for the statistics and for the
    normalisation), so each branch's cotangent is rounded to bf16 and their
    sum rounded again (:func:`bf16_grad`, read from the optimized HLO of the
    JAX train step). With a ``process_group`` (set by the trainer on every
    BatchNorm) the statistics are the group's: the sums of x and x² and the
    count are all-reduced in f64 (``ops/batchnorm.py``'s rule), through a
    differentiable all-reduce whose backward sums the cotangents over the
    group. The running statistics move as ``momentum * old + (1 - momentum)
    * batch``.

    ``train=None`` follows ``self.training``. The module starts in eval
    mode, so that a bare call uses the running statistics."""

    MOMENTUM = 0.99  # Flax's default (the ResNet's TpuBatchNorm uses 0.9)

    def __init__(
        self, features: int, eps: float = 1e-5, scale_init: float = 1.0, device=None, *,
        momentum: float = MOMENTUM, dtype=torch.float32, round_grads: bool = True,
    ) -> None:
        super().__init__(features, eps=eps, scale_init=scale_init, device=device)
        self.momentum, self.dtype, self.round_grads = momentum, dtype, round_grads
        self.eval()

    def _moments(self, xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dims = tuple(range(xs.ndim - 1))
        if self.process_group is None:
            mean = xs.mean(dims)
            return mean, torch.clamp(xs.square().mean(dims) - mean.square(), min=0.0)
        from torch.distributed.nn.functional import all_reduce

        c = xs.shape[-1]
        n = xs.new_full((1,), xs.numel() // c)
        packed = torch.cat([xs.sum(dims), xs.square().sum(dims), n]).double()
        packed = all_reduce(packed, group=self.process_group).float()
        s1, s2, count = packed[:c], packed[c: 2 * c], packed[2 * c]
        mean = s1 / count
        return mean, torch.clamp(s2 / count - mean.square(), min=0.0)

    def forward(self, x: torch.Tensor, train: bool | None = None) -> torch.Tensor:
        if not (self.training if train is None else train):
            y = (x.float() - self.mean) * (torch.rsqrt(self.var + self.eps) * self.scale) \
                + self.bias
            return y.to(self.dtype)
        rnd = bf16_grad if self.round_grads else (lambda t: t)
        x = rnd(x.float())
        xs, xn = rnd(x), rnd(x)
        mean, var = self._moments(xs)
        m = self.momentum
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        y = (xn - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class MultiHeadDotProductAttention(nn.Module):
    """Flax 0.12's ``nn.MultiHeadDotProductAttention(num_heads, dtype)``
    self-attention, as XLA runs it, with its variables in Flax's layout:
    ``query``, ``key``, ``value`` kernels ``[C, heads, d]`` with biases
    ``[heads, d]``, the ``out`` kernel ``[heads, d, C]`` with bias ``[C]``,
    stored in ``param_dtype`` (bf16 by default: Flax casts them to bf16).

    Plain ops in ``dot_product_attention_weights``'s order: the projections,
    the query divided by ``sqrt(d)``, the logits, the softmax ``exp(l - max)
    / sum`` (``force_fp32_for_softmax=False``), the weighted values and the
    output projection. Each is computed in f32; at ``dtype=bfloat16`` (the
    default) it is rounded to bf16 where XLA rounds it: every product and
    sum, except the exponentials that the softmax's sum upcasts (summed
    unrounded) and the output's bias add, which is returned in f32 for the
    caller to add to its f32 stream (or to round). At ``dtype=float32``
    nothing rounds. ``F.scaled_dot_product_attention`` computes its softmax
    otherwise, so it is not used. ``param_dtype=torch.float32`` keeps f32
    master variables for training (Flax's default), rounded to bf16 where
    they are used.

    ``dropout_rate`` drops attention weights in training mode (Flax's
    ``dropout_rate`` with ``deterministic=False``): each is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, its mask
    drawn from the generator passed to ``forward`` (``ops/draws.py``, this
    rank's rows of the global batch's mask with ``shard``)."""

    def __init__(
        self, dim: int, num_heads: int, device=None,
        generator: torch.Generator | None = None, param_dtype=torch.bfloat16,
        dtype=torch.bfloat16, dropout_rate: float = 0.0,
    ) -> None:
        super().__init__()
        d = dim // num_heads
        self.dtype, self.dropout_rate = dtype, dropout_rate
        for name in ("query", "key", "value"):
            setattr(self, f"{name}_kernel", _param(
                _lecun_normal((dim, num_heads, d), dim, generator), param_dtype, device))
            setattr(self, f"{name}_bias", _param(torch.zeros(num_heads, d), param_dtype, device))
        self.out_kernel = _param(
            _lecun_normal((num_heads, d, dim), dim, generator), param_dtype, device)
        self.out_bias = _param(torch.zeros(dim), param_dtype, device)

    def _round(self):
        """The rounding to apply at XLA's rounding points (looked up at call
        time, so that an f32-arithmetic check can swap ``bf16_round``)."""
        return bf16_round if self.dtype == torch.bfloat16 else _identity

    def _project(self, x: torch.Tensor, name: str) -> torch.Tensor:
        r = self._round()
        kernel = r(getattr(self, f"{name}_kernel").float())
        y = r(torch.einsum("btc,chd->bthd", x, kernel))
        return r(y + r(getattr(self, f"{name}_bias").float()))

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None, shard=None,
    ) -> torch.Tensor:
        r = self._round()
        x = r(x.float())
        q, k, v = (self._project(x, name) for name in ("query", "key", "value"))
        scale = r(torch.tensor(math.sqrt(q.shape[-1]), device=q.device))
        q = r(q / scale)
        logits = r(torch.einsum("bqhd,bkhd->bhqk", q, k))
        e = torch.exp(r(logits - logits.amax(-1, keepdim=True)))
        weights = r(r(e) / r(e.sum(-1, keepdim=True)))
        if self.training and self.dropout_rate > 0.0:
            keep = rand(weights.shape, generator, weights.device, shard) >= self.dropout_rate
            weights = torch.where(keep, r(weights / (1.0 - self.dropout_rate)), 0.0)
        y = r(torch.einsum("bhqk,bkhd->bqhd", weights, v))
        out = r(torch.einsum("bqhd,hdc->bqc", y, r(self.out_kernel.float())))
        return out + r(self.out_bias.float())
