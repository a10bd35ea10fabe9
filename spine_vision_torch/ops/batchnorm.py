"""BatchNorm over the trailing (channel) axis of NHWC activations.

Counterpart of ``spine_vision_tpu/ops/batchnorm.py`` (``TpuBatchNorm``):

- inference: the running statistics and the affine parameters fold into
  per-channel f32 scalars ``A``, ``B``, and the activation takes one pass
  ``x * A + B`` computed in f32 and stored in its own dtype;
- training: the batch statistics are f32 sums of x and x² over the
  activation (``var = max(s2/n - mean², 0)``, the biased variance), the
  forward is the same scale-shift pass, and the backward is the JAX custom
  VJP's three-term form ``dx = A*g + P*x + Q`` in x's dtype, with
  ``dscale``, ``dbias`` from Σg and Σg·x; nothing flows back through the
  statistics, whose gradient the three terms already carry;
- the running statistics move as ``momentum * old + (1 - momentum) * batch``
  with the biased batch variance (``momentum = 0.9``, as Flax).

``torch.nn.BatchNorm2d`` differs in both of the last: it updates the running
variance with the unbiased estimate and weights the new statistic by its
``momentum``; so it is not used, nor ``torch.nn.SyncBatchNorm``.

With a ``process_group`` (the trainer sets one on every BatchNorm when it
runs more than one process) the training statistics are those of the global
batch, as under the JAX package's data-parallel ``jit``: the forward
all-reduces Σx, Σx² and the count before the variance, the backward Σg and
Σg·x before the three-term ``dx``, as the JAX custom VJP psums them over its
``axis_name``. ``dscale`` and ``dbias`` stay this rank's shares, which the
data-parallel gradient average sums. The sums cross the group in f64. Without
a group (evaluation, one process) nothing changes and no collective runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
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


def _reduce_dims(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(x.ndim - 1))


def _group_sums(group, *sums: torch.Tensor) -> list[torch.Tensor]:
    """Per-channel f32 sums (and scalar counts) summed over ``group`` in
    f64, returned in f32."""
    packed = torch.cat([s.double().reshape(-1) for s in sums])
    dist.all_reduce(packed, group=group)
    return [part.float().reshape(s.shape)
            for part, s in zip(packed.split([s.numel() for s in sums]), sums)]


@torch.no_grad()
def batch_moments(x: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor, object]:
    """Per-channel (mean, biased var) from f32 sums of x and x², and the
    count they are over: this tensor's rows, or the group's with ``group``."""
    dims = _reduce_dims(x)
    xf = x.float()
    n = x.numel() // x.shape[-1]
    s1, s2 = xf.sum(dims), xf.square().sum(dims)
    if group is not None:
        s1, s2, n = _group_sums(group, s1, s2, s1.new_full((1,), n))
    mean = s1 / n
    var = torch.clamp(s2 / n - mean.square(), min=0.0)
    return mean, var, n


class _BatchNormTrain(torch.autograd.Function):
    """Scale-shift by given batch statistics over ``n`` rows, with the
    three-term backward (its sums over ``group`` when one is given)."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, eps, n, group):
        ctx.save_for_backward(x, scale, mean, torch.rsqrt(var + eps))
        ctx.n, ctx.group = n, group
        return batch_norm_inference(x, scale, bias, mean, var, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, inv = ctx.saved_tensors
        dims = _reduce_dims(x)
        n = ctx.n
        gf, xf = g.float(), x.float()
        sg = gf.sum(dims)
        sgx = (gf * xf).sum(dims)
        dscale = inv * (sgx - mean * sg)  # = sum(g * xhat)
        sg_all, dscale_all = sg, dscale
        if ctx.group is not None:
            sg_all, sgx_all = _group_sums(ctx.group, sg, sgx)
            dscale_all = inv * (sgx_all - mean * sg_all)
        a = scale * inv
        # dx = a * (g - sg/n - xhat * dscale/n), as A*g + P*x + Q.
        p = -(a * inv) * dscale_all / n
        q = (a * inv * mean * dscale_all - a * sg_all) / n
        dx = (gf * a + xf * p + q).to(x.dtype)
        return dx, dscale, sg, None, None, None, None, None


def batch_norm_train(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BatchNorm: ``(y, batch mean, batch var)``, the
    statistics the global batch's with ``group``; the caller owns the
    running update."""
    mean, var, n = batch_moments(x, group)
    return _BatchNormTrain.apply(x, scale, bias, mean, var, eps, n, group), mean, var


MOMENTUM = 0.9  # weight of the old running statistic (the JAX ResNet's)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing axis, in training or inference form by
    ``self.training``. Parameters ``scale``/``bias`` and buffers
    ``mean``/``var`` are f32, named as the Flax variables; ``scale_init`` is
    the scale's initial value (0 for a residual block's last norm, as the
    JAX package's ``scale_init=zeros_init()``)."""

    def __init__(
        self, features: int, eps: float = 1e-5, scale_init: float = 1.0, device=None,
    ) -> None:
        super().__init__()
        self.eps = eps
        f32 = {"dtype": torch.float32, "device": device}
        self.scale = nn.Parameter(torch.full((features,), scale_init, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm_inference(x, self.scale, self.bias, self.mean, self.var, self.eps)
        y, mean, var = batch_norm_train(x, self.scale, self.bias, self.eps, self.process_group)
        with torch.no_grad():
            self.mean.copy_(MOMENTUM * self.mean + (1.0 - MOMENTUM) * mean)
            self.var.copy_(MOMENTUM * self.var + (1.0 - MOMENTUM) * var)
        return y
