"""Trainable ConvNeXt v1 block, hybrid strategy (NHWC, C <= 512).

Counterpart of ``spine_vision_tpu/ops/block_train.py::convnext_block_hybrid``:
``x + gamma * mlp(LayerNorm(dwconv7x7(x) + bias))`` as a
``torch.autograd.Function``.

- Forward: the whole-block kernel in its ``emit_conv`` form
  (``ops/convnext_block.py``), which also returns ``t = dwconv7x7(x) + bias``
  rounded to x's dtype; ``x``, ``t`` and the parameters are saved.
- Backward: the LN+MLP backward from ``t`` (``ops/fused_mlp.py::ln_mlp_bwd``,
  a hand-written kernel on the card), then the depthwise conv's data and
  weight gradients from ``dt`` (grouped-convolution gradients, which the JAX
  package leaves to XLA outside any kernel), ``dbias = sum dt`` in f32 and
  ``dx = dx_conv + g`` in f32, cast to x's dtype.

Gradients come back in each argument's dtype; the f32 master weights behind a
bf16 argument receive theirs through the cast's backward, as in Flax. On CPU
tensors both kernels' plain versions run, so the CPU path computes the same
function with the same rounding points.
"""

from __future__ import annotations

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

from spine_vision_torch.ops.convnext_block import convnext_block
from spine_vision_torch.ops.dwconv import KERNEL_SIZE, PAD
from spine_vision_torch.ops.fused_mlp import MAX_FUSED_DIM, ln_mlp_bwd


def depthwise_conv_grads(
    x: torch.Tensor, k49: torch.Tensor, dt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Data and ``[49, C]`` filter gradients of the SAME 7x7 depthwise conv
    of NHWC ``x`` for the output gradient ``dt``, in x's dtype."""
    c = x.shape[-1]
    weight = k49.t().reshape(c, 1, KERNEL_SIZE, KERNEL_SIZE)
    x_nchw = x.permute(0, 3, 1, 2)
    dt_nchw = dt.permute(0, 3, 1, 2)
    dx = conv2d_input(x_nchw.shape, weight, dt_nchw, padding=PAD, groups=c)
    dk = conv2d_weight(x_nchw, weight.shape, dt_nchw, padding=PAD, groups=c)
    return dx.permute(0, 2, 3, 1), dk.reshape(c, KERNEL_SIZE * KERNEL_SIZE).t()


class _HybridBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, eps):
        out, t = convnext_block(
            x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma,
            eps=eps, emit_conv=True,
        )
        ctx.save_for_backward(x, t, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma)
        return out

    @staticmethod
    def backward(ctx, g):
        x, t, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma = ctx.saved_tensors
        g = g.contiguous()
        dt, dls, dlb, dw1t, db1, dw2t, db2, dgamma = ln_mlp_bwd(
            t, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g
        )
        dt = dt.to(x.dtype)
        dx_conv, dk = depthwise_conv_grads(x, k49, dt)
        dbias = dt.float().sum(dim=(0, 1, 2))
        dx = (dx_conv.float() + g.float()).to(x.dtype)
        return (
            dx.contiguous(),
            dk.to(k49.dtype),
            dbias.to(dw_bias.dtype),
            dls.to(ln_scale.dtype),
            dlb.to(ln_bias.dtype),
            dw1t.to(w1t.dtype),
            db1.to(b1.dtype),
            dw2t.to(w2t.dtype),
            db2.to(b2.dtype),
            dgamma.to(gamma.dtype),
            None,
        )


def convnext_block_hybrid(
    x: torch.Tensor,
    k49: torch.Tensor,
    dw_bias: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Trainable fused ConvNeXt block on NHWC ``x``.

    Arguments in the layouts of :func:`ops.convnext_block.convnext_block`
    (``k49 [49, C]``, ``w1t [4C, C]``, ``w2t [C, 4C]``). Without grad it
    computes the forward of the ``emit_conv`` form, whose LayerNorm reads the
    rounded ``t``, as the JAX eval step under ``"hybrid"`` does.
    """
    if x.shape[-1] > MAX_FUSED_DIM:
        raise ValueError(
            f"C={x.shape[-1]} exceeds MAX_FUSED_DIM={MAX_FUSED_DIM}; such blocks "
            "train on plain ops"
        )
    return _HybridBlock.apply(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, eps)
