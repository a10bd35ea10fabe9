"""Trainable ConvNeXt v1 blocks for the two training strategies that run the
whole-block kernel forward (NHWC, C <= 512).

``x + gamma * mlp(LayerNorm(dwconv7x7(x) + bias))`` as a
``torch.autograd.Function``, in two forms, counterparts of
``spine_vision_tpu/ops/block_train.py``:

- :func:`convnext_block_hybrid` (``use_pallas="hybrid"``). Forward: the
  whole-block kernel in its ``emit_conv`` form (``ops/convnext_block.py``),
  which also returns ``t = dwconv7x7(x) + bias`` rounded to x's dtype; ``x``,
  ``t`` and the parameters are saved. Backward: the LN+MLP backward from
  ``t`` (``ops/fused_mlp.py::ln_mlp_bwd``, a hand-written kernel on the card),
  then the depthwise conv's data and weight gradients from ``dt``
  (grouped-convolution gradients, which the JAX package leaves to XLA outside
  any kernel), ``dbias = sum dt`` in f32 and ``dx = dx_conv + g`` in f32, cast
  to x's dtype.
- :func:`convnext_block_train` (``use_pallas="block"``). Forward: the
  whole-block kernel's inference form; only the primal inputs are saved.
  Backward: :func:`block_train_bwd`, one hand-written CUDA backward
  (``csrc/block_train_bwd.cu``, replacing ``_block_train_bwd_pallas``) that
  recomputes the conv and the LayerNorm and gives ``g_u`` (the conv output's
  gradient) and every parameter gradient, in three stages with plain versions
  beside them: the conv recompute ``u`` (:func:`conv_bias_reference`; the
  stencil #3 with an f32-and-bias epilogue, on
  ``ops/dwconv.py::stencil_geometry``'s tiles), the LN+MLP backward
  (``fused_mlp.ln_mlp_bwd_core``) and the tap sums (:func:`tap_sums_reference`,
  launch geometry :func:`tap_geometry`); then ``dx = g + dwconv7x7(g_u,
  flipped filter)`` in f32, cast to x's dtype, with the port's stencil kernel
  (``ops/dwconv.py::depthwise_conv7x7``) where the JAX package runs an XLA
  grouped conv.

Both take bf16 or f32 (x, the filter and the weights of one type), as the
JAX kernels run in either; the f32 forms run the MLP products on the 3xTF32
path of ``csrc/wg_gemm.cuh``.

Gradients come back in each argument's dtype; the f32 master weights behind a
bf16 argument receive theirs through the cast's backward, as in Flax. On CPU
tensors the kernels' plain versions run, so the CPU path computes the same
function with the same rounding points.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

from spine_vision_torch.ops import cuda_build
from spine_vision_torch.ops import fused_mlp as fm
from spine_vision_torch.ops.convnext_block import convnext_block
from spine_vision_torch.ops.dwconv import (
    _DTYPES,
    _ITEM,
    KERNEL_SIZE,
    PAD,
    TAPS,
    depthwise_conv7x7,
    depthwise_conv7x7_reference,
)
from spine_vision_torch.ops.fused_mlp import MAX_FUSED_DIM, ln_mlp_bwd

# #10's tap sums (csrc/block_train_bwd.cu, tap_sums; dws::Taps): 64-channel
# slabs, x rows in a ring of 9 (x's type) and g_u rows in a ring of 3 (f32),
# in strips of 16 or 32 columns, at three CTAs a multiprocessor (bf16).
_SLAB = 64
_TAP_RING, _TAP_GSLOTS = KERNEL_SIZE + 2, 3
TAP_CTAS_AN_SM = 3
_TAP_MIN_RUN_ROWS = 16  # the tap sums' runs at least (or the image): a run reads 6 halo rows
_TAP_CTAS = 1024  # CTAs a call aims at, runs shortening toward it down to that minimum


def tap_geometry(b: int, h: int, w: int, c: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch geometry of #10's tap sums (``csrc/block_train_bwd.cu``'s
    ``tap_sums``) for a [b, h, w, c] input in ``dtype``: the strip width (16
    columns at W <= 16, else 32), strips, slabs, rows a run (at least
    ``_TAP_MIN_RUN_ROWS`` or the image, fewer runs where more would start
    over ``_TAP_CTAS`` CTAs), runs an image, CTAs (blockIdx ``part * slabs +
    slab``, part ``(image * runs + run) * strips + strip``), shared memory a
    CTA (the x ring in ``dtype``) and ``parts``, the workspace rows colsum
    adds. Raises on what the kernel does not take."""
    if c not in fm.KERNEL_WIDTHS:
        raise ValueError(f"block_train_bwd kernel is built for C in {fm.KERNEL_WIDTHS}, got {c}")
    if not 0 < b * h * w < 2 ** 31:
        raise ValueError(f"block_train_bwd takes 1 to 2^31 - 1 tokens, got {b * h * w}")
    strip = 16 if w <= 16 else 32
    strips, slabs = -(-w // strip), -(-c // _SLAB)
    wanted = max(1, -(-_TAP_CTAS // (b * strips * slabs)))
    rows = max(min(h, _TAP_MIN_RUN_ROWS), -(-h // wanted))
    runs = -(-h // rows)
    parts = b * runs * strips
    smem = (_TAP_RING * (strip + 2 * PAD) * _SLAB * _ITEM[dtype]  # the x ring
            + _TAP_GSLOTS * strip * _SLAB * 4)  # the g_u ring, f32
    return {"strip": strip, "strips": strips, "slabs": slabs, "rows_per_run": rows,
            "runs": runs, "ctas": parts * slabs, "smem": smem, "parts": parts}


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


def conv_bias_reference(x: torch.Tensor, k49: torch.Tensor, dw_bias: torch.Tensor) -> torch.Tensor:
    """The plain conv recompute: ``u = dwconv7x7(x) + bias`` in f32, not
    rounded."""
    return depthwise_conv7x7_reference(x, k49) + dw_bias.float()


def tap_sums_reference(x: torch.Tensor, g_u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain tap sums from the f32 ``g_u`` (any shape of ``[B * H * W,
    C]``): ``dk = sum x_halo * g_u`` as ``[49, C]`` and ``ddwb = sum g_u``,
    f32."""
    c = x.shape[-1]
    g_u = g_u.reshape(x.shape)
    dk = conv2d_weight(
        x.float().permute(0, 3, 1, 2), (c, 1, KERNEL_SIZE, KERNEL_SIZE),
        g_u.permute(0, 3, 1, 2), padding=PAD, groups=c,
    ).reshape(c, TAPS).t()
    return dk, g_u.sum(dim=(0, 1, 2))


def block_train_bwd_reference(
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
    g: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, ...]:
    """Plain whole-block backward with the TPU kernel's rounding points:
    ``u = dwconv7x7(x) + bias`` in f32, not rounded, with the LayerNorm
    statistics from the mean of centred squares; ``y``, ``h``, ``g * gamma``,
    the hidden gradient and ``g`` rounded to x's dtype before their products;
    ``db1`` from the f32 hidden gradient; the LayerNorm backward from the f32
    ``g_y``; ``g_u`` written in x's dtype, but ``dk = sum x_halo * g_u`` and
    ``ddwb = sum g_u`` from the unrounded f32 ``g_u``. The kernel's three
    stages: :func:`conv_bias_reference`, ``fused_mlp.ln_mlp_bwd_core`` and
    :func:`tap_sums_reference`.

    Returns ``(g_u, dk49, ddwb, dls, dlb, dw1t, db1, dw2t, db2, dgamma)``:
    ``g_u`` in x's dtype and shape, the rest f32, ``dk49`` ``[49, C]``, the
    weight gradients in the layouts of ``w1t`` and ``w2t``."""
    c = x.shape[-1]
    u = conv_bias_reference(x, k49, dw_bias)
    g_u, *grads = fm.ln_mlp_bwd_core(
        u.reshape(-1, c), ln_scale, ln_bias, w1t, b1, w2t, b2, gamma,
        g.reshape(-1, c).float(), x.dtype, eps,
    )
    g_u = g_u.reshape(x.shape)
    dk, ddwb = tap_sums_reference(x, g_u)
    return (g_u.to(x.dtype), dk, ddwb, *grads)


def _check(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g) -> None:
    """Raise on what ``csrc/block_train_bwd.cu`` does not take, before any
    build or launch: NHWC ``x``, the filter, ``g`` and the weights of one
    type, bf16 or f32 (TypeError otherwise), f32 vectors, C in
    ``fused_mlp.KERNEL_WIDTHS``, contiguous tensors on x's device."""
    if x.dim() != 4:
        raise ValueError(f"block_train_bwd expects NHWC [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    fm._check("block_train_bwd", x, g, (("dw_bias", dw_bias, c), ("ln_scale", ln_scale, c),
                                        ("ln_bias", ln_bias, c), ("b1", b1, 4 * c),
                                        ("b2", b2, c), ("gamma", gamma, c)), w1t, w2t)
    if k49.dtype != x.dtype:
        raise TypeError(f"block_train_bwd takes x and the filter in one type, got x in "
                        f"{x.dtype} and k49 in {k49.dtype}")
    if (tuple(k49.shape) != (TAPS, c) or not k49.is_contiguous()
            or k49.device != x.device):
        raise ValueError("block_train_bwd wants the contiguous [49, C] filter on x's device")


def bwd_launch(
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
    g: torch.Tensor,
    eps: float = 1e-6,
) -> dict[str, torch.Tensor]:
    """Launch ``csrc/block_train_bwd.cu`` on CUDA tensors and return its
    buffers by name: the LN+MLP backward's (``fused_mlp._buffers``; ``dt`` is
    g_u in bf16), ``u`` and ``gu32`` (f32 ``[M, C]``), the tap sums'
    workspace ``tpart`` ``[parts, 50 * C]`` and ``taps`` (dk, ddwb), which the
    stage tests read. The launch counter is :func:`block_train_bwd`'s; this
    counts nothing. Raises on what the kernel does not take (``x``, ``k49``,
    ``g`` and the weights bf16 or f32, one type; C in
    ``fused_mlp.KERNEL_WIDTHS``), before any build or launch."""
    _check(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g)
    b, h, w, c = x.shape
    m = b * h * w
    taps = tap_geometry(b, h, w, c, x.dtype)
    dev, f32 = x.device, torch.float32
    geo = fm.bwd_geometry(m, c, x.dtype)
    o = fm._buffers(x, True, geo)
    o["u"] = torch.empty(m, c, dtype=f32, device=dev)
    o["gu32"] = torch.empty(m, c, dtype=f32, device=dev)
    o["tpart"] = torch.empty(taps["parts"], (TAPS + 1) * c, dtype=f32, device=dev)
    o["taps"] = torch.empty((TAPS + 1) * c, dtype=f32, device=dev)
    w1 = w1t.t().contiguous()
    w2 = w2t.t().contiguous()
    fn = cuda_build.load("block_train_bwd").svt_block_train_bwd
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(
        p(x), p(k49), p(dw_bias), p(ln_scale), p(ln_bias), p(w1t), p(w1), p(b1), p(w2t), p(w2),
        p(b2), p(gamma), p(g), p(o["dt"]), p(o["small"]), p(o["dw1t"]), p(o["dw2t"]),
        p(o["dgamma"]), p(o["taps"]), p(o["u"]), p(o["gu32"]), p(o["y"]), p(o["gg"]),
        p(o["stats"]), p(o["h"]), p(o["gh"]), p(o["gy"]), p(o["part"]), p(o["ws"]),
        p(o["tpart"]), ctypes.c_int(_DTYPES[x.dtype]), ctypes.c_int(b), ctypes.c_int(h),
        ctypes.c_int(w), ctypes.c_int(c),
        ctypes.c_int(geo["splits"]), ctypes.c_longlong(geo["ks"]), fm._plan_arg(geo),
        ctypes.c_int(taps["rows_per_run"]), ctypes.c_float(eps), cuda_build.stream_ptr(dev),
    )
    cuda_build.check(err, "block_train_bwd")
    return o


def block_train_bwd(
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
    g: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, ...]:
    """The whole-block backward from NHWC ``x`` and the output gradient ``g``:
    ``(g_u, dk49, ddwb, dls, dlb, dw1t, db1, dw2t, db2, dgamma)`` as
    :func:`block_train_bwd_reference`.

    CUDA tensors launch ``csrc/block_train_bwd.cu`` (:func:`bwd_launch`:
    ``x``, ``k49``, ``g`` and the weights bf16 or f32, one type; C in
    ``fused_mlp.KERNEL_WIDTHS``; anything else raises); CPU tensors take the
    plain version. ``block_train_bwd.launches`` counts calls that launched
    it, ``block_train_bwd.f32_launches`` those in f32.
    """
    args = (x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g)
    if x.device.type == "cpu":
        return block_train_bwd_reference(*args, eps=eps)
    o = bwd_launch(*args, eps=eps)
    block_train_bwd.launches += 1
    block_train_bwd.f32_launches += x.dtype == torch.float32
    c = x.shape[-1]
    small, taps = o["small"], o["taps"]
    return (o["dt"], taps[: TAPS * c].view(TAPS, c), taps[TAPS * c:], small[4 * c: 5 * c],
            small[5 * c: 6 * c], o["dw1t"], small[: 4 * c], o["dw2t"], small[6 * c: 7 * c],
            o["dgamma"])


block_train_bwd.launches = 0
block_train_bwd.f32_launches = 0


class _TrainBlock(torch.autograd.Function):
    """The block kernel's inference form forward; :func:`block_train_bwd` and
    the stencil for dx backward. Saves the primal inputs only."""

    @staticmethod
    def forward(ctx, x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, eps):
        ctx.save_for_backward(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma)
        ctx.eps = eps
        return convnext_block(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma = ctx.saved_tensors
        g = g.contiguous()
        g_u, dk, ddwb, dls, dlb, dw1t, db1, dw2t, db2, dgamma = block_train_bwd(
            x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g, ctx.eps
        )
        dx_conv = depthwise_conv7x7(g_u, k49.flip(0).contiguous())
        dx = (g.float() + dx_conv.float()).to(x.dtype)
        return (
            dx,
            dk.to(k49.dtype),
            ddwb.to(dw_bias.dtype),
            dls.to(ln_scale.dtype),
            dlb.to(ln_bias.dtype),
            dw1t.to(w1t.dtype),
            db1.to(b1.dtype),
            dw2t.to(w2t.dtype),
            db2.to(b2.dtype),
            dgamma.to(gamma.dtype),
            None,
        )


def convnext_block_train(
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
    """Trainable whole-block ConvNeXt block on NHWC ``x`` (the JAX package's
    ``use_pallas="block"``), arguments as :func:`convnext_block_hybrid`.
    Without grad it is the block kernel's inference form."""
    if x.shape[-1] > MAX_FUSED_DIM:
        raise ValueError(
            f"C={x.shape[-1]} exceeds MAX_FUSED_DIM={MAX_FUSED_DIM}; such blocks "
            "train on plain ops"
        )
    return _TrainBlock.apply(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, eps)
