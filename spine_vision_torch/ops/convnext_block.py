"""Whole ConvNeXt v1 block forward (NHWC, C <= 512).

``x + gamma * (W2 . gelu_tanh(W1 . LN(dwconv7x7(x) + b_dw) + b1) + b2)``:
counterpart of ``spine_vision_tpu/ops/convnext_block.py::convnext_block_fused``
(forward only). On a CUDA tensor :func:`convnext_block` launches the
hand-written kernels of ``csrc/convnext_block.cu`` (they replace the TPU
kernel ``_block_pallas``; see the source for their design and bound), three
a call:

- P, the stencil + bias + LayerNorm prologue: ``y = LN(dwconv7x7(x) + b_dw)``
  in x's dtype (:func:`prologue_reference`);
- F1, the hidden product: ``h = gelu_tanh(y . W1 + b1)`` in x's dtype
  (:func:`hidden_reference`);
- F2, the output product: ``out = (h . W2 + b2) * gamma + x``
  (:func:`out_reference`).

x and the weights come in bf16 or f32 (one type), as the JAX kernel runs in
either: bf16 on wgmma products, f32 on the same core's 3xTF32 path
(``csrc/wg_gemm.cuh``, split over K where the tiles would leave SMs idle)
after an f32 P, whose halo ring takes twice the shared memory
(:func:`forward_geometry`).

F1 and F2, and their plain versions, are shared with the row MLP forms
(``ops/fused_mlp.py``), which launch the same products.

On a CPU tensor it runs :func:`block_reference`, the plain PyTorch version of
the whole call with the kernels' rounding points (y and the GELU hidden
rounded to x's dtype before each product, f32 accumulation and epilogue, the
residual from x itself); the three stage versions compose to it bit for bit.

With ``emit_conv=True`` (the hybrid training block's forward) both also return
``t = dwconv7x7(x) + b_dw`` rounded to x's dtype, and the LayerNorm reads that
rounded ``t``, as the TPU kernel's ``emit_conv`` form does; without it the
LayerNorm reads the f32 ``t``.

:func:`convnext_block_fused` is the trainable block, the counterpart of the
JAX package's custom VJP ``_block_ad``: the kernel forward (inference form),
and a backward that recomputes ``y = LN(dwconv7x7(x) + b_dw)`` with
``dw_ln``, runs the MLP backward ``mlp_bwd`` and then the dwconv+LN backward
``dw_ln_bwd`` (kernels on the card, plain versions on the CPU).

Weights come in the layouts ``models/convert.py`` makes once at load time:
the filter tap-major ``[49, C]``, ``w1t`` ``[4C, C]`` and ``w2t`` ``[C, 4C]``
(``[out, in]``).
"""

from __future__ import annotations

import ctypes

import torch

from spine_vision_torch.ops import cuda_build
from spine_vision_torch.ops.dwconv import (
    _DTYPES,
    _ITEM,
    SMEM_A_SM,
    SMEM_RESERVED,
    depthwise_conv7x7_reference,
    dw_ln,
    dw_ln_bwd,
    layer_norm_f32,
)
from spine_vision_torch.ops.fused_mlp import (  # noqa: F401  (F1's and F2's plain versions)
    _plan_arg,
    hidden_reference,
    mlp_bwd,
    out_reference,
    product_geometry,
    tanh_gelu,
)

KERNEL_WIDTHS = (96, 128, 192, 256, 384, 512)  # widths the CUDA kernels are built for


def block_reference(
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
    emit_conv: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch block forward with the kernel's rounding points; with
    ``emit_conv``, ``(out, t)``."""
    t = depthwise_conv7x7_reference(x, k49) + dw_bias.float()
    if emit_conv:
        t_lp = t.to(x.dtype)
        t = t_lp.float()
    y = layer_norm_f32(t, ln_scale, ln_bias, eps).to(x.dtype)
    hidden = torch.matmul(y.float(), w1t.float().t()) + b1.float()
    hidden = tanh_gelu(hidden).to(x.dtype)
    out = torch.matmul(hidden.float(), w2t.float().t()) + b2.float()
    out = (out * gamma.float() + x.float()).to(x.dtype)
    return (out, t_lp) if emit_conv else out


def prologue_reference(
    x: torch.Tensor,
    k49: torch.Tensor,
    dw_bias: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    eps: float = 1e-6,
    emit_conv: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The plain P: ``(y, t)``, y = LN(dwconv7x7(x) + b_dw) in x's dtype and
    shape; with ``emit_conv`` t rounded to x's dtype, which the LayerNorm
    reads, else ``None`` and the LayerNorm reads the f32 t."""
    t = depthwise_conv7x7_reference(x, k49) + dw_bias.float()
    t_lp = None
    if emit_conv:
        t_lp = t.to(x.dtype)
        t = t_lp.float()
    return layer_norm_f32(t, ln_scale, ln_bias, eps).to(x.dtype), t_lp


# csrc/convnext_block.cu's launch geometry. P: a CTA takes _TILE_COLS
# columns by _tile_rows(C) rows of one image and walks C in halo chunks of
# _CHUNK channels. F1 and F2: csrc/wg_gemm.cuh's mlp_products
# (fused_mlp.product_geometry).
_TILE_COLS = 8  # PW
_CHUNK = 64  # PCC
_HALO = 3  # the 7x7 stencil's reach


def _tile_rows(c: int) -> int:
    """P's tile rows (PTile::PH): 64 tokens at C <= 192, else 32, so that the
    f32 t tile and two bf16 halo chunks leave room for two CTAs a
    multiprocessor (f32 halo chunks: one at most widths)."""
    return 8 if c <= 192 else 4


def forward_geometry(b: int, h: int, w: int, c: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch geometry of ``csrc/convnext_block.cu`` for a [b, h, w, c]
    input in ``dtype``: P's tile (rows, cols), its tiles a side, CTAs, halo
    chunks, shared memory a CTA (the f32 t tile and two halo chunks in
    ``dtype``) and the CTAs that fit on a multiprocessor at once; F1's and
    F2's (row, column) tiles, wgmma tiles a CTA tile (``nb``) and K plans
    (:func:`fused_mlp.product_geometry`). Raises on what the kernels do not
    take, before anything is launched."""
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"convnext_block kernel is built for C in {KERNEL_WIDTHS}, got {c}")
    m = b * h * w
    if not 0 < m < 2 ** 31:
        raise ValueError(f"convnext_block kernels take 1 to 2^31 - 1 tokens (TMA coordinates "
                         f"are 32-bit), got {m}")
    rows = _tile_rows(c)
    tiles = (-(-h // rows), -(-w // _TILE_COLS))
    halo = (rows + 2 * _HALO) * (_TILE_COLS + 2 * _HALO) * _CHUNK * _ITEM[dtype]
    smem = rows * _TILE_COLS * c * 4 + 2 * halo
    return {
        "tile": (rows, _TILE_COLS),
        "tiles": tiles,
        "ctas": b * tiles[0] * tiles[1],
        "chunks": -(-c // _CHUNK),
        "prologue_smem": smem,
        "prologue_ctas_an_sm": min(2, SMEM_A_SM // (smem + SMEM_RESERVED)),  # launch bounds: 2
        **product_geometry(m, c, dtype),
    }


def _check(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma) -> None:
    """Raise on what the kernels do not take, before any build or launch: x,
    the filter and the weights of one type, bf16 or f32 (TypeError
    otherwise), f32 vectors, C in ``KERNEL_WIDTHS``, contiguous 16-byte
    aligned tensors on x's device."""
    if x.dim() != 4:
        raise ValueError(f"convnext_block expects NHWC [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"convnext_block kernel is built for C in {KERNEL_WIDTHS}, got {c}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"convnext_block kernel takes bf16 or f32 on the card, got {x.dtype}")
    typed = {"k49": k49, "w1t": w1t, "w2t": w2t}
    if any(t.dtype != x.dtype for t in typed.values()):
        raise TypeError(f"convnext_block kernel takes x, the filter and the weights in one "
                        f"type, got x in {x.dtype} and " + ", ".join(
                            f"{n} in {t.dtype}" for n, t in typed.items()))
    shapes = {
        "k49": (k49, (49, c), x.dtype),
        "w1t": (w1t, (4 * c, c), x.dtype),
        "w2t": (w2t, (c, 4 * c), x.dtype),
        "dw_bias": (dw_bias, (c,), torch.float32),
        "ln_scale": (ln_scale, (c,), torch.float32),
        "ln_bias": (ln_bias, (c,), torch.float32),
        "b1": (b1, (4 * c,), torch.float32),
        "b2": (b2, (c,), torch.float32),
        "gamma": (gamma, (c,), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"convnext_block: {name} must be {dtype} {shape}")
    for name, t in [("x", x)] + [(n, v[0]) for n, v in shapes.items()]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"convnext_block: {name} must be contiguous and 16-byte aligned")
        if t.device != x.device:
            raise ValueError(f"convnext_block: {name} is on {t.device}, x on {x.device}")


def fwd_launch(
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
    emit_conv: bool = False,
) -> dict[str, torch.Tensor]:
    """Launch ``csrc/convnext_block.cu``'s P, F1 and F2 on CUDA tensors and
    return its buffers by name: ``out``, ``t`` (with ``emit_conv``) and the
    scratch ``y`` [M, C] and ``h`` [M, 4C], which the stage tests read. The
    launch counters are :func:`convnext_block`'s; this counts nothing."""
    args = (x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma)
    _check(*args)
    b, h, w, c = x.shape
    geo = forward_geometry(b, h, w, c, x.dtype)
    m = b * h * w
    o = {"out": torch.empty_like(x),
         "y": torch.empty(m, c, dtype=x.dtype, device=x.device),
         "h": torch.empty(m, 4 * c, dtype=x.dtype, device=x.device)}
    if emit_conv:
        o["t"] = torch.empty_like(x)
    # The f32 K splits' partials (as fused_mlp.row_launch's).
    ws = torch.empty(geo["ws_elems"], dtype=torch.float32, device=x.device) \
        if geo["ws_elems"] else None
    fn = cuda_build.load("convnext_block").svt_convnext_block_forward
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    none = ctypes.c_void_p(None)
    err = fn(
        *(p(a) for a in args), p(o["out"]), p(o["t"]) if emit_conv else none,
        p(o["y"]), p(o["h"]), none if ws is None else p(ws), _plan_arg(geo),
        ctypes.c_int(_DTYPES[x.dtype]), ctypes.c_int(b), ctypes.c_int(h),
        ctypes.c_int(w), ctypes.c_int(c), ctypes.c_float(eps), cuda_build.stream_ptr(x.device),
    )
    cuda_build.check(err, "convnext_block")
    return o


def convnext_block(
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
    emit_conv: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """One fused ConvNeXt v1 block forward on NHWC ``x``; with ``emit_conv``,
    ``(out, t)``.

    CUDA tensors launch ``csrc/convnext_block.cu`` (x, the filter and the
    weights bf16 or f32, one type; C in ``KERNEL_WIDTHS``; anything else
    raises). CPU tensors take the plain version. ``convnext_block.launches``
    counts calls that launched the kernels, of either form and type,
    ``convnext_block.emit_launches`` those of the ``emit_conv`` form, and
    ``f32_launches`` and ``emit_f32_launches`` the same in f32.
    """
    args = (x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma)
    if x.device.type == "cpu":
        return block_reference(*args, eps=eps, emit_conv=emit_conv)
    o = fwd_launch(*args, eps=eps, emit_conv=emit_conv)
    f32 = x.dtype == torch.float32
    convnext_block.launches += 1
    convnext_block.f32_launches += f32
    if emit_conv:
        convnext_block.emit_launches += 1
        convnext_block.emit_f32_launches += f32
        return o["out"], o["t"]
    return o["out"]


convnext_block.launches = 0
convnext_block.emit_launches = 0
convnext_block.f32_launches = 0
convnext_block.emit_f32_launches = 0


class _FusedBlock(torch.autograd.Function):
    """The block kernel forward; saves the primal inputs only."""

    @staticmethod
    def forward(ctx, x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, eps):
        ctx.save_for_backward(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma)
        ctx.eps = eps
        return convnext_block(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma = ctx.saved_tensors
        g = g.contiguous()
        y = dw_ln(x, k49, dw_bias, ln_scale, ln_bias, ctx.eps)
        dy, dw1t, db1, dw2t, db2, dgamma = mlp_bwd(y, w1t, b1, w2t, b2, gamma, g)
        dx1, dk, dbias, dscale, dbeta = dw_ln_bwd(x, k49, dw_bias, ln_scale, dy, ctx.eps)
        dx = (dx1.float() + g.float()).to(x.dtype)
        return (
            dx,
            dk.to(k49.dtype),
            dbias.to(dw_bias.dtype),
            dscale.to(ln_scale.dtype),
            dbeta.to(ln_bias.dtype),
            dw1t.to(w1t.dtype),
            db1.to(b1.dtype),
            dw2t.to(w2t.dtype),
            db2.to(b2.dtype),
            dgamma.to(gamma.dtype),
            None,
        )


def convnext_block_fused(
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
    """Trainable fused ConvNeXt v1 block on NHWC ``x``, arguments as
    :func:`convnext_block`. Without grad it is :func:`convnext_block`; the
    backward is described in the module docstring, with ``dx = dx_conv + g``
    added in f32, and gradients come back in each argument's dtype."""
    return _FusedBlock.apply(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, eps)
