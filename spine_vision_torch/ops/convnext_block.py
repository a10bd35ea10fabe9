"""Whole ConvNeXt v1 block forward in one kernel (NHWC, C <= 512).

``x + gamma * (W2 . gelu_tanh(W1 . LN(dwconv7x7(x) + b_dw) + b1) + b2)``:
counterpart of ``spine_vision_tpu/ops/convnext_block.py::convnext_block_fused``
(forward only). On a CUDA tensor :func:`convnext_block` launches the
hand-written kernel ``csrc/convnext_block.cu`` (replaces the TPU kernel
``_block_pallas``; see the source for its design and bound); on a CPU tensor it
runs :func:`block_reference`, the plain PyTorch version with the kernel's
rounding points (y and the GELU hidden rounded to x's dtype before each
product, f32 accumulation and epilogue, the residual from x itself).

With ``emit_conv=True`` (the hybrid training block's forward) both also return
``t = dwconv7x7(x) + b_dw`` rounded to x's dtype, and the LayerNorm reads that
rounded ``t``, as the TPU kernel's ``emit_conv`` form does.

Weights come in the layouts ``models/convert.py`` makes once at load time:
the filter tap-major ``[49, C]``, ``w1t`` ``[4C, C]`` and ``w2t`` ``[C, 4C]``
(``[out, in]``).
"""

from __future__ import annotations

import ctypes

import torch

from spine_vision_torch.ops import cuda_build
from spine_vision_torch.ops.dwconv import depthwise_conv7x7_reference, layer_norm_f32
from spine_vision_torch.ops.fused_mlp import tanh_gelu

KERNEL_WIDTHS = (96, 128, 192, 256, 384, 512)  # widths the CUDA kernel is built for


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


def _check(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma) -> None:
    if x.dim() != 4:
        raise ValueError(f"convnext_block expects NHWC [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"convnext_block kernel is built for C in {KERNEL_WIDTHS}, got {c}")
    if x.dtype != torch.bfloat16:
        raise TypeError(
            f"convnext_block kernel takes bf16 on the card (its products run on "
            f"bf16 tensor cores), got {x.dtype}"
        )
    shapes = {
        "k49": (k49, (49, c), torch.bfloat16),
        "w1t": (w1t, (4 * c, c), torch.bfloat16),
        "w2t": (w2t, (c, 4 * c), torch.bfloat16),
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

    CUDA tensors launch ``csrc/convnext_block.cu`` (bf16, C in
    ``KERNEL_WIDTHS``; anything else raises). CPU tensors take the plain
    version. ``convnext_block.launches`` counts kernel launches of either
    form, ``convnext_block.emit_launches`` those of the ``emit_conv`` form.
    """
    args = (x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma)
    if x.device.type == "cpu":
        return block_reference(*args, eps=eps, emit_conv=emit_conv)
    _check(*args)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    t = torch.empty_like(x) if emit_conv else None
    fn = cuda_build.load("convnext_block").svt_convnext_block_forward
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(
        *(p(a) for a in args), p(out), p(t) if emit_conv else ctypes.c_void_p(None),
        ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(c),
        ctypes.c_float(eps), cuda_build.stream_ptr(x.device),
    )
    cuda_build.check(err, "convnext_block")
    convnext_block.launches += 1
    if emit_conv:
        convnext_block.emit_launches += 1
        return out, t
    return out


convnext_block.launches = 0
convnext_block.emit_launches = 0
