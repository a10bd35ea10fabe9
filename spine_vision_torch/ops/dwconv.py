"""Fused depthwise 7x7 conv + bias + channel LayerNorm (NHWC).

Counterpart of ``spine_vision_tpu/ops/dwconv.py::depthwise_conv7x7_ln``. On a
CUDA tensor :func:`dw_ln` launches the hand-written kernel
``csrc/dwconv_ln.cu`` (a warp per few tokens, LayerNorm in registers; it replaces
the TPU kernel ``_dw_ln_pallas``); on a CPU tensor it runs
:func:`dw_ln_reference`, the plain PyTorch version of the same arithmetic.
The kernel takes the tap-major filter ``[49, C]`` that
``models/convert.py`` produces once at load time.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from spine_vision_torch.ops import cuda_build

KERNEL_SIZE = 7
PAD = KERNEL_SIZE // 2
# Widths the CUDA kernel is built for: every ConvNeXt v1/v2 stage width.
KERNEL_WIDTHS = (96, 128, 192, 256, 352, 384, 512, 704, 768, 1024, 1408, 1536, 2048, 2816)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def depthwise_conv7x7_reference(x: torch.Tensor, k49: torch.Tensor) -> torch.Tensor:
    """SAME 7x7 depthwise conv of NHWC ``x`` with the ``[49, C]`` filter, in
    f32 (the kernels accumulate in f32)."""
    c = x.shape[-1]
    weight = k49.float().t().reshape(c, 1, KERNEL_SIZE, KERNEL_SIZE)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), weight, padding=PAD, groups=c)
    return y.permute(0, 2, 3, 1)


def layer_norm_f32(
    t: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """Channel LayerNorm in f32 with the mean of centred squares."""
    mu = t.mean(dim=-1, keepdim=True)
    centred = t - mu
    var = (centred * centred).mean(dim=-1, keepdim=True)
    return centred * torch.rsqrt(var + eps) * scale.float() + bias.float()


def dw_ln_reference(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain ``LayerNorm(dwconv7x7(x) + bias)``: grouped ``F.conv2d`` and an f32
    LayerNorm, output in ``x``'s dtype."""
    t = depthwise_conv7x7_reference(x, k49) + bias.float()
    return layer_norm_f32(t, ln_scale, ln_bias, eps).to(x.dtype)


def _check(x, k49, bias, ln_scale, ln_bias) -> None:
    if x.dim() != 4:
        raise ValueError(f"dw_ln expects NHWC [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"dw_ln kernel is built for C in {KERNEL_WIDTHS}, got {c}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dw_ln kernel takes bf16 or f32, got {x.dtype}")
    if k49.shape != (KERNEL_SIZE * KERNEL_SIZE, c) or k49.dtype != x.dtype:
        raise ValueError("dw_ln kernel wants the [49, C] filter in x's dtype")
    for name, t in (("x", x), ("k49", k49), ("bias", bias),
                    ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        if not t.is_contiguous():
            raise ValueError(f"dw_ln: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"dw_ln: {name} is on {t.device}, x on {x.device}")
    for name, t in (("bias", bias), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"dw_ln: {name} must be f32 [C]")


def dw_ln(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Fused ``LayerNorm(dwconv7x7(x) + bias)`` on NHWC ``x``.

    CUDA tensors launch ``csrc/dwconv_ln.cu`` (bf16 or f32, C in
    ``KERNEL_WIDTHS``; anything else raises). CPU tensors take the plain
    version. ``dw_ln.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return dw_ln_reference(x, k49, bias, ln_scale, ln_bias, eps)
    _check(x, k49, bias, ln_scale, ln_bias)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    lib = cuda_build.load("dwconv_ln")
    fn = lib.svt_dw_ln_forward
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(
        p(x), p(k49), p(bias), p(ln_scale), p(ln_bias), p(out),
        ctypes.c_int(_DTYPES[x.dtype]), ctypes.c_int(b), ctypes.c_int(h),
        ctypes.c_int(w), ctypes.c_int(c), ctypes.c_float(eps),
        cuda_build.stream_ptr(x.device),
    )
    cuda_build.check(err, "dwconv_ln")
    dw_ln.launches += 1
    return out


dw_ln.launches = 0
