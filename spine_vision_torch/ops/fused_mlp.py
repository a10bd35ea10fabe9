"""ConvNeXt block MLP pieces: the tanh-GELU, its derivative, and the backward
of the block's LayerNorm + MLP + LayerScale.

Counterpart of ``spine_vision_tpu/ops/fused_mlp.py``. :func:`ln_mlp_bwd` is
the backward of ``out = x + gamma * (W2 . gelu_tanh(W1 . LN(t) + b1) + b2)``
with respect to ``t`` and the parameters, the hybrid training block's
backward (``ops/block_train.py``). On a CUDA tensor it launches the
hand-written kernel ``csrc/ln_mlp_bwd.cu`` (it replaces the TPU kernels
``_ln_mlp_bwd_pallas_resident`` and ``_ln_mlp_bwd_pallas``, which compute the
same function; see the source for its design and bound); on a CPU tensor it
runs :func:`ln_mlp_bwd_reference`, the plain PyTorch version with the TPU
kernels' rounding points. The forward MLP kernels are not ported yet
(ROADMAP, Queue 2).
"""

from __future__ import annotations

import ctypes
import math

import torch

from spine_vision_torch.ops import cuda_build

# Widest block whose MLP runs inside the whole-block kernel; wider blocks run
# the dwconv+LN kernel followed by a plain MLP.
MAX_FUSED_DIM = 512
KERNEL_WIDTHS = (96, 128, 192, 256, 384, 512)  # widths ln_mlp_bwd.cu is built for
LN_EPS = 1e-6  # the LayerNorm epsilon of the fused kernels

_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715
_TOKENS_PER_CTA = 64  # csrc/ln_mlp_bwd.cu, TOK
_TARGET_CTAS = 528  # 4 a streaming multiprocessor on an H100


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, the ConvNeXt block MLP's activation (the same
    formula as the kernels; ``torch.nn.GELU()`` defaults to erf)."""
    u = _GELU_C * (x + _GELU_A * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def gelu_and_grad(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(gelu(x), gelu'(x))`` sharing one tanh, in ``x``'s dtype.

    With t = tanh(u), u = c*(x + a*x^3): gelu = 0.5*x*(1+t) and
    gelu' = 0.5*(1+t) + 0.5*x*(1-t^2)*c*(1+3a*x^2).
    """
    x2 = x * x
    t = torch.tanh(_GELU_C * (x + _GELU_A * x * x2))
    half_1pt = 0.5 * (1.0 + t)
    du = _GELU_C * (1.0 + 3.0 * _GELU_A * x2)
    return x * half_1pt, half_1pt + 0.5 * x * (1.0 - t * t) * du


def ln_rows(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row LayerNorm statistics over the last axis: ``(yhat, rstd)``."""
    mu = xf.mean(dim=-1, keepdim=True)
    centred = xf - mu
    var = (centred * centred).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    return centred * rstd, rstd


def ln_mlp_bwd_reference(
    t: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch LN+MLP backward with the TPU kernels' rounding points.

    ``y``, ``h``, ``g * gamma``, the hidden gradient and ``g`` are rounded to
    ``t``'s dtype before their products; products and everything else run in
    f32; ``db1`` sums the unrounded hidden gradient. Returns ``(dt, dls, dlb,
    dw1t, db1, dw2t, db2, dgamma)``: ``dt`` in ``t``'s dtype and shape, the
    rest f32, weight gradients in the layouts of ``w1t`` ``[4C, C]`` and
    ``w2t`` ``[C, 4C]``.
    """
    lp = t.dtype
    c = t.shape[-1]
    tf = t.reshape(-1, c).float()
    gf = g.reshape(-1, c).float()
    yhat, rstd = ln_rows(tf)
    ls = ln_scale.float()
    y_lp = (yhat * ls + ln_bias.float()).to(lp).float()
    hpre = y_lp @ w1t.float().t() + b1.float()
    h, dgelu = gelu_and_grad(hpre)
    h_lp = h.to(lp).float()
    gamma_f = gamma.float()
    g_mlp = (gf * gamma_f).to(lp).float()
    g_hpre_f = (g_mlp @ w2t.float()) * dgelu
    g_hpre = g_hpre_f.to(lp).float()
    g_y = g_hpre @ w1t.float()
    dw1t = g_hpre.t() @ y_lp
    a_t = gf.to(lp).float().t() @ h_lp  # [C, 4C]
    dw2t = a_t * gamma_f[:, None]
    dgamma = (w2t.float() * a_t).sum(dim=1) + gf.sum(dim=0) * b2.float()
    dyhat = g_y * ls
    dt = rstd * (
        dyhat
        - dyhat.mean(dim=-1, keepdim=True)
        - yhat * (dyhat * yhat).mean(dim=-1, keepdim=True)
    )
    return (
        dt.to(lp).reshape(t.shape),
        (g_y * yhat).sum(dim=0),
        g_y.sum(dim=0),
        dw1t,
        g_hpre_f.sum(dim=0),
        dw2t,
        (gf * gamma_f).sum(dim=0),
        dgamma,
    )


def token_splits(m: int, c: int) -> int:
    """Token splits of the kernel's weight-gradient products: enough CTAs to
    fill the card, at least 32 tokens a split."""
    tiles = -(-4 * c // 64) * -(-c // 64)
    return max(1, min(-(-_TARGET_CTAS // tiles), -(-m // 32)))


def _check(t, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g) -> None:
    c = t.shape[-1]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"ln_mlp_bwd kernel is built for C in {KERNEL_WIDTHS}, got {c}")
    if t.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(
            f"ln_mlp_bwd kernel takes bf16 t and g on the card (its products run "
            f"on bf16 tensor cores), got {t.dtype} and {g.dtype}"
        )
    shapes = {
        "g": (g, tuple(t.shape), torch.bfloat16),
        "w1t": (w1t, (4 * c, c), torch.bfloat16),
        "w2t": (w2t, (c, 4 * c), torch.bfloat16),
        "ln_scale": (ln_scale, (c,), torch.float32),
        "ln_bias": (ln_bias, (c,), torch.float32),
        "b1": (b1, (4 * c,), torch.float32),
        "b2": (b2, (c,), torch.float32),
        "gamma": (gamma, (c,), torch.float32),
    }
    for name, (v, shape, dtype) in shapes.items():
        if tuple(v.shape) != shape or v.dtype != dtype:
            raise ValueError(f"ln_mlp_bwd: {name} must be {dtype} {shape}")
    for name, v in [("t", t)] + [(n, s[0]) for n, s in shapes.items()]:
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"ln_mlp_bwd: {name} must be contiguous and 16-byte aligned")
        if v.device != t.device:
            raise ValueError(f"ln_mlp_bwd: {name} is on {v.device}, t on {t.device}")


def ln_mlp_bwd(
    t: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Backward of the block's LN + MLP + LayerScale from ``t`` and ``g``.

    Returns ``(dt, dls, dlb, dw1t, db1, dw2t, db2, dgamma)`` as
    :func:`ln_mlp_bwd_reference`. CUDA tensors launch ``csrc/ln_mlp_bwd.cu``
    (bf16 ``t`` and ``g``, C in ``KERNEL_WIDTHS``; anything else raises); CPU
    tensors take the plain version. ``ln_mlp_bwd.launches`` counts calls that
    launched the kernel.
    """
    args = (t, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g)
    if t.device.type == "cpu":
        return ln_mlp_bwd_reference(*args)
    _check(*args)
    c = t.shape[-1]
    m = t.numel() // c
    dev = t.device
    bf16, f32 = torch.bfloat16, torch.float32
    splits = token_splits(m, c)
    tiles = -(-m // _TOKENS_PER_CTA)
    dt = torch.empty_like(t)
    small = torch.empty(8 * c, dtype=f32, device=dev)
    dw1t = torch.empty(4 * c, c, dtype=f32, device=dev)
    dw2t = torch.empty(c, 4 * c, dtype=f32, device=dev)
    dgamma = torch.empty(c, dtype=f32, device=dev)
    # The kernel reads each weight in both layouts; scratch for the hidden.
    w1 = w1t.t().contiguous()
    w2 = w2t.t().contiguous()
    y = torch.empty(m, c, dtype=bf16, device=dev)
    h = torch.empty(m, 4 * c, dtype=bf16, device=dev)
    gh = torch.empty(m, 4 * c, dtype=bf16, device=dev)
    part = torch.empty(tiles, 8 * c, dtype=f32, device=dev)
    ws = torch.empty(splits, 4 * c, c, dtype=f32, device=dev)
    fn = cuda_build.load("ln_mlp_bwd").svt_ln_mlp_bwd
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(
        p(t), p(g), p(ln_scale), p(ln_bias), p(w1t), p(w1), p(b1), p(w2t), p(w2),
        p(b2), p(gamma), p(dt), p(small), p(dw1t), p(dw2t), p(dgamma),
        p(y), p(h), p(gh), p(part), p(ws),
        ctypes.c_longlong(m), ctypes.c_int(c), ctypes.c_int(splits),
        cuda_build.stream_ptr(dev),
    )
    cuda_build.check(err, "ln_mlp_bwd")
    ln_mlp_bwd.launches += 1
    db1, dls, dlb, db2 = small[: 4 * c], small[4 * c: 5 * c], small[5 * c: 6 * c], small[6 * c: 7 * c]
    return dt, dls, dlb, dw1t, db1, dw2t, db2, dgamma


ln_mlp_bwd.launches = 0
