"""Depthwise 7x7 conv, and the fused depthwise 7x7 conv + bias + channel
LayerNorm with its backward (NHWC).

Counterpart of ``spine_vision_tpu/ops/dwconv.py``. Each wrapper launches a
hand-written kernel on a CUDA tensor and runs its plain PyTorch version
(``*_reference``) on a CPU tensor:

- :func:`dw_ln`, ``LayerNorm(dwconv7x7(x) + bias)``: ``csrc/dwconv_ln.cu``'s
  ``dw_ln_tile``, the conv of a full-C tile from halos staged in shared
  memory, then a warp-a-token LayerNorm (replaces ``_dw_ln_pallas``; launch
  geometry :func:`stats_geometry`, the backward's S's);
- :func:`depthwise_conv7x7`, the plain stencil: ``csrc/dwconv_bwd.cu``'s
  ``dw_stencil``, persistent CTAs on halo tiles staged in shared memory
  (replaces ``depthwise_conv7x7``; launch geometry :func:`stencil_geometry`);
- :func:`dw_ln_bwd_sums`, the backward of :func:`dw_ln` but dx:
  ``csrc/dwconv_bwd.cu`` (replaces ``_dw_ln_bwd_pallas``'s first kernel) in
  three launches, :func:`bwd_launch`: S ``dw_bwd_stats`` (the LayerNorm
  statistics of each token, :func:`bwd_stats_reference`), T ``dw_bwd_tile``
  (da and each CTA's parameter sums, :func:`bwd_tile_reference`) and the
  fixed-order column sums (geometry :func:`bwd_geometry`);
  :func:`dw_ln_bwd` adds dx, :func:`depthwise_conv7x7` on the flipped filter.

:func:`depthwise_conv7x7_ln` pairs the forward with that backward as a
``torch.autograd.Function`` (the counterpart of ``_dw_ln_ad``). The kernels
take the tap-major filter ``[49, C]`` that ``models/convert.py`` produces once
at load time; in that layout the spatially flipped filter is ``k49.flip(0)``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_weight

from spine_vision_torch.ops import cuda_build

KERNEL_SIZE = 7
PAD = KERNEL_SIZE // 2
TAPS = KERNEL_SIZE * KERNEL_SIZE
# Widths the CUDA kernels are built for: every ConvNeXt v1/v2 stage width.
KERNEL_WIDTHS = (96, 128, 192, 256, 352, 384, 512, 704, 768, 1024, 1408, 1536, 2048, 2816)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_SUMS = TAPS + 3  # csrc/dwconv_bwd.cu, NSUM: dk, dbias, dscale, dbeta
_ITEM = {torch.bfloat16: 2, torch.float32: 4}  # bytes an element


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


def bwd_stats_reference(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    g: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The plain S: each token's ``(mu, rstd, mean(g * scale), mean(g * scale
    * yhat))`` over the channels, f32 ``[B, H, W, 4]``, with a = the conv
    recomputed from x in f32 plus bias, rstd from the mean of the centred
    squares and yhat = (a - mu) * rstd."""
    a = depthwise_conv7x7_reference(x, k49) + bias.float()
    mu = a.mean(dim=-1, keepdim=True)
    centred = a - mu
    rstd = torch.rsqrt((centred * centred).mean(dim=-1, keepdim=True) + eps)
    dyhat = g.float() * ln_scale.float()
    return torch.cat((mu, rstd, dyhat.mean(dim=-1, keepdim=True),
                      (dyhat * (centred * rstd)).mean(dim=-1, keepdim=True)), dim=-1)


def bwd_tile_reference(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    g: torch.Tensor,
    stats: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """The plain T and column sums, from S's ``stats`` (any shape of ``[M,
    4]``): the conv recomputed in f32 plus bias, ``da = rstd * (g * scale -
    mean(g * scale) - yhat * mean(g * scale * yhat))`` in f32, ``dbias = sum
    da`` and ``dk = sum x_halo * da`` from the unrounded ``da``, ``dscale =
    sum g * yhat``, ``dbeta = sum g``. Returns ``(da, dk49, dbias, dscale,
    dbeta)``: ``da`` rounded to x's dtype, the rest f32, ``dk49`` ``[49, C]``."""
    c = x.shape[-1]
    a = depthwise_conv7x7_reference(x, k49) + bias.float()
    st = stats.reshape(*x.shape[:3], 4)
    mu, rstd, mean_d, mean_dy = (st[..., i: i + 1] for i in range(4))
    yhat = (a - mu) * rstd
    gf = g.float()
    da = rstd * (gf * ln_scale.float() - mean_d - yhat * mean_dy)
    dk = conv2d_weight(
        x.float().permute(0, 3, 1, 2), (c, 1, KERNEL_SIZE, KERNEL_SIZE),
        da.permute(0, 3, 1, 2), padding=PAD, groups=c,
    ).reshape(c, TAPS).t()
    sums = (0, 1, 2)
    return (da.to(x.dtype), dk, da.sum(dim=sums), (gf * yhat).sum(dim=sums),
            gf.sum(dim=sums))


def dw_ln_bwd_sums_reference(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    g: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, ...]:
    """Plain backward of :func:`dw_ln_reference` up to ``dx``, for the output
    gradient ``g``, with the TPU kernel's rounding points: :func:`bwd_stats_reference`
    then :func:`bwd_tile_reference`, the kernel's two steps. Returns ``(da,
    dk49, dbias, dscale, dbeta)``: ``da`` rounded to x's dtype, the rest f32,
    ``dk49`` in the ``[49, C]`` layout."""
    stats = bwd_stats_reference(x, k49, bias, ln_scale, g, eps)
    return bwd_tile_reference(x, k49, bias, ln_scale, g, stats)


def dw_ln_bwd_reference(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    g: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, ...]:
    """Plain backward of :func:`dw_ln_reference`: :func:`dw_ln_bwd_sums_reference`,
    then ``dx``, the conv of the rounded ``da`` with the flipped filter, in
    x's dtype. Returns ``(dx, dk49, dbias, dscale, dbeta)``."""
    da, *sums = dw_ln_bwd_sums_reference(x, k49, bias, ln_scale, g, eps)
    return (depthwise_conv7x7_reference(da, k49.flip(0)).to(x.dtype), *sums)


def _check_args(name, x, k49, vectors=(), g=None) -> None:
    """Raise on what ``name``'s kernel does not take: ``vectors`` are
    ``(name, tensor)`` pairs of f32 ``[C]``, ``g`` an optional gradient."""
    if x.dim() != 4:
        raise ValueError(f"{name} expects NHWC [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"{name} kernel is built for C in {KERNEL_WIDTHS}, got {c}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes bf16 or f32, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{name} kernel takes a non-empty x")
    if k49.shape != (TAPS, c) or k49.dtype != x.dtype:
        raise ValueError(f"{name} kernel wants the [49, C] filter in x's dtype")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype):
        raise ValueError(f"{name}: g must have x's shape and dtype")
    named = [("x", x), ("k49", k49)] + list(vectors) + ([("g", g)] if g is not None else [])
    for vname, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {vname} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name}: {vname} is on {t.device}, x on {x.device}")
    for vname, t in vectors:
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {vname} must be f32 [C]")


def _check(x, k49, bias, ln_scale, ln_bias) -> None:
    _check_args("dw_ln", x, k49, (("bias", bias), ("ln_scale", ln_scale), ("ln_bias", ln_bias)))


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
    ``KERNEL_WIDTHS``, on :func:`stats_geometry`'s tiles; anything else
    raises). CPU tensors take the plain version. ``dw_ln.launches`` counts
    kernel launches.
    """
    if x.device.type == "cpu":
        return dw_ln_reference(x, k49, bias, ln_scale, ln_bias, eps)
    _check(x, k49, bias, ln_scale, ln_bias)
    b, h, w, c = x.shape
    stats_geometry(b, h, w, c, x.dtype)
    out = torch.empty_like(x)
    fn = cuda_build.load("dwconv_ln").svt_dw_ln_forward
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


# csrc/dw_stage.cuh's geometry. The stencil and T take 64-channel slabs; S
# and #2 a PH x 8 tile at full C. SMEM_* are an H100 multiprocessor's shared memory,
# what one CTA may take and what each resident CTA holds back.
_SLAB = 64
_HALO = KERNEL_SIZE // 2
SMEM_A_SM = 233472
SMEM_A_CTA = 232448
SMEM_RESERVED = 1024
_H100_SMS = 132
_MIN_RUN_ROWS = 64  # T's runs at least (or the image): its first 6 x rows spread over them
_TILE_CTAS = 1024  # T's runs grow where runs of 64 rows would start more CTAs than this


def _ctas_an_sm(smem: int) -> int:
    """Resident CTAs a multiprocessor for ``smem`` bytes of dynamic shared
    memory, at most 2 (the kernels' launch bounds)."""
    return min(2, SMEM_A_SM // (smem + SMEM_RESERVED))


def stencil_geometry(b: int, h: int, w: int, c: int, dtype: torch.dtype,
                     sms: int = _H100_SMS) -> dict:
    """The launch geometry of ``csrc/dwconv_bwd.cu``'s ``dw_stencil`` on a
    card of ``sms`` multiprocessors: its tile (rows, cols), tiles a side,
    slabs, units (slab-major tiles), shared memory a CTA and persistent CTAs;
    CTA ``i`` walks units ``[i * units // ctas, (i + 1) * units // ctas)``."""
    item = _ITEM[dtype]
    rows, cols = (16 if item == 2 else 8), 8
    tiles = (-(-h // rows), -(-w // cols))
    slabs = -(-c // _SLAB)
    units = slabs * b * tiles[0] * tiles[1]
    smem = 2 * (rows + 2 * _HALO) * (cols + 2 * _HALO) * _SLAB * item + TAPS * _SLAB * 4
    per_sm = _ctas_an_sm(smem) if item == 2 else 1  # f32: its registers allow one
    return {"tile": (rows, cols), "tiles": tiles, "slabs": slabs, "units": units,
            "smem": smem, "ctas": min(units, per_sm * sms)}


def _stats_bytes(ph: int, c: int, item: int) -> int:
    return ph * 8 * c * 4 + 2 * (ph + 2 * _HALO) * (8 + 2 * _HALO) * _SLAB * item


def stats_geometry(b: int, h: int, w: int, c: int, dtype: torch.dtype) -> dict:
    """The launch geometry of a PH x 8 tile at full C, that of #4's S
    (``csrc/dwconv_bwd.cu``'s ``dw_bwd_stats``) and of #2
    (``csrc/dwconv_ln.cu``'s ``dw_ln_tile``), for a [b, h, w, c] input: the
    tile (PH, 8), PH the largest of 8, 4, 2, 1 that leaves room for two CTAs
    a multiprocessor, else for one; tiles a side, CTAs (one a tile) and
    shared memory. Raises on what the kernels do not take."""
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"the full-C tile kernels are built for C in {KERNEL_WIDTHS}, got {c}")
    if not 0 < b * h * w < 2 ** 31:
        raise ValueError(f"the full-C tile kernels take 1 to 2^31 - 1 tokens, got {b * h * w}")
    item = _ITEM[dtype]
    fits = [ph for ph in (8, 4, 2, 1) if 2 * (_stats_bytes(ph, c, item) + SMEM_RESERVED)
            <= SMEM_A_SM] or [ph for ph in (8, 4, 2, 1) if _stats_bytes(ph, c, item) <= SMEM_A_CTA]
    ph = fits[0]
    tiles = (-(-h // ph), -(-w // 8))
    return {"tile": (ph, 8), "tiles": tiles, "ctas": b * tiles[0] * tiles[1],
            "smem": _stats_bytes(ph, c, item)}


def bwd_geometry(b: int, h: int, w: int, c: int, dtype: torch.dtype) -> dict:
    """The launch geometry of ``csrc/dwconv_bwd.cu``'s backward for a [b, h,
    w, c] input: S's tile, tiles a side, CTAs and shared memory
    (:func:`stats_geometry`); T's strip width, strips, slabs, rows a run, runs
    an image, CTAs and shared memory; ``parts``, the workspace rows colsum
    adds (one a T CTA of each slab). Raises on what the kernels do not take."""
    stats = stats_geometry(b, h, w, c, dtype)
    item = _ITEM[dtype]
    strip = 16 if w <= 16 else 32  # dws::strip_width
    strips, slabs = -(-w // strip), -(-c // _SLAB)
    wanted = max(1, -(-_TILE_CTAS // (b * strips * slabs)))
    rows = max(min(h, _MIN_RUN_ROWS), -(-h // wanted))
    runs = -(-h // rows)
    parts = b * runs * strips
    return {
        "stats_tile": stats["tile"], "stats_tiles": stats["tiles"],
        "stats_ctas": stats["ctas"], "stats_smem": stats["smem"],
        "strip": strip, "strips": strips, "slabs": slabs, "rows_per_run": rows, "runs": runs,
        "tile_ctas": parts * slabs,
        "tile_smem": ((KERNEL_SIZE + 2) * (strip + 2 * _HALO) * _SLAB * item
                      + KERNEL_SIZE * strip * _SLAB * 4 + strip * _SLAB * 4),
        "parts": parts,
    }


def depthwise_conv7x7(x: torch.Tensor, k49: torch.Tensor) -> torch.Tensor:
    """SAME 7x7 depthwise conv of NHWC ``x`` with the ``[49, C]`` filter,
    summed in f32 and returned in x's dtype.

    CUDA tensors launch ``csrc/dwconv_bwd.cu``'s stencil (bf16 or f32, C in
    ``KERNEL_WIDTHS``; anything else raises); CPU tensors take the plain
    version. ``depthwise_conv7x7.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return depthwise_conv7x7_reference(x, k49).to(x.dtype)
    _check_args("depthwise_conv7x7", x, k49)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    fn = cuda_build.load("dwconv_bwd").svt_dwconv7x7
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(
        p(x), p(k49), p(out), ctypes.c_int(_DTYPES[x.dtype]), ctypes.c_int(b),
        ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(c), cuda_build.stream_ptr(x.device),
    )
    cuda_build.check(err, "dwconv7x7")
    depthwise_conv7x7.launches += 1
    return out


depthwise_conv7x7.launches = 0


def bwd_launch(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    g: torch.Tensor,
    eps: float = 1e-6,
) -> dict[str, torch.Tensor]:
    """Launch ``csrc/dwconv_bwd.cu``'s backward (S, T, colsum) on CUDA tensors
    and return its buffers by name: ``da``, ``stats`` ``[B, H, W, 4]``, the
    workspace ``part`` ``[parts, 52 * C]`` and ``sums`` (dk, dbias, dscale,
    dbeta), which the stage tests read. The launch counter is
    :func:`dw_ln_bwd_sums`'s; this counts nothing."""
    _check_args("dw_ln_bwd", x, k49, (("bias", bias), ("ln_scale", ln_scale)), g)
    b, h, w, c = x.shape
    geo = bwd_geometry(b, h, w, c, x.dtype)
    dev, f32 = x.device, torch.float32
    o = {"da": torch.empty_like(x), "stats": torch.empty(b, h, w, 4, dtype=f32, device=dev),
         "part": torch.empty(geo["parts"], _SUMS * c, dtype=f32, device=dev),
         "sums": torch.empty(_SUMS * c, dtype=f32, device=dev)}
    fn = cuda_build.load("dwconv_bwd").svt_dw_ln_bwd
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(
        p(x), p(k49), p(bias), p(ln_scale), p(g), p(o["stats"]), p(o["da"]), p(o["part"]),
        p(o["sums"]), ctypes.c_int(_DTYPES[x.dtype]), ctypes.c_int(b), ctypes.c_int(h),
        ctypes.c_int(w), ctypes.c_int(c), ctypes.c_int(geo["rows_per_run"]),
        ctypes.c_float(eps), cuda_build.stream_ptr(dev),
    )
    cuda_build.check(err, "dw_ln_bwd")
    return o


def dw_ln_bwd_sums(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    g: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, ...]:
    """``(da, dk49, dbias, dscale, dbeta)`` as :func:`dw_ln_bwd_sums_reference`.

    CUDA tensors launch ``csrc/dwconv_bwd.cu``'s backward (bf16 or f32, C in
    ``KERNEL_WIDTHS``; anything else raises); ``dw_ln_bwd_sums.launches``
    counts it. CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return dw_ln_bwd_sums_reference(x, k49, bias, ln_scale, g, eps)
    o = bwd_launch(x, k49, bias, ln_scale, g, eps)
    dw_ln_bwd_sums.launches += 1
    c = x.shape[-1]
    dk, dbias, dscale, dbeta = o["sums"].split((TAPS * c, c, c, c))
    return o["da"], dk.view(TAPS, c), dbias, dscale, dbeta


dw_ln_bwd_sums.launches = 0


def dw_ln_bwd(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    g: torch.Tensor,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, ...]:
    """Backward of :func:`dw_ln` for the output gradient ``g``:
    ``(dx, dk49, dbias, dscale, dbeta)`` as :func:`dw_ln_bwd_reference`.

    CUDA tensors run :func:`dw_ln_bwd_sums` (kernel #4) and then
    :func:`depthwise_conv7x7` (kernel #3) on ``da`` with the flipped filter
    for ``dx``; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return dw_ln_bwd_reference(x, k49, bias, ln_scale, g, eps)
    da, *sums = dw_ln_bwd_sums(x, k49, bias, ln_scale, g, eps)
    return (depthwise_conv7x7(da, k49.flip(0).contiguous()), *sums)


class _DwLn(torch.autograd.Function):
    """:func:`dw_ln` forward, :func:`dw_ln_bwd` backward; saves the primal
    inputs only (the conv is recomputed in the backward)."""

    @staticmethod
    def forward(ctx, x, k49, bias, ln_scale, ln_bias, eps):
        ctx.save_for_backward(x, k49, bias, ln_scale, ln_bias)
        ctx.eps = eps
        return dw_ln(x, k49, bias, ln_scale, ln_bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, k49, bias, ln_scale, ln_bias = ctx.saved_tensors
        dx, dk, dbias, dscale, dbeta = dw_ln_bwd(x, k49, bias, ln_scale, g.contiguous(), ctx.eps)
        return (dx, dk.to(k49.dtype), dbias.to(bias.dtype), dscale.to(ln_scale.dtype),
                dbeta.to(ln_bias.dtype), None)


def depthwise_conv7x7_ln(
    x: torch.Tensor,
    k49: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Differentiable fused ``LayerNorm(dwconv7x7(x) + bias)``: :func:`dw_ln`
    forward and :func:`dw_ln_bwd` backward, gradients in each argument's
    dtype. Without grad it is :func:`dw_ln`."""
    return _DwLn.apply(x, k49, bias, ln_scale, ln_bias, eps)
