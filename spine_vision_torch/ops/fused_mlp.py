"""ConvNeXt block MLP pieces: the tanh-GELU, the MLP and LN+MLP forwards and
their backwards, and their trainable forms.

Counterpart of ``spine_vision_tpu/ops/fused_mlp.py``. Each wrapper launches a
hand-written kernel on a CUDA tensor and runs its plain PyTorch version
(``*_reference``, with the TPU kernels' rounding points) on a CPU tensor:

- :func:`ln_mlp`, ``res + gamma * (W2 . gelu_tanh(W1 . LN(x) + b1) + b2)``:
  the LN form of ``csrc/row_mlp.cu`` (replaces ``_ln_mlp_pallas``), three
  launches: L the LayerNorm rows, ``y = LN(x)`` in x's dtype
  (:func:`ln_rows_reference`); F1 the hidden product, ``h = gelu_tanh(y .
  W1 + b1)`` (:func:`hidden_reference`); F2 the output product, ``(h . W2 +
  b2) * gamma + res`` (:func:`out_reference`);
- :func:`mlp_fwd`, the same without the LayerNorm, with the tail (gamma and
  the residual) or without it (F2 :func:`bias_out_reference`): the copy form
  of ``csrc/row_mlp.cu``, F1 and F2 on the input rows (replaces
  ``_pallas_mlp``);
- :func:`ln_mlp_bwd`, the backward of :func:`ln_mlp` with respect to ``x``
  and the parameters: ``csrc/ln_mlp_bwd.cu`` (replaces
  ``_ln_mlp_bwd_pallas_resident`` and ``_ln_mlp_bwd_pallas``); it is also the
  hybrid training block's backward from ``t`` (``ops/block_train.py``);
- :func:`mlp_bwd`, the backward of :func:`mlp_fwd` from its input ``y``: the
  LN-less form of the same kernels (replaces ``_mlp_bwd_pallas``; the
  all-kernel block's MLP backward, ``ops/convnext_block.py``).

F1 and F2 are the block forward's products (``csrc/wg_gemm.cuh``'s
``mlp_products``, ``ops/convnext_block.py``); :func:`row_launch` runs the row
forms on the card and returns their intermediates, and :func:`row_geometry`
gives their launch geometry.

Every kernel takes bf16 or f32 (one type for the activations and the
weights; biases, LayerNorm and ``gamma`` f32), as the JAX kernels run in
either: bf16 on wgmma products fed by TMA (``csrc/wg_gemm.cuh``), f32 on
the same core's 3xTF32 path (each operand split into two TF32 parts, three
TF32 wgmma products a K step; products whose tiles would leave SMs idle
split over K by :func:`k_splits`), the rest of each kernel templated on the
type. ``.launches`` counts a wrapper's launches of either type,
``.f32_launches`` those in f32.

Both backwards run in stages, one kernel each: the row prologue, the hidden
products, the g_y product, the LayerNorm backward and the weight-gradient
products. Each stage has its plain version (``bwd_*_reference``), and the
plain backwards are their composition; :func:`bwd_launch` runs them on the
card and returns every intermediate, and :func:`bwd_geometry` gives their
launch geometry.

:func:`fused_ln_mlp` and :func:`fused_mlp` pair them as
``torch.autograd.Function``s that save only the primal inputs (the
counterparts of ``_fused_ln_mlp_ad`` and ``_fused_mlp_ad``). Above
``MAX_FUSED_DIM`` (dispatching on C, the last axis) both run the plain
composition on a CPU tensor, as the JAX functions do, and raise on a CUDA
tensor, which has no kernel there.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from spine_vision_torch.ops import cuda_build
from spine_vision_torch.ops.dwconv import _DTYPES, _ITEM

# Widest block whose MLP runs inside the whole-block kernel; wider blocks run
# the dwconv+LN kernel followed by a plain MLP.
MAX_FUSED_DIM = 512
KERNEL_WIDTHS = (96, 128, 192, 256, 384, 512)  # widths ln_mlp_bwd.cu is built for
LN_EPS = 1e-6  # the LayerNorm epsilon of the fused kernels

_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715
_TOKENS_PER_CTA = 64  # csrc/ln_mlp_bwd.cuh, TOK: a per-tile sums row a 64 tokens
_TILE = 128  # csrc/ln_mlp_bwd.cuh, BM and BN: a product tile's rows, a wgmma's columns
_BK = 64  # csrc/ln_mlp_bwd.cuh, BK: a ring stage's K, and a box's columns
_SMS = 132  # streaming multiprocessors of an H100, one persistent product CTA each
_KSTEP = 64  # csrc/wg_gemm.cuh, BK: an f32 K split holds a multiple of 64 (two f32 ring stages)
_LN_THREADS = 256  # csrc/row_mlp.cu, LN_THREADS: L's CTA, a token row a warp at a time


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


def ln_rows(xf: torch.Tensor, eps: float = LN_EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row LayerNorm statistics over the last axis: ``(yhat, rstd)``."""
    mu = xf.mean(dim=-1, keepdim=True)
    centred = xf - mu
    var = (centred * centred).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return centred * rstd, rstd


def mlp_reference(
    x: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain ``[residual +] [gamma *] (W2 . gelu_tanh(W1 . x + b1) + b2)`` on
    ``[..., C]``: products and the tail in f32, the hidden rounded to x's
    dtype, the output rounded once (``fused_mlp.py::mlp_reference``)."""
    lp = x.dtype
    hidden = tanh_gelu(x.float() @ w1t.float().t() + b1.float()).to(lp)
    out = hidden.float() @ w2t.float().t() + b2.float()
    if gamma is not None:
        out = out * gamma.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(lp)


def ln_rows_reference(
    x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor, eps: float = LN_EPS
) -> torch.Tensor:
    """The plain L on ``[..., C]``: ``LN(x) * ln_scale + ln_bias`` in f32,
    rounded to x's dtype."""
    yhat, _ = ln_rows(x.float(), eps)
    return (yhat * ln_scale.float() + ln_bias.float()).to(x.dtype)


def hidden_reference(y: torch.Tensor, w1t: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The plain F1 on ``[..., C]``: ``gelu_tanh(y . W1 + b1)`` in f32,
    rounded to y's dtype."""
    hidden = torch.matmul(y.float(), w1t.float().t()) + b1.float()
    return tanh_gelu(hidden).to(y.dtype)


def out_reference(
    h: torch.Tensor, w2t: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """The plain F2 on ``[..., 4C]``: ``(h . W2 + b2) * gamma + x`` in f32,
    rounded once to x's dtype, in x's shape (the kernel's [M, 4C] h or an
    NHWC one)."""
    out = torch.matmul(h.float(), w2t.float().t()) + b2.float()
    return (out * gamma.float() + x.float().reshape(out.shape)).to(x.dtype).reshape(x.shape)


def bias_out_reference(h: torch.Tensor, w2t: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The plain F2 without the tail on ``[..., 4C]``: ``h . W2 + b2`` in
    f32, rounded once to h's dtype."""
    return (torch.matmul(h.float(), w2t.float().t()) + b2.float()).to(h.dtype)


def ln_mlp_reference(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    residual: torch.Tensor,
) -> torch.Tensor:
    """Plain ``residual + gamma * mlp(LN(x))``: the plain stages L, F1 and F2
    composed (the LayerNorm in f32 from x, y and the hidden rounded to x's
    dtype, the output rounded once)."""
    y = ln_rows_reference(x, ln_scale, ln_bias)
    return out_reference(hidden_reference(y, w1t, b1), w2t, b2, gamma, residual)


def bwd_rows_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    gf: torch.Tensor,
    lp: torch.dtype,
    ln_scale: torch.Tensor | None = None,
    ln_bias: torch.Tensor | None = None,
    eps: float = LN_EPS,
) -> dict[str, torch.Tensor]:
    """Stage A, the row prologue, from the [M, C] f32 input ``x`` and
    gradient ``gf``: ``y`` (``LN(x)`` rounded to ``lp``, or ``x`` itself
    without ``ln_scale``), ``gg`` (``g * gamma`` rounded to ``lp``), ``db2``
    (the unrounded ``g * gamma`` summed) and ``gsum``; with the LayerNorm also
    ``yhat`` and ``rstd``. Values are f32."""
    out = {}
    if ln_scale is None:
        out["y"] = x
    else:
        yhat, rstd = ln_rows(x, eps)
        y = (yhat * ln_scale.float() + ln_bias.float()).to(lp).float()
        out.update(y=y, yhat=yhat, rstd=rstd)
    g_gamma = gf * gamma.float()
    out.update(gg=g_gamma.to(lp).float(), db2=g_gamma.sum(dim=0), gsum=gf.sum(dim=0))
    return out


def bwd_hidden_reference(
    y: torch.Tensor,
    gg: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    lp: torch.dtype,
) -> dict[str, torch.Tensor]:
    """Stage B, the hidden products: ``h = gelu(y . W1 + b1)`` and the hidden
    gradient ``gh = (gg . W2^T) * gelu'`` from f32 products, both rounded to
    ``lp``, and ``db1``, the unrounded hidden gradient summed."""
    h, dgelu = gelu_and_grad(y @ w1t.float().t() + b1.float())
    g_hpre = (gg @ w2t.float()) * dgelu
    return {"h": h.to(lp).float(), "gh": g_hpre.to(lp).float(), "db1": g_hpre.sum(dim=0)}


def bwd_gy_reference(gh: torch.Tensor, w1t: torch.Tensor) -> torch.Tensor:
    """Stage C: the MLP input's gradient ``g_y = gh . W1^T``, f32."""
    return gh @ w1t.float()


def bwd_ln_reference(
    g_y: torch.Tensor, yhat: torch.Tensor, rstd: torch.Tensor, ln_scale: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage L, the LayerNorm backward from the f32 ``g_y``: ``(dt, dls,
    dlb)``, ``dt`` unrounded."""
    dyhat = g_y * ln_scale.float()
    dt = rstd * (
        dyhat
        - dyhat.mean(dim=-1, keepdim=True)
        - yhat * (dyhat * yhat).mean(dim=-1, keepdim=True)
    )
    return dt, (g_y * yhat).sum(dim=0), g_y.sum(dim=0)


def bwd_grads_reference(
    y: torch.Tensor,
    gh: torch.Tensor,
    gf: torch.Tensor,
    h: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    gsum: torch.Tensor,
    lp: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage D, the weight gradients summed over tokens: ``(dw1t, dw2t,
    dgamma)`` with ``dw1t = gh^T . y``, ``A = g^T . h`` (``g`` rounded to
    ``lp``), ``dw2t = A * gamma`` and ``dgamma = sum W2 * A + gsum * b2``."""
    dw1t = gh.t() @ y
    a_t = gf.to(lp).float().t() @ h  # [C, 4C]
    dw2t = a_t * gamma.float()[:, None]
    dgamma = (w2t.float() * a_t).sum(dim=1) + gsum * b2.float()
    return dw1t, dw2t, dgamma


def _mlp_stages(
    rows: dict[str, torch.Tensor],
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    gf: torch.Tensor,
    lp: torch.dtype,
) -> tuple[torch.Tensor, ...]:
    """Stages B, C and D after stage A's ``rows``: ``(g_y, dw1t, db1, dw2t,
    dgamma)``, all f32, ``g_y`` unrounded."""
    hid = bwd_hidden_reference(rows["y"], rows["gg"], w1t, b1, w2t, lp)
    g_y = bwd_gy_reference(hid["gh"], w1t)
    dw1t, dw2t, dgamma = bwd_grads_reference(rows["y"], hid["gh"], gf, hid["h"], w2t, b2, gamma,
                                             rows["gsum"], lp)
    return g_y, dw1t, hid["db1"], dw2t, dgamma


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
    c = t.shape[-1]
    dt, *grads = ln_mlp_bwd_core(
        t.reshape(-1, c).float(), ln_scale, ln_bias, w1t, b1, w2t, b2, gamma,
        g.reshape(-1, c).float(), t.dtype,
    )
    return (dt.to(t.dtype).reshape(t.shape), *grads)


def ln_mlp_bwd_core(
    tf: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    gf: torch.Tensor,
    lp: torch.dtype,
    eps: float = LN_EPS,
) -> tuple[torch.Tensor, ...]:
    """The LN+MLP backward from the LayerNorm's f32 input ``tf`` and the f32
    gradient ``gf`` ([M, C] each), rounding to ``lp`` as
    :func:`ln_mlp_bwd_reference`: ``(dt, dls, dlb, dw1t, db1, dw2t, db2,
    dgamma)``, all f32, ``dt`` unrounded (the whole-block backward sums it
    unrounded). The composition of the stages A, B, C, L and D."""
    rows = bwd_rows_reference(tf, gamma, gf, lp, ln_scale, ln_bias, eps)
    g_y, dw1t, db1, dw2t, dgamma = _mlp_stages(rows, w1t, b1, w2t, b2, gamma, gf, lp)
    dt, dls, dlb = bwd_ln_reference(g_y, rows["yhat"], rows["rstd"], ln_scale)
    return dt, dls, dlb, dw1t, db1, dw2t, rows["db2"], dgamma


def mlp_bwd_reference(
    y: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Plain MLP + LayerScale backward from the MLP input ``y``:
    :func:`ln_mlp_bwd_reference` without the LayerNorm (stages A, B, C, D),
    with the rounding points of the TPU kernel ``_mlp_bwd_pallas``. Returns
    ``(dy, dw1t, db1, dw2t, db2, dgamma)``: ``dy`` (summed in f32) in ``y``'s
    dtype and shape, the rest f32."""
    c = y.shape[-1]
    gf = g.reshape(-1, c).float()
    rows = bwd_rows_reference(y.reshape(-1, c).float(), gamma, gf, y.dtype)
    g_y, dw1t, db1, dw2t, dgamma = _mlp_stages(rows, w1t, b1, w2t, b2, gamma, gf, y.dtype)
    return (g_y.to(y.dtype).reshape(y.shape), dw1t, db1, dw2t, rows["db2"], dgamma)


def token_splits(m: int, c: int) -> int:
    """Token splits of the weight-gradient products (stage D): the fewest
    whose waves of (output tile, split) units over the card's multiprocessors
    end within 5% of the soonest any split count allows, up to four waves
    and at least 64 tokens (a ring stage) a split."""
    tiles = (4 * c // _TILE) * -(-c // _TILE)
    cap = max(1, min(4 * _SMS // tiles, -(-m // _BK)))
    span = {s: -(-tiles * s // _SMS) / s for s in range(1, cap + 1)}  # waves x tokens a unit
    soonest = min(span.values())
    return min(s for s, v in span.items() if v <= 1.05 * soonest)


def k_splits(tiles: int, k: int) -> tuple[int, int]:
    """The K plan of an f32 product (``csrc/wg_gemm.cuh``'s ``product_f32``)
    with ``tiles`` output tiles of 128 x 128 over depth ``k``: ``(splits,
    ks)``, ``splits`` ranges of ``ks`` (a multiple of 64), each non-empty,
    covering K once. A product of at least a wave of tiles (one a
    multiprocessor) is not split; a smaller one takes ranges of floor(g x
    tiles / 132) (at least one) of the g = ceil(k / 64) ranges of 64, which
    gives it at least min(132, tiles x g) units (tile, range): it fills the
    card where its work allows."""
    granules = -(-k // _KSTEP)
    if tiles >= _SMS:
        return 1, granules * _KSTEP
    per = max(1, granules * tiles // _SMS)
    return -(-granules // per), per * _KSTEP


@functools.lru_cache(maxsize=256)
def _f32_products(m: int, c: int) -> tuple:
    """The f32 plans of the MLP's two K-major products over ``m`` tokens of
    width ``c``: the hidden one (K = C, 4C columns: F1, stage B) and the
    narrow one (K = 4C, C columns: F2, stage C), each ``(tiles, splits,
    ks)`` over 128 x 128 tiles and :func:`k_splits`. Cached: the wrappers
    ask for it on every call."""
    tiles_m = -(-m // _TILE)
    hidden, narrow = (tiles_m, 4 * c // _TILE), (tiles_m, -(-c // _TILE))
    return ((hidden, *k_splits(hidden[0] * hidden[1], c)),
            (narrow, *k_splits(narrow[0] * narrow[1], 4 * c)))


def _plan_arg(geo: dict):
    """The ``plan`` argument of a C entry point: {splits, ks} of the hidden
    product, then of the narrow one (f32; None in bf16)."""
    plan = geo.get("plan")
    return None if plan is None else (ctypes.c_longlong * 4)(*plan)


def bwd_geometry(m: int, c: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch geometry of ``csrc/ln_mlp_bwd.cuh`` for ``m`` tokens of
    width ``c`` in ``dtype``: the row stages' 64-token tiles (``part``'s
    rows), each product's (token or output) x column tiles, stage D's
    ``splits`` of ``ks`` tokens (a multiple of 64, every split non-empty),
    the workspace shapes, the scratch buffers' bytes (``buffers``; y, gg, h
    and gh in ``dtype``, the statistics, g_y and the workspaces f32) and
    every TMA map as ``(rows, cols, box_rows, box_cols, pitch_bytes)`` by
    operand and stage. In f32 the products are 3xTF32 (``csrc/wg_gemm.cuh``,
    128 x 128 tiles, f32 boxes): stages B and C also take a K
    plan (``hidden_splits``/``hidden_ks``, ``gy_splits``/``gy_ks``,
    :func:`k_splits`; ``plan``, the C interface's), and the workspace ``ws``
    then holds the largest of stage D's ``[splits, 4C, C]``, B's partials
    ``[2, splits, m, 4C]`` and C's ``[splits, m, C]`` (``ws_elems``). Raises
    on what the kernels do not take, before anything is launched."""
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"ln_mlp_bwd kernels are built for C in {KERNEL_WIDTHS}, got {c}")
    if not 0 < m < 2 ** 31:
        raise ValueError(f"ln_mlp_bwd kernels take 1 to 2^31 - 1 tokens (TMA coordinates are "
                         f"32-bit), got {m}")
    item = _ITEM[dtype]
    h4 = 4 * c
    # Stage C's wgmma tiles a CTA tile; the f32 tiles are 128 x 128.
    nb = 2 if c % (2 * _TILE) == 0 and item == 2 else 1
    per = -(-m // token_splits(m, c))
    ks = -(-per // _BK) * _BK
    splits = -(-m // ks)
    tiles_m = -(-m // _TILE)
    row_tiles = -(-m // _TOKENS_PER_CTA)
    ws_elems = splits * h4 * c
    plans = {}
    if item == 4:
        (_, hs, hks), (_, gs, gks) = _f32_products(m, c)
        plans = {"hidden_splits": hs, "hidden_ks": hks, "gy_splits": gs, "gy_ks": gks,
                 "plan": (hs, hks, gs, gks)}
        ws_elems = max(ws_elems, 2 * hs * m * h4 if hs > 1 else 0, gs * m * c if gs > 1 else 0)

    # A TMA box: K-major, 128 rows by one 128-byte swizzle row of K (64 bf16,
    # 32 f32); token-major, 64 x 64 in bf16, 32 K rows by 128 in f32.
    def k_major(rows, cols):
        return (rows, cols, _TILE, 128 // item, item * cols)

    def mn_major(rows, cols):
        return (rows, cols, _BK, _BK, 2 * cols) if item == 2 else (rows, cols, 32, _TILE, 4 * cols)

    return {
        "row_tiles": row_tiles,
        "hidden_tiles": (tiles_m, h4 // _TILE),
        "gy_tiles": (tiles_m, -(-c // (nb * _TILE))),
        "grad_tiles": (h4 // _TILE, -(-c // _TILE)),
        "splits": splits,
        "ks": ks,
        **plans,
        "part": (row_tiles, 8 * c),
        "ws": (splits, h4, c),
        "ws_elems": ws_elems,
        "buffers": {"y": m * c * item, "gg": m * c * item, "h": m * h4 * item,
                    "gh": m * h4 * item, "stats": m * 2 * 4, "gy": m * c * 4,
                    "part": row_tiles * 8 * c * 4, "ws": ws_elems * 4},
        "maps": {
            "hidden": {"y": k_major(m, c), "gg": k_major(m, c), "w1t": k_major(h4, c),
                       "w2": k_major(h4, c)},
            "gy": {"gh": k_major(m, h4), "w1": k_major(c, h4)},
            "grads": {"gh": mn_major(m, h4), "y": mn_major(m, c), "g": mn_major(m, c),
                      "h": mn_major(m, h4)},
        },
    }


def product_geometry(m: int, c: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch geometry of F1 and F2 (the block forward's and the row
    forms') for ``m`` tokens of width ``c`` in ``dtype``: each product's
    (row, column) tiles of 128 rows by ``nb`` x 128 columns, its K plan
    (``*_splits`` ranges of ``*_ks``) and its CTAs (persistent, one a
    multiprocessor at most, walking the (tile, range) units), the hidden's
    bytes (``h_bytes``, [m, 4c] in ``dtype``) and the f32 K splits'
    workspace (``ws_elems``, f32 elements; 0 where nothing is split). bf16
    runs ``csrc/wg_gemm.cuh``'s ``mlp_products``, never split; f32 its
    3xTF32 ``mlp_products_f32``, 128 x 128 tiles (``nb`` 1) over
    :func:`k_splits` (``plan``, the C interface's)."""
    item = _ITEM[dtype]
    h4 = 4 * c
    tiles_m = -(-m // _TILE)
    if item == 4:
        (hidden, s1, k1), (out, s2, k2) = _f32_products(m, c)
        nb1 = nb2 = 1
        ws = max(s1 * m * h4 if s1 > 1 else 0, s2 * m * c if s2 > 1 else 0)
        plan = {"plan": (s1, k1, s2, k2)}
    else:
        nb1 = 2 if h4 % (2 * _TILE) == 0 else 1
        nb2 = 2 if c % (2 * _TILE) == 0 else 1
        hidden = (tiles_m, h4 // (nb1 * _TILE))
        out = (tiles_m, -(-c // (nb2 * _TILE)))
        s1, k1, s2, k2, ws, plan = 1, c, 1, h4, 0, {}
    units1, units2 = hidden[0] * hidden[1] * s1, out[0] * out[1] * s2
    return {"hidden_nb": nb1, "hidden_tiles": hidden, "hidden_splits": s1, "hidden_ks": k1,
            "hidden_ctas": min(_SMS, units1),
            "out_nb": nb2, "out_tiles": out, "out_splits": s2, "out_ks": k2,
            "out_ctas": min(_SMS, units2), "h_bytes": m * h4 * item, "ws_elems": ws, **plan}


def row_geometry(m: int, c: int, ln: bool = True, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch geometry of ``csrc/row_mlp.cu`` for ``m`` tokens of width
    ``c`` in ``dtype``: L's tokens a warp (``ln_tpw``, consecutive) and a
    CTA, and its CTAs (0 without the LayerNorm), y's bytes (``y_bytes``, 0
    without it), then F1's and F2's (:func:`product_geometry`). Raises on
    what the kernels do not take, before anything is launched."""
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"row MLP kernels are built for C in {KERNEL_WIDTHS}, got {c}")
    if not 0 <= m < 2 ** 31:
        raise ValueError(f"row MLP kernels take up to 2^31 - 1 tokens (TMA coordinates are "
                         f"32-bit), got {m}")
    tpw = 4 if c <= 256 else 2
    tokens = _LN_THREADS // 32 * tpw
    return {"ln_tpw": tpw, "ln_tokens": tokens, "ln_ctas": -(-m // tokens) if ln else 0,
            "y_bytes": m * c * _ITEM[dtype] if ln else 0, **product_geometry(m, c, dtype)}


def _check(name, t, g, vectors, w1t, w2t, g_name="g") -> None:
    """Raise on what ``name``'s kernel does not take: activations ``t`` and
    ``g`` [..., C] (``g`` may be None) and the weights of one type, bf16 or
    f32 (TypeError otherwise), f32 ``vectors`` (``(name, tensor, length)``
    triples)."""
    c = t.shape[-1]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"{name} kernel is built for C in {KERNEL_WIDTHS}, got {c}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes bf16 or f32 on the card, got {t.dtype}")
    typed = [(n, v) for n, v in ((g_name, g), ("w1t", w1t), ("w2t", w2t)) if v is not None]
    if any(v.dtype != t.dtype for _, v in typed):
        raise TypeError(f"{name} kernel takes its activations and weights in one type, got the "
                        f"input in {t.dtype} and "
                        + ", ".join(f"{n} in {v.dtype}" for n, v in typed))
    shapes = {
        **({} if g is None else {g_name: (g, tuple(t.shape), t.dtype)}),
        "w1t": (w1t, (4 * c, c), t.dtype),
        "w2t": (w2t, (c, 4 * c), t.dtype),
        **{n: (v, (length,), torch.float32) for n, v, length in vectors},
    }
    for vname, (v, shape, dtype) in shapes.items():
        if tuple(v.shape) != shape or v.dtype != dtype:
            raise ValueError(f"{name}: {vname} must be {dtype} {shape}")
    for vname, v in [("input", t)] + [(n, s[0]) for n, s in shapes.items()]:
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"{name}: {vname} must be contiguous and 16-byte aligned")
        if v.device != t.device:
            raise ValueError(f"{name}: {vname} is on {v.device}, the input on {t.device}")


def _buffers(t: torch.Tensor, ln: bool, geo: dict) -> dict[str, torch.Tensor]:
    """Outputs and scratch of a ``csrc/ln_mlp_bwd.cuh`` call for the [..., C]
    activations ``t`` with the geometry ``geo``: the LN form also writes y,
    each token's mean and rstd, and the f32 g_y. y, gg, h and gh are in t's
    dtype; ``ws`` is flat, ``geo["ws_elems"]`` f32 values."""
    c = t.shape[-1]
    m = t.numel() // c
    dev, lp, f32 = t.device, t.dtype, torch.float32
    out = {
        "dt": torch.empty_like(t),
        "small": torch.empty(8 * c, dtype=f32, device=dev),
        "dw1t": torch.empty(4 * c, c, dtype=f32, device=dev),
        "dw2t": torch.empty(c, 4 * c, dtype=f32, device=dev),
        "dgamma": torch.empty(c, dtype=f32, device=dev),
        "gg": torch.empty(m, c, dtype=lp, device=dev),
        "h": torch.empty(m, 4 * c, dtype=lp, device=dev),
        "gh": torch.empty(m, 4 * c, dtype=lp, device=dev),
        "part": torch.empty(geo["part"], dtype=f32, device=dev),
        "ws": torch.empty(geo["ws_elems"], dtype=f32, device=dev),
    }
    if ln:
        out["y"] = torch.empty(m, c, dtype=lp, device=dev)
        out["stats"] = torch.empty(m, 2, dtype=f32, device=dev)
        out["gy"] = torch.empty(m, c, dtype=f32, device=dev)
    return out


def bwd_launch(
    t: torch.Tensor,
    g: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    ln_scale: torch.Tensor | None = None,
    ln_bias: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Launch ``csrc/ln_mlp_bwd.cu``'s stages on CUDA tensors and return its
    buffers by name: the outputs and every intermediate (``gg``, ``h``,
    ``gh``, ``part``, ``ws``; with the LayerNorm ``y``, ``stats``, ``gy``),
    which the stage tests read. With ``ln_scale`` and ``ln_bias`` it is
    :func:`ln_mlp_bwd`'s kernel and ``t`` the LayerNorm's input, without them
    :func:`mlp_bwd`'s and ``t`` the MLP input. The launch counters are the
    wrappers'; this counts nothing."""
    c = t.shape[-1]
    ln = ln_scale is not None
    vectors = (("b1", b1, 4 * c), ("b2", b2, c), ("gamma", gamma, c))
    if ln:
        vectors = (("ln_scale", ln_scale, c), ("ln_bias", ln_bias, c)) + vectors
    name = "ln_mlp_bwd" if ln else "mlp_bwd"
    _check(name, t, g, vectors, w1t, w2t)
    m = t.numel() // c
    geo = bwd_geometry(m, c, t.dtype)
    o = _buffers(t, ln, geo)
    # The kernels read each weight in both layouts.
    o["w1"] = w1t.t().contiguous()
    o["w2"] = w2t.t().contiguous()
    p = cuda_build.ptr
    lib = cuda_build.load("ln_mlp_bwd")
    tail = (ctypes.c_int(_DTYPES[t.dtype]), ctypes.c_longlong(m), ctypes.c_int(c),
            ctypes.c_int(geo["splits"]), ctypes.c_longlong(geo["ks"]), _plan_arg(geo),
            cuda_build.stream_ptr(t.device))
    if ln:
        fn = lib.svt_ln_mlp_bwd
        args = (p(t), p(g), p(ln_scale), p(ln_bias), p(w1t), p(o["w1"]), p(b1), p(w2t),
                p(o["w2"]), p(b2), p(gamma), p(o["dt"]), p(o["small"]), p(o["dw1t"]),
                p(o["dw2t"]), p(o["dgamma"]), p(o["y"]), p(o["gg"]), p(o["stats"]), p(o["h"]),
                p(o["gh"]), p(o["gy"]), p(o["part"]), p(o["ws"]))
    else:
        fn = lib.svt_mlp_bwd
        args = (p(t), p(g), p(w1t), p(o["w1"]), p(b1), p(w2t), p(o["w2"]), p(b2), p(gamma),
                p(o["dt"]), p(o["small"]), p(o["dw1t"]), p(o["dw2t"]), p(o["dgamma"]),
                p(o["gg"]), p(o["h"]), p(o["gh"]), p(o["part"]), p(o["ws"]))
    fn.restype = ctypes.c_int
    cuda_build.check(fn(*args, *tail), name)
    return o


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
    (``t``, ``g`` and the weights bf16 or f32, one type; C in
    ``KERNEL_WIDTHS``; anything else raises); CPU tensors take the plain
    version. ``ln_mlp_bwd.launches`` counts calls that launched the kernels,
    ``ln_mlp_bwd.f32_launches`` those in f32.
    """
    if t.device.type == "cpu":
        return ln_mlp_bwd_reference(t, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g)
    c = t.shape[-1]
    o = bwd_launch(t, g, w1t, b1, w2t, b2, gamma, ln_scale, ln_bias)
    ln_mlp_bwd.launches += 1
    ln_mlp_bwd.f32_launches += t.dtype == torch.float32
    small = o["small"]
    return (o["dt"], small[4 * c: 5 * c], small[5 * c: 6 * c], o["dw1t"], small[: 4 * c],
            o["dw2t"], small[6 * c: 7 * c], o["dgamma"])


ln_mlp_bwd.launches = 0
ln_mlp_bwd.f32_launches = 0


def mlp_bwd(
    y: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Backward of the block's MLP + LayerScale from its input ``y`` and ``g``.

    Returns ``(dy, dw1t, db1, dw2t, db2, dgamma)`` as :func:`mlp_bwd_reference`.
    CUDA tensors launch the LN-less form of ``csrc/ln_mlp_bwd.cu`` (``y``,
    ``g`` and the weights bf16 or f32, one type; C in ``KERNEL_WIDTHS``;
    anything else raises); CPU tensors take the plain version.
    ``mlp_bwd.launches`` counts calls that launched it, ``.f32_launches``
    those in f32.
    """
    if y.device.type == "cpu":
        return mlp_bwd_reference(y, w1t, b1, w2t, b2, gamma, g)
    c = y.shape[-1]
    o = bwd_launch(y, g, w1t, b1, w2t, b2, gamma)
    mlp_bwd.launches += 1
    mlp_bwd.f32_launches += y.dtype == torch.float32
    small = o["small"]
    return (o["dt"], o["dw1t"], small[: 4 * c], o["dw2t"], small[6 * c: 7 * c], o["dgamma"])


mlp_bwd.launches = 0
mlp_bwd.f32_launches = 0


def row_launch(
    x: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    ln_scale: torch.Tensor | None = None,
    ln_bias: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Launch ``csrc/row_mlp.cu`` on CUDA tensors and return its buffers by
    name: ``out``, the scratch ``h`` [M, 4C] and, with the LayerNorm, ``y``
    [M, C], which the stage tests read. With ``ln_scale`` and ``ln_bias`` it
    is :func:`ln_mlp`'s L, F1 and F2 (``gamma`` and ``residual`` given);
    without them :func:`mlp_fwd`'s F1 and F2 on ``x``, with the tail where
    ``residual`` is given (then ``gamma`` too). The launch counters are the
    wrappers'; this counts nothing."""
    c = x.shape[-1]
    ln = ln_scale is not None
    tail = residual is not None
    name = "ln_mlp" if ln else "mlp_fwd"
    vectors = (("b1", b1, 4 * c), ("b2", b2, c)) + ((("gamma", gamma, c),) if tail else ())
    if ln:
        vectors = (("ln_scale", ln_scale, c), ("ln_bias", ln_bias, c)) + vectors
    _check(name, x, residual, vectors, w1t, w2t, g_name="residual")
    m = x.numel() // c
    geo = row_geometry(m, c, ln, x.dtype)
    dev, lp = x.device, x.dtype
    o = {"out": torch.empty_like(x), "h": torch.empty(m, 4 * c, dtype=lp, device=dev)}
    if ln:
        o["y"] = torch.empty(m, c, dtype=lp, device=dev)
    # The f32 K splits' partials: freed on return, reused only by later work
    # on this stream (PyTorch's caching allocator), so after the kernels.
    ws = torch.empty(geo["ws_elems"], dtype=torch.float32, device=dev) \
        if geo["ws_elems"] else None
    lib = cuda_build.load("row_mlp")
    p = cuda_build.ptr
    none = ctypes.c_void_p(None)
    weights = (p(w1t), p(b1), p(w2t), p(b2), p(gamma) if tail else none)
    rows = (p(residual) if tail else none,)
    split = (none if ws is None else p(ws), _plan_arg(geo), ctypes.c_int(_DTYPES[x.dtype]))
    if ln:
        fn = lib.svt_ln_mlp_forward
        args = (p(x), *rows, p(ln_scale), p(ln_bias), *weights, p(o["out"]), p(o["y"]),
                p(o["h"]), *split, ctypes.c_longlong(m), ctypes.c_int(c), ctypes.c_float(LN_EPS))
    else:
        fn = lib.svt_mlp_forward
        args = (p(x), *rows, *weights, p(o["out"]), p(o["h"]), *split, ctypes.c_longlong(m),
                ctypes.c_int(c))
    fn.restype = ctypes.c_int
    cuda_build.check(fn(*args, cuda_build.stream_ptr(dev)), name)
    return o


def ln_mlp(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    residual: torch.Tensor,
) -> torch.Tensor:
    """``residual + gamma * (W2 . gelu_tanh(W1 . LN(x) + b1) + b2)`` on
    ``[..., C]`` (NHWC or flat), as :func:`ln_mlp_reference`.

    CUDA tensors launch the LN form of ``csrc/row_mlp.cu`` (L, F1, F2; ``x``,
    ``residual`` and the weights bf16 or f32, one type; C in
    ``KERNEL_WIDTHS``; anything else raises); CPU tensors take the plain
    version. ``ln_mlp.launches`` counts calls that launched the kernels,
    ``.f32_launches`` those in f32.
    """
    if x.device.type == "cpu":
        return ln_mlp_reference(x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, residual)
    out = row_launch(x, w1t, b1, w2t, b2, gamma, residual, ln_scale, ln_bias)["out"]
    ln_mlp.launches += 1
    ln_mlp.f32_launches += x.dtype == torch.float32
    return out


ln_mlp.launches = 0
ln_mlp.f32_launches = 0


def mlp_fwd(
    x: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """The block MLP on ``[..., C]``: with ``gamma`` or ``residual`` the tail
    form ``residual + gamma * mlp(x)`` (gamma defaults to ones, the residual
    to zeros), without both ``mlp(x)`` alone; as :func:`mlp_reference`.

    CUDA tensors launch the copy form of ``csrc/row_mlp.cu`` (F1, F2; ``x``,
    ``residual`` and the weights bf16 or f32, one type; C in
    ``KERNEL_WIDTHS``; anything else raises); CPU tensors take the plain
    version. ``mlp_fwd.launches`` counts calls that launched the kernels,
    ``.f32_launches`` those in f32.
    """
    c = x.shape[-1]
    if gamma is not None or residual is not None:
        if gamma is None:
            gamma = torch.ones(c, dtype=torch.float32, device=x.device)
        if residual is None:
            residual = torch.zeros_like(x)
    if x.device.type == "cpu":
        return mlp_reference(x, w1t, b1, w2t, b2, gamma, residual)
    out = row_launch(x, w1t, b1, w2t, b2, gamma, residual)["out"]
    mlp_fwd.launches += 1
    mlp_fwd.f32_launches += x.dtype == torch.float32
    return out


mlp_fwd.launches = 0
mlp_fwd.f32_launches = 0


def _wider_than_kernels(name: str, x: torch.Tensor) -> bool:
    """True where ``x``'s C exceeds ``MAX_FUSED_DIM`` on the CPU, where the
    caller runs its plain composition; raises for such a CUDA tensor."""
    if x.shape[-1] <= MAX_FUSED_DIM:
        return False
    if x.device.type != "cpu":
        raise ValueError(
            f"{name}: C={x.shape[-1]} exceeds MAX_FUSED_DIM={MAX_FUSED_DIM}; such "
            "blocks run a plain MLP"
        )
    return True


class _FusedLnMlp(torch.autograd.Function):
    """:func:`ln_mlp` forward, :func:`ln_mlp_bwd` from ``x`` backward; the
    residual's gradient is ``g``. Saves the primal inputs only."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, residual):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma)
        ctx.residual_dtype = residual.dtype
        return ln_mlp(x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, residual)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma = ctx.saved_tensors
        g = g.contiguous()
        dx, dls, dlb, dw1t, db1, dw2t, db2, dgamma = ln_mlp_bwd(
            x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g
        )
        return (dx, dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype), dw1t.to(w1t.dtype),
                db1.to(b1.dtype), dw2t.to(w2t.dtype), db2.to(b2.dtype), dgamma.to(gamma.dtype),
                g.to(ctx.residual_dtype))


def fused_ln_mlp(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor,
    residual: torch.Tensor,
) -> torch.Tensor:
    """Trainable ``residual + gamma * mlp(LN(x))`` on ``[..., C]``: kernel #7
    forward, the LN+MLP backward kernel (#8/#9) from ``x`` backward,
    gradients in each argument's dtype. Above ``MAX_FUSED_DIM`` the plain
    composition (differentiated by autograd) on a CPU tensor; a CUDA tensor
    raises."""
    if _wider_than_kernels("fused_ln_mlp", x):
        return ln_mlp_reference(x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, residual)
    return _FusedLnMlp.apply(x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, residual)


class _FusedMlp(torch.autograd.Function):
    """:func:`mlp_fwd` forward, :func:`mlp_bwd` backward (with ones for a
    missing ``gamma``, whose gradient is then dropped); the residual's
    gradient is ``g``. Saves the primal inputs only."""

    @staticmethod
    def forward(ctx, x, w1t, b1, w2t, b2, gamma, residual):
        ctx.save_for_backward(x, w1t, b1, w2t, b2, gamma)
        ctx.residual_dtype = None if residual is None else residual.dtype
        return mlp_fwd(x, w1t, b1, w2t, b2, gamma, residual)

    @staticmethod
    def backward(ctx, g):
        x, w1t, b1, w2t, b2, gamma = ctx.saved_tensors
        g = g.contiguous()
        scale = gamma if gamma is not None else torch.ones(
            x.shape[-1], dtype=torch.float32, device=x.device)
        dx, dw1t, db1, dw2t, db2, dgamma = mlp_bwd(x, w1t, b1, w2t, b2, scale, g)
        return (dx, dw1t.to(w1t.dtype), db1.to(b1.dtype), dw2t.to(w2t.dtype), db2.to(b2.dtype),
                None if gamma is None else dgamma.to(gamma.dtype),
                None if ctx.residual_dtype is None else g.to(ctx.residual_dtype))


def fused_mlp(
    x: torch.Tensor,
    w1t: torch.Tensor,
    b1: torch.Tensor,
    w2t: torch.Tensor,
    b2: torch.Tensor,
    gamma: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """Trainable block MLP on ``[..., C]``, forms as :func:`mlp_fwd`: kernel
    #5 forward, the MLP backward kernel (#6) backward, gradients in each
    argument's dtype. Above ``MAX_FUSED_DIM`` the plain composition
    (differentiated by autograd) on a CPU tensor; a CUDA tensor raises."""
    if _wider_than_kernels("fused_mlp", x):
        return mlp_reference(x, w1t, b1, w2t, b2, gamma, residual)
    return _FusedMlp.apply(x, w1t, b1, w2t, b2, gamma, residual)
