"""The row MLP forwards' plain stages (ops/fused_mlp.py: L
``ln_rows_reference``, F1 ``hidden_reference``, F2 ``out_reference`` or,
without the tail, ``bias_out_reference``), the launches of csrc/row_mlp.cu,
on the CPU: their composition is the plain #7 (``ln_mlp_reference``) and
the plain #5 (``mlp_reference``, both tail forms) bit for bit, and the
kernels' launch geometry covers every token once for every built width."""

import numpy as np
import pytest
import torch

from spine_vision_torch.ops import fused_mlp as fm


def _args(seed, shape, c, dtype):
    """``(x, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, residual)``: rows of
    ``shape + (c,)`` in ``dtype``, the vectors f32."""
    rng = np.random.default_rng(seed)

    def t(s, scale, shift=0.0, dt=torch.float32):
        a = rng.normal(size=s) * scale + shift
        return torch.from_numpy(a.astype(np.float32)).to(dt)

    rows = (*shape, c)
    return (t(rows, 1.0, dt=dtype), t((c,), 0.1, 1.0), t((c,), 0.1),
            t((4 * c, c), c ** -0.5, dt=dtype), t((4 * c,), 0.1),
            t((c, 4 * c), (4 * c) ** -0.5, dt=dtype), t((c,), 0.1), t((c,), 0.1, 1.0),
            t(rows, 1.0, dt=dtype))


SHAPES = {"nhwc": (2, 5, 7), "flat": (37,)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ln_stages_compose_to_the_reference_bit_for_bit(dtype, shape):
    args = _args(1, SHAPES[shape], 64, dtype)
    x, ls, lb, w1t, b1, w2t, b2, gamma, res = args
    y = fm.ln_rows_reference(x, ls, lb)
    h = fm.hidden_reference(y, w1t, b1)
    out = fm.out_reference(h, w2t, b2, gamma, res)
    assert y.dtype == h.dtype == out.dtype == dtype
    assert y.shape == out.shape == x.shape and h.shape == (*x.shape[:-1], 4 * 64)
    want = fm.ln_mlp_reference(*args)
    if dtype == torch.bfloat16:
        assert torch.equal(out, want)
    else:
        # The f32 products are MKL sgemm calls, which promise no bit-for-bit
        # repeat between calls: the first ones in a process, under load, may
        # sum in another order. So f32 holds the worst-case first-order gap
        # of two summation orders of the longest (4C-term) dot product,
        # 4C * eps32 of the output's magnitude.
        tol = 4 * 64 * torch.finfo(torch.float32).eps * want.abs().max().item()
        torch.testing.assert_close(out, want, rtol=0, atol=tol)
    # L's y is the LayerNorm of the f32 rows, rounded once.
    mu = x.float().mean(-1, keepdim=True)
    var = ((x.float() - mu) ** 2).mean(-1, keepdim=True)
    want_y = ((x.float() - mu) * torch.rsqrt(var + fm.LN_EPS) * ls + lb).to(dtype)
    assert torch.equal(y, want_y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("form", ["tail", "residual_only", "no_tail"])
def test_copy_stages_compose_to_the_reference_bit_for_bit(dtype, shape, form):
    x, _, _, w1t, b1, w2t, b2, gamma, res = _args(2, SHAPES[shape], 64, dtype)
    h = fm.hidden_reference(x, w1t, b1)
    if form == "no_tail":
        out = fm.bias_out_reference(h, w2t, b2)
        want = fm.mlp_reference(x, w1t, b1, w2t, b2)
        got = fm.mlp_fwd(x, w1t, b1, w2t, b2)
    else:
        # mlp_fwd's defaults: gamma ones when only the residual is given.
        g = gamma if form == "tail" else torch.ones_like(gamma)
        out = fm.out_reference(h, w2t, b2, g, res)
        want = fm.mlp_reference(x, w1t, b1, w2t, b2, g, res)
        got = fm.mlp_fwd(x, w1t, b1, w2t, b2, **({"gamma": gamma} if form == "tail" else {}),
                         residual=res)
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, want)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ln", [True, False])
def test_flat_rows_are_the_same_function(ln):
    """The kernels hand F1 and F2 flat [M, C] and [M, 4C] rows: the same
    function, the products' sums in another order at most."""
    args = _args(3, (2, 6, 6), 96, torch.bfloat16)
    x, ls, lb, w1t, b1, w2t, b2, gamma, res = args
    y = fm.ln_rows_reference(x, ls, lb) if ln else x
    h = fm.hidden_reference(y.reshape(-1, 96), w1t, b1)
    assert h.shape == (72, 384)
    flat = fm.out_reference(h, w2t, b2, gamma, res)
    want = fm.ln_mlp_reference(*args) if ln else fm.mlp_reference(x, w1t, b1, w2t, b2, gamma, res)
    assert flat.shape == x.shape
    torch.testing.assert_close(flat.float(), want.float(), rtol=0,
                               atol=1e-2 * want.float().abs().max().item())


# Tokens of each width on the main paths (the "mlp" step, batch 32 at 512^2;
# #5's gradient check, batch 2 at 128^2) and ragged counts on both sides of
# the 128-row product tile.
MAIN_M = {96: 32 * 128 * 128, 128: 32 * 128 * 128, 192: 32 * 64 * 64, 256: 32 * 64 * 64,
          384: 32 * 32 * 32, 512: 32 * 32 * 32}
GRAD_M = {96: 2 * 32 * 32, 128: 2 * 32 * 32, 192: 2 * 16 * 16, 256: 2 * 16 * 16,
          384: 2 * 8 * 8, 512: 2 * 8 * 8}
RAGGED_M = (1, 127, 129, 257, 507)
LN_WARPS = 8  # csrc/row_mlp.cu: LN_THREADS / 32


def _ln_cover(m, geo):
    """How many times L stores each token, decomposing (blockIdx, warp, i)
    as mlp_ln_rows does."""
    cta, warp, i = np.meshgrid(np.arange(geo["ln_ctas"]), np.arange(LN_WARPS),
                               np.arange(geo["ln_tpw"]), indexing="ij")
    tok = (cta * geo["ln_tokens"] + warp * geo["ln_tpw"] + i).ravel()
    return np.bincount(tok[tok < m], minlength=m)


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("which", ["main", "grad", *RAGGED_M])
def test_launch_geometry(c, which):
    m = {"main": MAIN_M[c], "grad": GRAD_M[c]}.get(which, which)
    geo = fm.row_geometry(m, c)
    assert geo["ln_tpw"] == (4 if c <= 256 else 2)
    assert geo["ln_tokens"] == LN_WARPS * geo["ln_tpw"]
    assert (_ln_cover(m, geo) == 1).all()  # every token LayerNormed once
    assert (geo["ln_ctas"] - 1) * geo["ln_tokens"] < m <= geo["ln_ctas"] * geo["ln_tokens"]
    assert fm.row_geometry(m, c, ln=False)["ln_ctas"] == 0  # the copy form has no L
    # F1: 128-row tiles by nb x 128 columns over [M, 4C], columns exactly.
    tm, tn = geo["hidden_tiles"]
    assert (tm - 1) * 128 < m <= tm * 128
    assert tn * geo["hidden_nb"] * 128 == 4 * c
    assert geo["hidden_nb"] == (1 if c == 96 else 2)
    # F2: over [M, C]; C = 96 and 192 end inside a tile, whose epilogue masks them.
    tm2, tn2 = geo["out_tiles"]
    span = geo["out_nb"] * 128
    assert tm2 == tm and (tn2 - 1) * span < c <= tn2 * span
    assert geo["out_nb"] == (2 if c in (256, 512) else 1)
    for name in ("hidden", "out"):  # one persistent CTA a multiprocessor at most
        units = geo[f"{name}_tiles"][0] * geo[f"{name}_tiles"][1]
        assert geo[f"{name}_ctas"] == min(132, units)
    if m <= 4096:  # each output element in one unit's tile, enumerated
        for tiles, nb, width in ((geo["hidden_tiles"], geo["hidden_nb"], 4 * c),
                                 (geo["out_tiles"], geo["out_nb"], c)):
            cover = np.zeros((m, width), np.int64)
            for u in range(tiles[0] * tiles[1]):
                t_m, t_n = u // tiles[1], u % tiles[1]
                cover[t_m * 128: (t_m + 1) * 128, t_n * nb * 128: (t_n + 1) * nb * 128] += 1
            assert (cover == 1).all()


def test_shapes_without_a_kernel_raise_before_any_launch():
    """On the CPU a launch would fail to find nvcc; these raise ValueError
    first, from the checks."""
    with pytest.raises(ValueError):
        fm.row_geometry(4, 640)
    with pytest.raises(ValueError):
        fm.row_geometry(2 ** 31, 128)
    with pytest.raises(ValueError):
        fm.row_geometry(-1, 128)
    assert fm.row_geometry(0, 128)["ln_ctas"] == 0
    x, ls, lb, w1t, b1, w2t, b2, gamma, res = _args(4, (3,), 640, torch.bfloat16)
    with pytest.raises(ValueError):
        fm.row_launch(x, w1t, b1, w2t, b2, gamma, res, ls, lb)
    with pytest.raises(ValueError):  # a residual of another shape
        fm.row_launch(x[..., :128].contiguous(), w1t[:512, :128].contiguous(), b1[:512],
                      w2t[:128, :512].contiguous(), b2[:128], gamma[:128],
                      res[:2, :128].contiguous())
