"""The stencils of the whole-block backward #10's two ends and of the
dwconv+LayerNorm forward #2 on the CPU: #10's plain stages
(ops/block_train.py: ``conv_bias_reference``, ``fused_mlp.ln_mlp_bwd_core``,
``tap_sums_reference``) compose to its plain backward bit for bit in both
dtypes, and the launch geometry of #10's conv recompute (the stencil's), of
its tap sums (``tap_geometry``) and of #2 (``dwconv.stats_geometry``) covers
every token once, fits in an H100 multiprocessor's shared memory at the CTAs
a multiprocessor each design claims and gives colsum the workspace rows the
tap sums write, at every built width and dtype."""

import numpy as np
import pytest
import torch
from torch.nn.grad import conv2d_weight

from spine_vision_torch.ops import block_train as bt
from spine_vision_torch.ops import dwconv as dw
from spine_vision_torch.ops import fused_mlp as fm
from test_torch_dwconv_stages import _stats_cover, _stencil_cover


def _t(rng, shape, scale, dtype=torch.float32, shift=0.0):
    a = rng.normal(size=shape) * scale + shift
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def _block_args(seed, b, h, w, c, dtype):
    """x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g."""
    rng = np.random.default_rng(seed)
    return (_t(rng, (b, h, w, c), 1.0, dtype), _t(rng, (49, c), 0.1, dtype), _t(rng, (c,), 0.1),
            _t(rng, (c,), 0.1, shift=1.0), _t(rng, (c,), 0.1),
            _t(rng, (4 * c, c), c ** -0.5, dtype), _t(rng, (4 * c,), 0.1),
            _t(rng, (c, 4 * c), (4 * c) ** -0.5, dtype), _t(rng, (c,), 0.1),
            _t(rng, (c,), 0.1, shift=1.0), _t(rng, (b, h, w, c), 1.0, dtype))


def _one_pass(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g, eps=1e-6):
    """The plain backward in one function, as it read before it was split
    into the kernel's stages."""
    c = x.shape[-1]
    u = dw.depthwise_conv7x7_reference(x, k49) + dw_bias.float()
    g_u, *grads = fm.ln_mlp_bwd_core(u.reshape(-1, c), ln_scale, ln_bias, w1t, b1, w2t, b2,
                                     gamma, g.reshape(-1, c).float(), x.dtype, eps)
    g_u = g_u.reshape(x.shape)
    dk = conv2d_weight(x.float().permute(0, 3, 1, 2), (c, 1, 7, 7), g_u.permute(0, 3, 1, 2),
                       padding=3, groups=c).reshape(c, 49).t()
    return (g_u.to(x.dtype), dk, g_u.sum(dim=(0, 1, 2)), *grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", [(2, 12, 8, 32), (1, 7, 9, 96)])
def test_block_stages_compose_to_the_reference_bit_for_bit(dtype, b, h, w, c):
    args = _block_args(c + h, b, h, w, c, dtype)
    x, k49, dw_bias = args[:3]
    u = bt.conv_bias_reference(x, k49, dw_bias)
    assert u.dtype == torch.float32 and u.shape == x.shape
    g_u, *grads = fm.ln_mlp_bwd_core(u.reshape(-1, c), *args[3:10],
                                     args[10].reshape(-1, c).float(), dtype, 1e-6)
    # The tap sums take the kernel's flat [M, C] g_u as well.
    dk, ddwb = bt.tap_sums_reference(x, g_u)
    staged = (g_u.reshape(x.shape).to(dtype), dk, ddwb, *grads)
    names = ["g_u", "dk", "ddwb", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma"]
    for name, a, r, o in zip(names, staged, bt.block_train_bwd_reference(*args),
                             _one_pass(*args)):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert torch.equal(a, r) and torch.equal(a, o), name
    assert dk.shape == (49, c) and ddwb.dtype == torch.float32


def test_tap_sums_are_the_filter_gradient():
    """dk's tap dy * 7 + dx sums x at (h + dy - 3, w + dx - 3), zero outside
    the image, times g_u at (h, w); ddwb sums g_u."""
    rng = np.random.default_rng(5)
    x, gu = rng.normal(size=(2, 5, 6, 8)), rng.normal(size=(2, 5, 6, 8))
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))
    want = np.stack([(xp[:, dy: dy + 5, dx: dx + 6] * gu).sum((0, 1, 2))
                     for dy in range(7) for dx in range(7)])
    dk, ddwb = bt.tap_sums_reference(torch.from_numpy(x).float(), torch.from_numpy(gu).float())
    np.testing.assert_allclose(dk.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ddwb.numpy(), gu.sum((0, 1, 2)), rtol=1e-5, atol=1e-5)


# The train step's shape of each width (batch 32 at 512^2), ragged images
# (12 x 8 and 7 x 9 with B = 1, a ragged 32-column strip with runs that end
# early) and one row.
MAIN = {96: (32, 128, 128), 128: (32, 128, 128), 192: (32, 64, 64), 256: (32, 64, 64),
        352: (32, 32, 32), 384: (32, 32, 32), 512: (32, 32, 32), 704: (32, 16, 16),
        768: (32, 16, 16), 1024: (32, 16, 16), 1408: (32, 16, 16), 1536: (32, 16, 16),
        2048: (32, 16, 16), 2816: (32, 16, 16)}
RAGGED = [(1, 12, 8), (1, 7, 9), (3, 9, 11), (2, 70, 37), (1, 1, 5)]
DTYPES = [torch.bfloat16, torch.float32]


def _tap_cover(b, h, w, geo):
    """How many tap-sum CTAs sum each token of each slab, and the workspace
    rows they write, decomposing blockIdx as tap_sums does."""
    slabs, strips, runs = geo["slabs"], geo["strips"], geo["runs"]
    rows, strip = geo["rows_per_run"], geo["strip"]
    cover = np.zeros((slabs, b, h, w), np.int64)
    written = np.zeros((geo["parts"], slabs), np.int64)
    for i in range(geo["ctas"]):
        s, p = i % slabs, i // slabs
        st, run, bb = p % strips, (p // strips) % runs, p // (strips * runs)
        written[p, s] += 1
        h0, w0 = run * rows, st * strip
        assert h0 < h and w0 < w  # no CTA without tokens
        cover[s, bb, h0: min(h, h0 + rows), w0: min(w, w0 + strip)] += 1
    return cover, written


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
def test_block_ends_cover_every_token_once(c):
    for b, h, w in [MAIN[c]] + RAGGED:
        # The conv recompute: the stencil's persistent CTAs on bf16 x.
        sgeo = dw.stencil_geometry(b, h, w, c, torch.bfloat16)
        assert (_stencil_cover(b, h, w, sgeo) == 1).all()
        geo = bt.tap_geometry(b, h, w, c)
        assert geo["slabs"] * 64 >= c > (geo["slabs"] - 1) * 64
        cover, written = _tap_cover(b, h, w, geo)
        assert (cover == 1).all()
        # colsum adds svt_block_train_bwd's P rows, each written by one CTA of
        # each slab.
        sw = 16 if w <= 16 else 32
        assert geo["parts"] == b * -(-h // geo["rows_per_run"]) * -(-w // sw)
        assert (written == 1).all()


@pytest.mark.parametrize("c", dw.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dw_ln_covers_every_token_once(c, dtype):
    for b, h, w in [MAIN[c]] + RAGGED:
        geo = dw.stats_geometry(b, h, w, c, dtype)
        cover = _stats_cover(b, h, w, {"stats_tile": geo["tile"], "stats_tiles": geo["tiles"],
                                       "stats_ctas": geo["ctas"]})
        assert (cover == 1).all()
        # #2 runs on #4's S tiles.
        bwd = dw.bwd_geometry(b, h, w, c, dtype)
        assert (bwd["stats_tile"], bwd["stats_ctas"]) == (geo["tile"], geo["ctas"])


@pytest.mark.parametrize("c", dw.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_launch_fits_in_shared_memory(c, dtype):
    item = 2 if dtype == torch.bfloat16 else 4
    # #2: two CTAs a multiprocessor where any tile allows it, else one; a
    # taller tile would not fit as many.
    geo = dw.stats_geometry(*MAIN[c], c, dtype)
    ph = geo["tile"][0]
    two = 2 * (geo["smem"] + dw.SMEM_RESERVED) <= dw.SMEM_A_SM
    assert geo["smem"] <= dw.SMEM_A_CTA
    assert two or item == 4 or c > 2048
    if ph < 8:
        bigger = dw._stats_bytes(2 * ph, c, item)
        assert (2 * (bigger + dw.SMEM_RESERVED) > dw.SMEM_A_SM) if two else (
            bigger > dw.SMEM_A_CTA)
    if c not in fm.KERNEL_WIDTHS or dtype != torch.bfloat16:
        return
    # #10's conv recompute: the bf16 stencil at two CTAs a multiprocessor;
    # its tap sums at TAP_CTAS_AN_SM in both strip widths.
    sgeo = dw.stencil_geometry(*MAIN[c], c, dtype)
    assert 2 * (sgeo["smem"] + dw.SMEM_RESERVED) <= dw.SMEM_A_SM
    for w in (16, 64):
        taps = bt.tap_geometry(1, 4, w, c)
        assert taps["strip"] == (16 if w <= 16 else 32)
        assert bt.TAP_CTAS_AN_SM * (taps["smem"] + dw.SMEM_RESERVED) <= dw.SMEM_A_SM


def test_tap_rings_hold_the_rows_each_row_reads():
    """tap_sums' rings, replayed: x slot j % 9 holds x row h0 - 3 + j, g_u
    slot j % 3 g_u row h0 + j. At output row h, after wait<1> and the
    barrier, the slots hold x rows h - 3 .. h + 3 and g_u row h; row h + 2's
    group, fetched then, writes only slots that row h does not read and that
    row h + 1's group, still in flight, does not write."""
    def group(h0, h1, r):
        """Row r's copies (x row r + 3, g_u row r): (ring, slot, row)."""
        return [] if r >= h1 else [("x", (r - h0 + 6) % 9, r + 3), ("g", (r - h0) % 3, r)]

    for h0, h1 in ((0, 16), (16, 32), (0, 1), (0, 2), (4, 13)):
        slots = {"x": [None] * 9, "g": [None] * 3}
        first = [("x", j, h0 - 3 + j) for j in range(7)] + [("g", 0, h0)]
        pending = [first, group(h0, h1, h0 + 1)]
        for h in range(h0, h1):
            for done in pending[:-1]:  # wait<1>: all but the newest group have landed
                for ring, slot, row in done:
                    slots[ring][slot] = row
            pending = pending[-1:]
            j0 = h - h0
            assert [slots["x"][(j0 + dy) % 9] for dy in range(7)] == [h + dy - 3
                                                                      for dy in range(7)]
            assert slots["g"][j0 % 3] == h
            new = group(h0, h1, h + 2)
            read = {("x", (j0 + dy) % 9) for dy in range(7)} | {("g", j0 % 3)}
            writes = {(ring, slot) for ring, slot, _ in new}
            assert not writes & read
            assert not writes & {(ring, slot) for ring, slot, _ in pending[0]}
            pending.append(new)


def test_tap_runs_and_strips():
    """The tap sums' runs: 16 rows at least (all of a shorter image), longer
    where 16-row runs would start more than about _TAP_CTAS CTAs; strips of
    16 columns at W <= 16."""
    main = {c: bt.tap_geometry(*MAIN[c], c) for c in (128, 256, 512)}
    assert [main[c]["ctas"] for c in main] == [1024, 1024, 512]
    assert [main[c]["rows_per_run"] for c in main] == [32, 16, 16]
    assert all(g["strip"] == 32 for g in main.values())
    assert bt.tap_geometry(1, 12, 8, 128)["strip"] == 16
    assert bt.tap_geometry(1, 12, 8, 128)["rows_per_run"] == 12
    big = bt.tap_geometry(32, 512, 512, 128)  # 1024 CTAs with one run an image
    assert big["rows_per_run"] == 512 and big["ctas"] == 1024


def test_shapes_without_a_kernel_raise_before_any_launch():
    for c in (640, 1024):  # #10 is built for C <= 512
        with pytest.raises(ValueError):
            bt.tap_geometry(1, 4, 4, c)
    with pytest.raises(ValueError):
        bt.tap_geometry(0, 4, 4, 128)
    with pytest.raises(ValueError):
        dw.stats_geometry(1, 4, 4, 640, torch.bfloat16)
    with pytest.raises(ValueError):
        dw.stats_geometry(1, 0, 4, 128, torch.bfloat16)
    args = _block_args(3, 1, 4, 4, 640, torch.bfloat16)
    with pytest.raises(ValueError):
        bt.bwd_launch(*args)
    args = _block_args(3, 1, 4, 4, 128, torch.bfloat16)
    with pytest.raises(TypeError):  # the kernel takes x, g and the weights in one type
        bt.bwd_launch(args[0].float(), *args[1:])
    x = torch.zeros(1, 4, 4, 640)
    with pytest.raises(ValueError):
        dw._check(x, torch.zeros(49, 640), *[torch.zeros(640)] * 3)
