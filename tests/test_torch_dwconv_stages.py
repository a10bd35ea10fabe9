"""The dwconv+LayerNorm backward's plain stages (ops/dwconv.py: S
``bwd_stats_reference``, T ``bwd_tile_reference``), the launches of
csrc/dwconv_bwd.cu, on the CPU: they compose to the plain backward bit for
bit in both dtypes, and the launch geometry of the stencil, S and T covers
every token once, fits in an H100 multiprocessor's shared memory and gives
colsum the workspace rows T writes, for every built width."""

import numpy as np
import pytest
import torch
from torch.nn.grad import conv2d_weight

from spine_vision_torch.ops import dwconv as dw


def _args(seed, b, h, w, c, dtype):
    rng = np.random.default_rng(seed)

    def t(shape, scale, shift=0.0, dt=torch.float32):
        a = rng.normal(size=shape) * scale + shift
        return torch.from_numpy(a.astype(np.float32)).to(dt)

    return (t((b, h, w, c), 1.0, dt=dtype), t((49, c), 0.1, dt=dtype), t((c,), 0.1),
            t((c,), 0.1, 1.0), t((b, h, w, c), 1.0, dt=dtype))


def _one_pass(x, k49, bias, ln_scale, g, eps=1e-6):
    """The backward in one pass, as the plain version read before it was
    split into S and T."""
    c = x.shape[-1]
    a = dw.depthwise_conv7x7_reference(x, k49) + bias.float()
    mu = a.mean(dim=-1, keepdim=True)
    centred = a - mu
    rstd = torch.rsqrt((centred * centred).mean(dim=-1, keepdim=True) + eps)
    yhat = centred * rstd
    gf = g.float()
    dyhat = gf * ln_scale.float()
    da = rstd * (dyhat - dyhat.mean(dim=-1, keepdim=True)
                 - yhat * (dyhat * yhat).mean(dim=-1, keepdim=True))
    dk = conv2d_weight(x.float().permute(0, 3, 1, 2), (c, 1, 7, 7), da.permute(0, 3, 1, 2),
                       padding=3, groups=c).reshape(c, 49).t()
    return (da.to(x.dtype), dk, da.sum(dim=(0, 1, 2)), (gf * yhat).sum(dim=(0, 1, 2)),
            gf.sum(dim=(0, 1, 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", [(2, 9, 11, 32), (1, 5, 19, 96)])
def test_stages_compose_to_the_reference_bit_for_bit(dtype, b, h, w, c):
    args = _args(c + h, b, h, w, c, dtype)
    stats = dw.bwd_stats_reference(*args)
    assert stats.shape == (b, h, w, 4) and stats.dtype == torch.float32
    got = dw.bwd_tile_reference(*args, stats)
    # T takes the kernel's flat [M, 4] statistics buffer as well.
    flat = dw.bwd_tile_reference(*args, stats.reshape(-1, 4))
    for name, a, f, r, o in zip(("da", "dk", "dbias", "dscale", "dbeta"), got, flat,
                                dw.dw_ln_bwd_sums_reference(*args), _one_pass(*args)):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert torch.equal(a, r) and torch.equal(f, r) and torch.equal(a, o), name
    assert got[0].dtype == dtype and got[1].shape == (49, c)


def test_statistics_are_the_layer_norms():
    """S's four numbers: the LayerNorm's mean and rstd of a, and the two
    means the LayerNorm backward needs."""
    x, k49, bias, ls, g = _args(7, 1, 6, 6, 64, torch.float32)
    st = dw.bwd_stats_reference(x, k49, bias, ls, g)
    a = dw.depthwise_conv7x7_reference(x, k49) + bias
    var, mu = torch.var_mean(a, dim=-1, unbiased=False)
    torch.testing.assert_close(st[..., 0], mu, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(st[..., 1], torch.rsqrt(var + 1e-6), rtol=1e-5, atol=0)
    yhat = (a - mu[..., None]) * st[..., 1:2]
    torch.testing.assert_close(st[..., 2], (g * ls).mean(-1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(st[..., 3], (g * ls * yhat).mean(-1), rtol=1e-5, atol=1e-6)


# Each width's shape on the train step's path (batch 32 at 512^2), ragged
# ones (a strip of 16 columns, a ragged 32-column strip, a run that ends early),
# and one row.
MAIN = {96: (32, 128, 128), 128: (32, 128, 128), 192: (32, 64, 64), 256: (32, 64, 64),
        352: (32, 32, 32), 384: (32, 32, 32), 512: (32, 32, 32), 704: (32, 16, 16),
        768: (32, 16, 16), 1024: (32, 16, 16), 1408: (32, 16, 16), 1536: (32, 16, 16),
        2048: (32, 16, 16), 2816: (32, 16, 16)}
RAGGED = [(3, 9, 11), (2, 70, 37), (1, 1, 5)]
DTYPES = [torch.bfloat16, torch.float32]


def _shapes(c):
    return [MAIN[c]] + RAGGED


@pytest.mark.parametrize("c", dw.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_launch_fits_in_shared_memory(c, dtype):
    b, h, w = MAIN[c]
    geo = dw.bwd_geometry(b, h, w, c, dtype)
    sgeo = dw.stencil_geometry(b, h, w, c, dtype)
    for smem in (geo["stats_smem"], geo["tile_smem"], sgeo["smem"]):
        assert smem <= dw.SMEM_A_CTA
    # Shared memory leaves room for two CTAs a multiprocessor of the stencil,
    # and of T (both strips) in bf16.
    for strip_w in (16, 64):
        tile = dw.bwd_geometry(1, 4, strip_w, c, dtype)["tile_smem"]
        assert 2 * (tile + dw.SMEM_RESERVED) <= dw.SMEM_A_SM or dtype == torch.float32
    assert 2 * (sgeo["smem"] + dw.SMEM_RESERVED) <= dw.SMEM_A_SM
    assert sgeo["ctas"] == min(sgeo["units"], (2 if dtype == torch.bfloat16 else 1) * 132)
    # S: two CTAs a multiprocessor where any tile allows it, a taller tile
    # would not fit as many.
    ph = geo["stats_tile"][0]
    two = 2 * (geo["stats_smem"] + dw.SMEM_RESERVED) <= dw.SMEM_A_SM
    if ph < 8:
        taller = dw.bwd_geometry(1, 4, 4, c, dtype)  # the rule depends on C and dtype only
        assert taller["stats_tile"] == geo["stats_tile"]
        bigger = dw._stats_bytes(2 * ph, c, 2 if dtype == torch.bfloat16 else 4)
        assert (2 * (bigger + dw.SMEM_RESERVED) > dw.SMEM_A_SM) if two else (
            bigger > dw.SMEM_A_CTA)


def _stencil_cover(b, h, w, geo):
    """How many units of the persistent stencil's CTAs store each token of
    each slab, decomposing units as dw_stencil does."""
    rows, cols = geo["tile"]
    tiles_h, tiles_w = geo["tiles"]
    cover = np.zeros((geo["slabs"], b, h, w), np.int64)
    units, ctas = geo["units"], geo["ctas"]
    bounds = [i * units // ctas for i in range(ctas + 1)]
    assert bounds[0] == 0 and bounds[-1] == units and all(
        bounds[i + 1] - bounds[i] >= 1 for i in range(ctas))
    u = np.arange(units)
    per_slab = b * tiles_h * tiles_w
    s, r = u // per_slab, u % per_slab
    tw, th, bb = r % tiles_w, (r // tiles_w) % tiles_h, r // (tiles_w * tiles_h)
    for dr in range(rows):
        for dc in range(cols):
            hh, ww = th * rows + dr, tw * cols + dc
            keep = (hh < h) & (ww < w)
            np.add.at(cover, (s[keep], bb[keep], hh[keep], ww[keep]), 1)
    return cover


def _stats_cover(b, h, w, geo):
    ph, pw = geo["stats_tile"]
    tiles_h, tiles_w = geo["stats_tiles"]
    cover = np.zeros((b, h, w), np.int64)
    ids = np.arange(geo["stats_ctas"])
    tw, th, bb = ids % tiles_w, (ids // tiles_w) % tiles_h, ids // (tiles_w * tiles_h)
    for dr in range(ph):
        for dc in range(pw):
            hh, ww = th * ph + dr, tw * pw + dc
            keep = (hh < h) & (ww < w)
            np.add.at(cover, (bb[keep], hh[keep], ww[keep]), 1)
    return cover


def _tile_cover(b, h, w, geo):
    """How many T CTAs finalise each token of each slab, and the workspace
    rows they write, decomposing blockIdx as dw_bwd_tile does."""
    slabs, strips, runs = geo["slabs"], geo["strips"], geo["runs"]
    rows, strip = geo["rows_per_run"], geo["strip"]
    cover = np.zeros((slabs, b, h, w), np.int64)
    written = np.zeros((geo["parts"], slabs), np.int64)
    for i in range(geo["tile_ctas"]):
        s, p = i % slabs, i // slabs
        st, run, bb = p % strips, (p // strips) % runs, p // (strips * runs)
        written[p, s] += 1
        h0, w0 = run * rows, st * strip
        assert h0 < h and w0 < w  # no CTA without tokens
        cover[s, bb, h0: min(h, h0 + rows), w0: min(w, w0 + strip)] += 1
    return cover, written


@pytest.mark.parametrize("c", dw.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_token_is_covered_once(c, dtype):
    for b, h, w in _shapes(c):
        sgeo = dw.stencil_geometry(b, h, w, c, dtype)
        assert sgeo["slabs"] * 64 >= c > (sgeo["slabs"] - 1) * 64
        assert (_stencil_cover(b, h, w, sgeo) == 1).all()
        # A card with fewer multiprocessors walks longer runs of units.
        assert (_stencil_cover(b, h, w, dw.stencil_geometry(b, h, w, c, dtype, sms=7)) == 1).all()
        geo = dw.bwd_geometry(b, h, w, c, dtype)
        assert (_stats_cover(b, h, w, geo) == 1).all()
        cover, written = _tile_cover(b, h, w, geo)
        assert (cover == 1).all()
        # colsum adds `parts` rows, each written by one CTA of each slab.
        assert geo["parts"] == b * geo["runs"] * geo["strips"]
        assert (written == 1).all()


def test_tile_runs_and_strips():
    """T's runs: 64 rows (all of a shorter image), longer where runs of 64
    would start more than about _TILE_CTAS CTAs; strips of 16 columns at
    W <= 16."""
    f = torch.bfloat16
    main = {c: dw.bwd_geometry(*MAIN[c], c, f) for c in (128, 256, 512, 1024)}
    assert [main[c]["tile_ctas"] for c in main] == [512, 256, 256, 512]
    assert [main[c]["rows_per_run"] for c in main] == [64, 64, 32, 16]
    assert main[1024]["strip"] == 16 and main[512]["strip"] == 32
    tall = dw.bwd_geometry(2, 70, 37, 128, f)
    assert tall["rows_per_run"] == 64 and tall["runs"] == 2 and tall["strips"] == 2
    assert dw.bwd_geometry(1, 512, 512, 128, f)["tile_ctas"] == 256  # runs of 64 rows
    big = dw.bwd_geometry(32, 512, 512, 128, f)  # 1024 CTAs with one run an image
    assert big["rows_per_run"] == 512 and big["tile_ctas"] == 1024
    assert dw.bwd_geometry(1, 1, 5, 96, f)["rows_per_run"] == 1


def test_tile_ring_holds_the_rows_each_pass_reads():
    """dw_bwd_tile's ring of 9 x rows, replayed: slot (j0 + dy) % 9 holds x
    row h + dy - 3 in both passes of output row h, and the fetch of row h + 5
    (after the first barrier) overwrites only row h - 4, which no later pass
    reads."""
    for h0, h1 in ((0, 16), (16, 32), (0, 1), (4, 13)):
        slots = [h0 - 3 + j for j in range(8)] + [None]
        for h in range(h0, h1):
            j0 = h - h0
            want = [h + dy - 3 for dy in range(7)]
            assert [slots[(j0 + dy) % 9] for dy in range(7)] == want  # pass 1
            if h + 5 < h1 + 3:
                evicted = slots[(j0 + 8) % 9]
                assert evicted is None or evicted <= h - 4
                slots[(j0 + 8) % 9] = h + 5
            assert [slots[(j0 + dy) % 9] for dy in range(7)] == want  # pass 3


def test_shapes_without_a_kernel_raise_before_any_launch():
    with pytest.raises(ValueError):
        dw.bwd_geometry(1, 4, 4, 640, torch.bfloat16)
    with pytest.raises(ValueError):
        dw.bwd_geometry(0, 4, 4, 128, torch.bfloat16)
    x, k49, bias, ls, g = _args(3, 1, 4, 4, 640, torch.bfloat16)
    with pytest.raises(ValueError):
        dw.bwd_launch(x, k49, bias, ls, g)
