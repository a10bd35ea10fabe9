"""The MLP backward's plain stages (ops/fused_mlp.py::bwd_*_reference), the
stages of csrc/ln_mlp_bwd.cuh, on the CPU: their composition is the plain
backward bit for bit, the stage boundaries keep the rounding points, and the
kernels' launch geometry holds for every built width."""

import numpy as np
import pytest
import torch

from spine_vision_torch.ops import fused_mlp as fm


def _inputs(seed, m, c, dtype):
    rng = np.random.default_rng(seed)

    def t(shape, scale, shift=0.0, dt=torch.float32):
        a = rng.normal(size=shape) * scale + shift
        return torch.from_numpy(a.astype(np.float32)).to(dt)

    return {
        "t": t((m, c), 1.0, dt=dtype),
        "ls": t((c,), 0.1, 1.0),
        "lb": t((c,), 0.1),
        "w1t": t((4 * c, c), c ** -0.5, dt=dtype),
        "b1": t((4 * c,), 0.1),
        "w2t": t((c, 4 * c), (4 * c) ** -0.5, dt=dtype),
        "b2": t((c,), 0.1),
        "gamma": t((c,), 0.1, 0.5),
        "g": t((m, c), 1.0, dt=dtype),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ln", [True, False])
def test_stages_compose_to_the_reference_bit_for_bit(dtype, ln):
    v = _inputs(1, 70, 32, dtype)
    c, lp = 32, dtype
    tf, gf = v["t"].float(), v["g"].float()
    ls, lb = (v["ls"], v["lb"]) if ln else (None, None)
    rows = fm.bwd_rows_reference(tf, v["gamma"], gf, lp, ls, lb)
    hid = fm.bwd_hidden_reference(rows["y"], rows["gg"], v["w1t"], v["b1"], v["w2t"], lp)
    g_y = fm.bwd_gy_reference(hid["gh"], v["w1t"])
    dw1t, dw2t, dgamma = fm.bwd_grads_reference(rows["y"], hid["gh"], gf, hid["h"], v["w2t"],
                                                v["b2"], v["gamma"], rows["gsum"], lp)
    if ln:
        dt, dls, dlb = fm.bwd_ln_reference(g_y, rows["yhat"], rows["rstd"], v["ls"])
        composed = (dt.to(lp), dls, dlb, dw1t, hid["db1"], dw2t, rows["db2"], dgamma)
        want = fm.ln_mlp_bwd_reference(v["t"], v["ls"], v["lb"], v["w1t"], v["b1"], v["w2t"],
                                       v["b2"], v["gamma"], v["g"])
    else:
        composed = (g_y.to(lp), dw1t, hid["db1"], dw2t, rows["db2"], dgamma)
        want = fm.mlp_bwd_reference(v["t"], v["w1t"], v["b1"], v["w2t"], v["b2"], v["gamma"],
                                    v["g"])
    assert len(composed) == len(want)
    for i, (a, b) in enumerate(zip(composed, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), i
    assert c == want[0].shape[-1]


def test_stage_boundaries_keep_the_rounding_points():
    """y, g * gamma, h and the hidden gradient leave their stages rounded to
    bf16; db1 sums the unrounded hidden gradient; g_y crosses into the
    LayerNorm backward in f32, and a bf16 g_y there would move dt."""
    v = _inputs(2, 96, 64, torch.bfloat16)
    lp = torch.bfloat16
    gf = v["g"].float()
    rows = fm.bwd_rows_reference(v["t"].float(), v["gamma"], gf, lp, v["ls"], v["lb"])
    hid = fm.bwd_hidden_reference(rows["y"], rows["gg"], v["w1t"], v["b1"], v["w2t"], lp)
    for name, x in (("y", rows["y"]), ("gg", rows["gg"]), ("h", hid["h"]), ("gh", hid["gh"])):
        assert x.dtype == torch.float32, name
        assert torch.equal(x, x.to(lp).float()), name
    assert not torch.equal(hid["db1"], hid["gh"].sum(dim=0))  # from the unrounded gradient
    g_y = fm.bwd_gy_reference(hid["gh"], v["w1t"])
    assert g_y.dtype == torch.float32 and not torch.equal(g_y, g_y.to(lp).float())
    dt, _, _ = fm.bwd_ln_reference(g_y, rows["yhat"], rows["rstd"], v["ls"])
    dt_lp, _, _ = fm.bwd_ln_reference(g_y.to(lp).float(), rows["yhat"], rows["rstd"], v["ls"])
    assert (dt - dt_lp).abs().max().item() > 1e-3 * dt.abs().max().item()
    want = fm.ln_mlp_bwd_reference(v["t"], v["ls"], v["lb"], v["w1t"], v["b1"], v["w2t"],
                                   v["b2"], v["gamma"], v["g"])[0]
    assert torch.equal(dt.to(lp), want)
    assert not torch.equal(dt_lp.to(lp), want)


# Each width's token count on the train step's path (batch 32 at 512^2: the
# stage of that width runs at 128^2, 64^2 or 32^2) and a ragged one.
MAIN_M = {96: 32 * 128 * 128, 128: 32 * 128 * 128, 192: 32 * 64 * 64, 256: 32 * 64 * 64,
          384: 32 * 32 * 32, 512: 32 * 32 * 32}


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("ragged", [False, True])
def test_launch_geometry(c, ragged):
    m = 3 * 13 * 13 if ragged else MAIN_M[c]
    geo = fm.bwd_geometry(m, c)
    h4 = 4 * c
    assert geo["row_tiles"] == -(-m // 64) and geo["part"] == (geo["row_tiles"], 8 * c)
    assert geo["hidden_tiles"] == (-(-m // 128), h4 // 128)
    nb = 2 if c in (256, 512) else 1
    assert geo["gy_tiles"] == (-(-m // 128), -(-c // (128 * nb)))
    assert geo["grad_tiles"] == (h4 // 128, -(-c // 128))
    splits, ks = geo["splits"], geo["ks"]
    assert ks % 64 == 0 and (splits - 1) * ks < m <= splits * ks  # no empty split
    assert geo["ws"] == (splits, h4, c)
    units = geo["grad_tiles"][0] * geo["grad_tiles"][1] * splits
    waves = -(-units // 132)  # of stage D on an H100's 132 multiprocessors
    assert waves <= 4
    if not ragged:
        assert units >= 0.95 * 132 * waves  # the waves are full on the main path
    for stage, maps in geo["maps"].items():
        for name, (rows, cols, box_rows, box_cols, pitch) in maps.items():
            assert box_rows <= 256 and box_cols <= 256, (stage, name)
            assert box_cols * 2 == 128, (stage, name)  # the 128-byte swizzle's span
            assert pitch % 16 == 0 and pitch == 2 * cols, (stage, name)
            assert rows in (m, c, h4) and cols in (c, h4), (stage, name)


def test_shapes_without_a_kernel_raise_before_any_launch():
    """On the CPU a launch would fail to find nvcc; these raise ValueError
    first, from the checks."""
    with pytest.raises(ValueError):
        fm.bwd_geometry(100, 640)
    with pytest.raises(ValueError):
        fm.bwd_geometry(0, 128)
    with pytest.raises(ValueError):
        fm.bwd_geometry(2 ** 31, 128)
    v = _inputs(3, 8, 640, torch.bfloat16)
    with pytest.raises(ValueError):
        fm.bwd_launch(v["t"], v["g"], v["w1t"], v["b1"], v["w2t"], v["b2"], v["gamma"])
    v = _inputs(4, 0, 128, torch.bfloat16)
    with pytest.raises(ValueError):
        fm.bwd_launch(v["t"], v["g"], v["w1t"], v["b1"], v["w2t"], v["b2"], v["gamma"],
                      v["ls"], v["lb"])
