"""The f32 forms of the ConvNeXt kernels (#1, #5-#10), as far as the CPU can
hold them: each launch wrapper's argument check takes an all-f32 set and
refuses a mixed one before any build or launch, and the launch geometry
reports the f32 buffers and shared memory. The kernels themselves run on
the card (``tests/test_torch_kernels_gpu.py``, the ``f32`` cases); their
plain versions are held to the JAX package in f32 by
``tests/test_torch_convnext_block.py`` and the train-step tests.
"""

import numpy as np
import pytest
import torch

from spine_vision_torch.ops import block_train as bt
from spine_vision_torch.ops import convnext_block as cb
from spine_vision_torch.ops import fused_mlp as fm
from spine_vision_torch.ops.dwconv import SMEM_A_CTA

F32, BF16 = torch.float32, torch.bfloat16
C = 128


def _t(rng, shape, dtype=F32, shift=0.0):
    return torch.from_numpy((rng.normal(size=shape) * 0.1 + shift).astype(np.float32)).to(dtype)


def _block(dtype, seed=0):
    """x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, g: x, the
    filter, the weights and g in ``dtype``, the vectors f32."""
    rng = np.random.default_rng(seed)
    return [_t(rng, (1, 4, 4, C), dtype), _t(rng, (49, C), dtype), _t(rng, (C,)),
            _t(rng, (C,), shift=1.0), _t(rng, (C,)), _t(rng, (4 * C, C), dtype),
            _t(rng, (4 * C,)), _t(rng, (C, 4 * C), dtype), _t(rng, (C,)),
            _t(rng, (C,), shift=1.0), _t(rng, (1, 4, 4, C), dtype)]


def _mixes():
    """(name, argument list): bf16 x with f32 weights, f32 x with bf16
    weights, an f32 filter with bf16 x and the rest bf16."""
    f32, bf16 = _block(F32), _block(BF16)
    x_bf16 = [bf16[0]] + f32[1:-1] + [bf16[-1]]
    x_f32 = [f32[0]] + bf16[1:-1] + [f32[-1]]
    k_f32 = [bf16[0], f32[1]] + bf16[2:]
    return [("bf16 x, f32 weights", x_bf16), ("f32 x, bf16 weights", x_f32),
            ("f32 filter, bf16 x", k_f32)]


def _checks(args):
    """Each wrapper's check on the block's argument set: #1, #7 and #8/#9
    (with the LayerNorm), #5 and #6 (without it), #10."""
    x, k49, dw_bias, ls, lb, w1t, b1, w2t, b2, gamma, g = args
    vec = (("b1", b1, 4 * C), ("b2", b2, C), ("gamma", gamma, C))
    lnv = (("ln_scale", ls, C), ("ln_bias", lb, C)) + vec
    return {
        "convnext_block": lambda: cb._check(x, k49, dw_bias, ls, lb, w1t, b1, w2t, b2, gamma),
        "ln_mlp": lambda: fm._check("ln_mlp", x, g, lnv, w1t, w2t, g_name="residual"),
        "ln_mlp_bwd": lambda: fm._check("ln_mlp_bwd", x, g, lnv, w1t, w2t),
        "mlp_fwd": lambda: fm._check("mlp_fwd", x, g, vec, w1t, w2t, g_name="residual"),
        "mlp_bwd": lambda: fm._check("mlp_bwd", x, g, vec, w1t, w2t),
        "block_train_bwd": lambda: bt._check(*args),
    }


@pytest.mark.parametrize("name", ["convnext_block", "ln_mlp", "ln_mlp_bwd", "mlp_fwd", "mlp_bwd",
                                  "block_train_bwd"])
def test_checks_take_f32_and_refuse_mixed_types(name):
    for dtype in (F32, BF16):
        _checks(_block(dtype))[name]()  # one type throughout: no raise
    for what, args in _mixes():
        if what.startswith("f32 filter") and name not in ("convnext_block", "block_train_bwd"):
            continue  # the row forms and the MLP backward take no filter
        with pytest.raises(TypeError):
            _checks(args)[name]()
    with pytest.raises(TypeError):  # a type no kernel is built for
        _checks([a.half() if a.dim() != 1 else a for a in _block(F32)])[name]()


def test_mixed_types_raise_before_a_build_on_the_cpu():
    """The launches check first: on the CPU (no nvcc) a mixed set raises
    TypeError, not the build's error."""
    for _, args in _mixes():
        with pytest.raises(TypeError):
            cb.fwd_launch(*args[:10])
        with pytest.raises(TypeError):
            bt.bwd_launch(*args)


@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
def test_f32_prologue_fits_in_shared_memory(c):
    """P's f32 halo doubles its ring: under the 227 KB a CTA may take at every
    width (one CTA a multiprocessor where bf16 fits two, but at C = 256)."""
    bf16, f32 = (cb.forward_geometry(32, 32, 32, c, d) for d in (BF16, F32))
    rows = bf16["tile"][0]
    halo = (rows + 6) * 14 * 64
    assert f32["tile"] == bf16["tile"]
    assert f32["prologue_smem"] == bf16["prologue_smem"] + 2 * halo * 2
    assert f32["prologue_smem"] <= SMEM_A_CTA == 227 * 1024
    assert bf16["prologue_ctas_an_sm"] == 2
    assert f32["prologue_ctas_an_sm"] == (2 if c == 256 else 1)
    assert cb.forward_geometry(32, 32, 32, c)["prologue_smem"] == bf16["prologue_smem"]


def test_f32_geometry_reports_the_f32_buffers():
    m, c = 507, 192
    for dtype, item in ((BF16, 2), (F32, 4)):
        prod = fm.product_geometry(m, c, dtype)
        assert prod["h_bytes"] == m * 4 * c * item
        row = fm.row_geometry(m, c, True, dtype)
        assert row["y_bytes"] == m * c * item and row["h_bytes"] == m * 4 * c * item
        assert fm.row_geometry(m, c, False, dtype)["y_bytes"] == 0
        bwd = fm.bwd_geometry(m, c, dtype)
        # ws: stage D's [splits, 4C, C]; in f32 also stage B's two planes of K
        # split partials [2, 3, m, 4C] (24 tiles over 3 ranges of 64) and
        # stage C's [12, m, C] (8 tiles over 12), the largest of the three.
        ws = bwd["splits"] * 4 * c * c if item == 2 else max(
            bwd["splits"] * 4 * c * c, 2 * 3 * m * 4 * c, 12 * m * c)
        assert bwd["ws_elems"] == ws
        assert bwd["buffers"] == {
            "y": m * c * item, "gg": m * c * item, "h": m * 4 * c * item,
            "gh": m * 4 * c * item, "stats": m * 8, "gy": m * c * 4,
            "part": bwd["part"][0] * 8 * c * 4, "ws": ws * 4}
    # The f32 core (3xTF32 wgmma): 128 x 128 tiles (nb 1), split over K where
    # the tiles leave multiprocessors idle (32 and 8 tiles here: 4 and 16
    # ranges of 64, 128 units each), f32 TMA maps.
    prod = fm.product_geometry(m, 256, F32)
    assert (prod["hidden_nb"], prod["out_nb"]) == (1, 1)
    assert prod["hidden_tiles"] == (4, 8) and prod["hidden_ctas"] == 128
    assert (prod["hidden_splits"], prod["hidden_ks"]) == (4, 64)
    assert prod["out_tiles"] == (4, 2) and prod["out_ctas"] == 128
    assert (prod["out_splits"], prod["out_ks"]) == (16, 64)
    assert prod["ws_elems"] == max(4 * m * 4 * 256, 16 * m * 256)
    assert fm.product_geometry(m, 256)["out_nb"] == 2  # bf16 as it was, never split
    assert fm.product_geometry(m, 256)["out_splits"] == 1
    f32 = fm.bwd_geometry(m, 256, F32)
    assert f32["gy_tiles"] == (4, 2) and f32["plan"] == (4, 64, 16, 64)
    assert f32["maps"]["hidden"]["y"] == (m, 256, 128, 32, 4 * 256)  # K-major f32 boxes
    assert f32["maps"]["grads"]["h"] == (m, 1024, 32, 128, 4 * 1024)  # token-major ones
    assert fm.bwd_geometry(m, 256)["gy_tiles"] == (4, 1) and fm.bwd_geometry(m, 256)["maps"]
    assert "plan" not in fm.bwd_geometry(m, 256)  # bf16 takes no K plan
    # #10's tap sums: the x ring in f32.
    bf16, f32 = (bt.tap_geometry(2, 16, 40, c, d) for d in (BF16, F32))
    assert f32["smem"] - bf16["smem"] == 9 * (bf16["strip"] + 6) * 64 * 2
