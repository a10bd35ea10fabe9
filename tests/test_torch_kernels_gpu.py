"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (the kernels have no CPU mode) and skip without
one. The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import functools

import numpy as np
import pytest
import torch

from spine_vision_torch.ops import block_train as bt
from spine_vision_torch.ops import convnext_block as cb
from spine_vision_torch.ops import dwconv as dw
from spine_vision_torch.ops import fused_mlp as fm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, scale, dtype, device, shift=0.0):
    a = rng.normal(size=shape) * scale + shift
    return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype).contiguous()


# The kernels of #1 and #5-#10 in both types they are built for. bf16 bounds
# are a few rounding steps, as each test says; f32 has no rounding point, and
# its sums run in another order than the plain version's: 1e-4 of max |plain|,
# the f32 bound of test_dw_ln_kernel_matches_plain.
DTYPES = [torch.bfloat16, torch.float32]
F32_TOL = 1e-4


def _tol(dtype, bf16_tol):
    return F32_TOL if dtype == torch.float32 else bf16_tol


@pytest.mark.parametrize("c", dw.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dw_ln_kernel_matches_plain(cuda, c, dtype):
    rng = np.random.default_rng(c)
    x = _t(rng, (3, 9, 11, c), 1.0, dtype, cuda)  # 297 tokens: ragged last block
    args = (x, _t(rng, (49, c), 0.1, dtype, cuda), _t(rng, (c,), 0.1, torch.float32, cuda),
            _t(rng, (c,), 0.1, torch.float32, cuda, 1.0), _t(rng, (c,), 0.1, torch.float32, cuda))
    before = dw.dw_ln.launches
    got = dw.dw_ln(*args)
    want = dw.dw_ln_reference(*args)
    torch.cuda.synchronize()
    assert dw.dw_ln.launches == before + 1
    # f32: sums in another order; bf16: one rounding step of |y| < 8.
    atol = 1e-4 if dtype == torch.float32 else 6.25e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def _block_args(rng, b, h, w, c, device, dtype=torch.bfloat16):
    f32, lp = torch.float32, dtype
    return (
        _t(rng, (b, h, w, c), 1.0, lp, device),
        _t(rng, (49, c), 0.1, lp, device),
        _t(rng, (c,), 0.1, f32, device),
        _t(rng, (c,), 0.1, f32, device, 1.0),
        _t(rng, (c,), 0.1, f32, device),
        _t(rng, (4 * c, c), c ** -0.5, lp, device),
        _t(rng, (4 * c,), 0.1, f32, device),
        _t(rng, (c, 4 * c), (4 * c) ** -0.5, lp, device),
        _t(rng, (c,), 0.1, f32, device),
        _t(rng, (c,), 0.1, f32, device, 1.0),
    )


@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", [(2, 8, 8), (3, 9, 11)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_block_kernel_matches_plain(cuda, c, b, h, w, dtype):
    args = _block_args(np.random.default_rng(c + h), b, h, w, c, cuda, dtype)
    before = cb.convnext_block.launches, cb.convnext_block.f32_launches
    got = cb.convnext_block(*args)
    want = cb.block_reference(*args)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert (cb.convnext_block.launches, cb.convnext_block.f32_launches) == (
        before[0] + 1, before[1] + f32)
    assert got.dtype == dtype
    # bf16: y and the hidden round to bf16 in both; a flipped rounding moves
    # the output by about one bf16 step of its magnitude: 1e-2 * max |plain|.
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(dtype, 1e-2) * want.float().abs().max().item()


@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", [(2, 8, 8), (3, 9, 11)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_block_kernel_emit_conv_matches_plain(cuda, c, b, h, w, dtype):
    args = _block_args(np.random.default_rng(c + 7 * h), b, h, w, c, cuda, dtype)
    before, before_emit = cb.convnext_block.launches, cb.convnext_block.emit_launches
    before_f32 = cb.convnext_block.emit_f32_launches
    out, t = cb.convnext_block(*args, emit_conv=True)
    want_out, want_t = cb.block_reference(*args, emit_conv=True)
    torch.cuda.synchronize()
    assert cb.convnext_block.launches == before + 1
    assert cb.convnext_block.emit_launches == before_emit + 1
    assert cb.convnext_block.emit_f32_launches == before_f32 + (dtype == torch.float32)
    assert t.dtype == dtype and t.shape == args[0].shape
    # t: the same f32 conv sum in another order, rounded once: one bf16 step.
    tol = _tol(dtype, 1e-2)
    t_err = (t.float() - want_t.float()).abs().max().item()
    assert t_err <= tol * want_t.float().abs().max().item()
    err = (out.float() - want_out.float()).abs().max().item()
    assert err <= tol * want_out.float().abs().max().item()
    # The inference form is unchanged beside it.
    torch.testing.assert_close(cb.convnext_block(*args), cb.block_reference(*args),
                               rtol=0, atol=tol * want_out.float().abs().max().item())


def _bwd_args(rng, b, h, w, c, device, dtype=torch.bfloat16):
    f32, bf16 = torch.float32, dtype
    return (
        _t(rng, (b, h, w, c), 1.0, bf16, device),            # t
        _t(rng, (c,), 0.1, f32, device, 1.0),                # ln_scale
        _t(rng, (c,), 0.1, f32, device),                     # ln_bias
        _t(rng, (4 * c, c), c ** -0.5, bf16, device),        # w1t
        _t(rng, (4 * c,), 0.1, f32, device),                 # b1
        _t(rng, (c, 4 * c), (4 * c) ** -0.5, bf16, device),  # w2t
        _t(rng, (c,), 0.1, f32, device),                     # b2
        _t(rng, (c,), 0.1, f32, device, 0.5),                # gamma
        _t(rng, (b, h, w, c), 1.0, bf16, device),            # g
    )


# The MLP backward's shapes: one whole token tile, then M = 507 (a multiple of
# no product tile, ring stage or token split), 297 and a single row.
MLP_BWD_SHAPES = [(2, 8, 8), (3, 13, 13), (3, 9, 11), (1, 1, 5)]


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", MLP_BWD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_ln_mlp_bwd_kernel_matches_plain(cuda, c, b, h, w, dtype):
    args = _bwd_args(np.random.default_rng(c + h), b, h, w, c, cuda, dtype)
    before = fm.ln_mlp_bwd.launches, fm.ln_mlp_bwd.f32_launches
    got = fm.ln_mlp_bwd(*args)
    again = fm.ln_mlp_bwd(*args)
    want = fm.ln_mlp_bwd_reference(*args)
    torch.cuda.synchronize()
    assert (fm.ln_mlp_bwd.launches, fm.ln_mlp_bwd.f32_launches) == (
        before[0] + 2, before[1] + 2 * (dtype == torch.float32))
    names = ["dt", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma"]
    for name, a, b_, ref in zip(names, got, again, want):
        assert a.dtype == ref.dtype and a.shape == ref.shape, name
        # Every cross-CTA sum has a fixed order: two runs agree bit for bit.
        assert torch.equal(a, b_), name
        # Same rounding points as the plain version; a value on a rounding
        # boundary can round apart, and the f32 sums run in another order:
        # 2e-2 of max |plain| (about three bf16 steps).
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= _tol(dtype, 2e-2) * max(ref.float().abs().max().item(), 1e-6), (name, err)


@pytest.mark.parametrize("c", [128, 512])
def test_ln_mlp_bwd_weight_grads_are_f32_sums(cuda, c):
    """dW1 and dW2 are f32 sums over tokens of bf16 products: against the
    same products summed in f64 from the kernel's own rounded operands."""
    args = _bwd_args(np.random.default_rng(c), 4, 16, 16, c, cuda)
    t, ls, lb, w1t, b1, w2t, b2, gamma, g = args
    _, _, _, dw1t, _, dw2t, _, _ = fm.ln_mlp_bwd(*args)
    yhat, _ = fm.ln_rows(t.reshape(-1, c).float())
    y = (yhat * ls + lb).to(torch.bfloat16).double()
    hpre = y.float() @ w1t.float().t() + b1
    h, dgelu = fm.gelu_and_grad(hpre)
    gf = g.reshape(-1, c).float()
    g_hpre = (((gf * gamma).to(torch.bfloat16).float() @ w2t.float()) * dgelu).to(torch.bfloat16)
    want1 = g_hpre.double().t() @ y
    want2 = (gf.double().t() @ h.to(torch.bfloat16).double()) * gamma.double()[:, None]
    for got, want in ((dw1t, want1), (dw2t, want2)):
        # Operands equal up to rare rounding flips of g_hpre and h; f32
        # accumulation over 1024 tokens: 5e-3 of max |want|.
        err = (got.double() - want).abs().max().item()
        assert err <= 5e-3 * want.abs().max().item()


def _dw_bwd_args(rng, b, h, w, c, dtype, device):
    f32 = torch.float32
    return (
        _t(rng, (b, h, w, c), 1.0, dtype, device),       # x
        _t(rng, (49, c), 0.1, dtype, device),            # k49
        _t(rng, (c,), 0.1, f32, device),                 # bias
        _t(rng, (c,), 0.1, f32, device, 1.0),            # ln_scale
        _t(rng, (b, h, w, c), 1.0, dtype, device),       # g
    )


RAGGED = [(3, 9, 11), (1, 1, 5)]  # a ragged last block of tokens; a single row


@pytest.mark.parametrize("c", dw.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w", RAGGED)
def test_depthwise_conv7x7_kernel_matches_plain(cuda, c, dtype, b, h, w):
    x, k49 = _dw_bwd_args(np.random.default_rng(c + h), b, h, w, c, dtype, cuda)[:2]
    before = dw.depthwise_conv7x7.launches
    got = dw.depthwise_conv7x7(x, k49)
    want = dw.depthwise_conv7x7_reference(x, k49)
    torch.cuda.synchronize()
    assert dw.depthwise_conv7x7.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    # f32: the same sum in another order; bf16: one rounding of it, at most
    # half a bf16 step: 1e-2 * max |plain|.
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-6)


@pytest.mark.parametrize("c", dw.KERNEL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w", RAGGED)
def test_dw_ln_bwd_kernel_matches_plain(cuda, c, dtype, b, h, w):
    args = _dw_bwd_args(np.random.default_rng(c + w), b, h, w, c, dtype, cuda)
    before = dw.dw_ln_bwd_sums.launches, dw.depthwise_conv7x7.launches
    got = dw.dw_ln_bwd(*args)
    again = dw.dw_ln_bwd(*args)
    want = dw.dw_ln_bwd_reference(*args)
    torch.cuda.synchronize()
    assert (dw.dw_ln_bwd_sums.launches, dw.depthwise_conv7x7.launches) == (before[0] + 2, before[1] + 2)
    for name, a, b_, ref in zip(["dx", "dk", "dbias", "dscale", "dbeta"], got, again, want):
        assert a.dtype == ref.dtype and a.shape == ref.shape, name
        # Every cross-CTA sum has a fixed order: two runs agree bit for bit.
        assert torch.equal(a, b_), name
        # f32: sums in another order, 1e-4 of max |plain|. bf16: da rounds
        # at the same point on both sides, but a value on a rounding boundary
        # can round apart and dx sums 49 of them: 2e-2 (three bf16 steps).
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= tol * max(ref.float().abs().max().item(), 1e-6), (name, err)


# The dwconv backward's and the stencil's launches: ragged shapes (a strip
# of 16 columns, a ragged 32-column strip with runs of rows that end early,
# ragged slabs at C = 96, 352 and 2816) in both dtypes, and the train step's
# four shapes in bf16.
DW_STAGE_SHAPES = [(b, h, w, c, dt) for b, h, w, c in ((3, 13, 11, 96), (2, 70, 37, 128),
                                                       (1, 9, 19, 352), (1, 40, 9, 2816))
                   for dt in (torch.bfloat16, torch.float32)] + [
    (32, hw, hw, c, torch.bfloat16) for hw, c in ((128, 128), (64, 256), (32, 512), (16, 1024))]


@pytest.mark.parametrize("stage", ["stats", "tile", "stencil"])
@pytest.mark.parametrize("b,h,w,c,dtype", DW_STAGE_SHAPES)
def test_dw_stage_kernels_match_plain_stages(cuda, stage, b, h, w, c, dtype):
    """Each launch of csrc/dwconv_bwd.cu against its plain stage
    (ops/dwconv.py) fed the kernel's own input to that stage: S's statistics,
    T's da and its workspace rows through colsum, the stencil #3; a second
    call agrees bit for bit."""
    args = _dw_bwd_args(np.random.default_rng(c + h + w), b, h, w, c, dtype, cuda)
    f32 = dtype == torch.float32
    if stage == "stencil":
        got = dw.depthwise_conv7x7(args[0], args[1])
        again = dw.depthwise_conv7x7(args[0], args[1])
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _close("out", got, dw.depthwise_conv7x7_reference(args[0], args[1]),
               1e-5 if f32 else 1e-2)
        return
    o = dw.bwd_launch(*args)
    again = dw.bwd_launch(*args)
    torch.cuda.synchronize()
    for name in o:
        assert torch.equal(o[name], again[name]), name
    geo = dw.bwd_geometry(b, h, w, c, dtype)
    assert o["part"].shape == (geo["parts"], 52 * c)
    if stage == "stats":
        # f32 sums of the same f32 values in another order.
        _close("stats", o["stats"], dw.bwd_stats_reference(*args), 1e-4)
        return
    da, dk, dbias, dscale, dbeta = dw.bwd_tile_reference(*args, o["stats"])
    _close("da", o["da"], da, 1e-4 if f32 else 1e-2)
    sums = o["sums"]
    for name, got, want in (("dk", sums[: 49 * c].view(49, c), dk),
                            ("dbias", sums[49 * c: 50 * c], dbias),
                            ("dscale", sums[50 * c: 51 * c], dscale),
                            ("dbeta", sums[51 * c:], dbeta)):
        _close(name, got, want, 1e-4)
    # colsum: the workspace's rows added in a fixed order.
    _close("colsum", sums, o["part"].double().sum(0), 1e-5)


# #2 and #10's two ends: ragged images (12 x 8 and 7 x 9 with B = 1, a
# ragged last tile and strip, runs that end early, one row), and the train
# step's shapes (#2 also inference's B16 16^2 at C = 1024).
DW_FWD_RAGGED = [(1, 12, 8), (1, 7, 9), (3, 13, 11), (2, 70, 37), (1, 1, 5)]
DW_LN_SHAPES = [(b, h, w, c, dt) for (b, h, w), c in zip(DW_FWD_RAGGED, (96, 352, 1024, 128, 2816))
                for dt in (torch.bfloat16, torch.float32)] + [
    (b, hw, hw, c, dt) for b, hw, c in ((32, 128, 128), (32, 64, 256), (32, 32, 512),
                                         (32, 16, 1024), (16, 16, 1024))
    for dt in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("b,h,w,c,dtype", DW_LN_SHAPES)
def test_dw_ln_tile_matches_plain(cuda, b, h, w, c, dtype):
    """#2 (csrc/dwconv_ln.cu's dw_ln_tile) against its plain version; a
    second call agrees bit for bit."""
    rng = np.random.default_rng(c + h + w)
    f32 = torch.float32
    args = (_t(rng, (b, h, w, c), 1.0, dtype, cuda), _t(rng, (49, c), 0.1, dtype, cuda),
            _t(rng, (c,), 0.1, f32, cuda), _t(rng, (c,), 0.1, f32, cuda, 1.0),
            _t(rng, (c,), 0.1, f32, cuda))
    before = dw.dw_ln.launches
    got = dw.dw_ln(*args)
    again = dw.dw_ln(*args)
    want = dw.dw_ln_reference(*args)
    torch.cuda.synchronize()
    assert dw.dw_ln.launches == before + 2
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.equal(got, again)
    # f32: sums in another order, 1e-4; bf16: y rounds once at the same point
    # on both sides, KERNEL_REL_TOL (1e-2) of max |plain|.
    err = (got.float() - want.float()).abs().max().item()
    if dtype == f32:
        assert err <= 1e-4, err
    else:
        assert err <= 1e-2 * want.float().abs().max().item(), err


BLOCK_END_SHAPES = [(b, h, w, c) for (b, h, w), c in zip(DW_FWD_RAGGED, (128, 96, 192, 384, 512))
                    ] + [(32, 128, 128, 128), (32, 64, 64, 256), (32, 32, 32, 512)]


@pytest.mark.parametrize("stage", ["conv", "taps"])
@pytest.mark.parametrize("b,h,w,c", BLOCK_END_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_block_train_bwd_end_kernels_match_plain_stages(cuda, stage, b, h, w, c, dtype):
    """#10's two ends against their plain stages (ops/block_train.py), each
    fed the kernel's own input: the conv recompute u, and the tap sums of the
    kernel's f32 g_u through the workspace and colsum; a second call agrees
    bit for bit. Both bounds are f32's in either type (the ends sum in f32)."""
    rng = np.random.default_rng(c + 7 * h + w)
    args = _block_args(rng, b, h, w, c, cuda, dtype)
    g = _t(rng, (b, h, w, c), 1.0, dtype, cuda)
    o = bt.bwd_launch(*args, g)
    again = bt.bwd_launch(*args, g)
    torch.cuda.synchronize()
    for name in o:
        assert torch.equal(o[name], again[name]), name
    x = args[0]
    if stage == "conv":
        # f32 sums of the same 49 f32 products and the bias in another order.
        u = bt.conv_bias_reference(x, args[1], args[2])
        _close("u", o["u"].view(x.shape), u, 1e-5)
        return
    geo = bt.tap_geometry(b, h, w, c, dtype)
    assert o["tpart"].shape == (geo["parts"], 50 * c)
    dk, ddwb = bt.tap_sums_reference(x, o["gu32"])
    # f32 sums over every token in another order: 1e-4 of max |plain|.
    _close("dk", o["taps"][: 49 * c].view(49, c), dk, 1e-4)
    _close("ddwb", o["taps"][49 * c:], ddwb, 1e-4)
    # colsum: the workspace's rows added in a fixed order.
    _close("colsum", o["taps"], o["tpart"].double().sum(0), 1e-5)


def _mlp_args(rng, b, h, w, c, device, dtype=torch.bfloat16):
    f32, bf16 = torch.float32, dtype
    return (
        _t(rng, (b, h, w, c), 1.0, bf16, device),            # y
        _t(rng, (4 * c, c), c ** -0.5, bf16, device),        # w1t
        _t(rng, (4 * c,), 0.1, f32, device),                 # b1
        _t(rng, (c, 4 * c), (4 * c) ** -0.5, bf16, device),  # w2t
        _t(rng, (c,), 0.1, f32, device),                     # b2
        _t(rng, (c,), 0.1, f32, device, 0.5),                # gamma
        _t(rng, (b, h, w, c), 1.0, bf16, device),            # g
    )


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", MLP_BWD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_mlp_bwd_kernel_matches_plain(cuda, c, b, h, w, dtype):
    args = _mlp_args(np.random.default_rng(c + 3 * h), b, h, w, c, cuda, dtype)
    before = fm.mlp_bwd.launches, fm.ln_mlp_bwd.launches, fm.mlp_bwd.f32_launches
    got = fm.mlp_bwd(*args)
    again = fm.mlp_bwd(*args)
    want = fm.mlp_bwd_reference(*args)
    torch.cuda.synchronize()
    assert (fm.mlp_bwd.launches, fm.ln_mlp_bwd.launches, fm.mlp_bwd.f32_launches) == (
        before[0] + 2, before[1], before[2] + 2 * (dtype == torch.float32))
    for name, a, b_, ref in zip(["dy", "dw1t", "db1", "dw2t", "db2", "dgamma"], got, again, want):
        assert a.dtype == ref.dtype and a.shape == ref.shape, name
        assert torch.equal(a, b_), name
        # As the LN+MLP backward: 2e-2 of max |plain| (about three bf16 steps).
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= _tol(dtype, 2e-2) * max(ref.float().abs().max().item(), 1e-6), (name, err)


def test_all_kernel_convnext_gives_block_gradients_on_the_card(cuda):
    """A use_pallas=True ConvNeXt on the card in bf16 is differentiable: every
    block parameter (fused blocks at C = 96, 192, 384, dwconv+LN blocks at
    768) gets a finite gradient that is not all zeros."""
    from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS, ConvNeXt

    torch.manual_seed(0)
    model = ConvNeXt(CONVNEXT_CONFIGS["convnext_tiny"], dtype=torch.bfloat16, device=cuda,
                     use_pallas=True)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    proj = torch.randn(2, 768, device=cuda)
    counts = cb.convnext_block.launches, fm.mlp_bwd.launches, dw.dw_ln_bwd_sums.launches
    (model(x).float() * proj).sum().backward()
    torch.cuda.synchronize()
    assert (cb.convnext_block.launches - counts[0], fm.mlp_bwd.launches - counts[1],
            dw.dw_ln_bwd_sums.launches - counts[2]) == (15, 15, 18)
    blocks = [(n, p) for n, p in model.named_parameters() if "_block" in n]
    assert len(blocks) == 18 * 9
    for name, p in blocks:
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max().item() > 0, name


# Whole, ragged and single-row token tiles, and token counts on both sides of
# the products' 128-row tile.
ROW_SHAPES = [(2, 8, 8), (3, 9, 11), (1, 1, 5), (1, 1, 127), (1, 1, 129), (1, 1, 257)]


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", ROW_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_ln_mlp_kernel_matches_plain(cuda, c, b, h, w, dtype):
    x, ls, lb, w1t, b1, w2t, b2, gamma, res = _bwd_args(np.random.default_rng(c + 5 * h), b, h,
                                                         w, c, cuda, dtype)
    args = (x, ls, lb, w1t, b1, w2t, b2, gamma, res)
    before = fm.ln_mlp.launches, fm.ln_mlp.f32_launches
    got = fm.ln_mlp(*args)
    want = fm.ln_mlp_reference(*args)
    torch.cuda.synchronize()
    assert (fm.ln_mlp.launches, fm.ln_mlp.f32_launches) == (
        before[0] + 1, before[1] + (dtype == torch.float32))
    assert got.dtype == dtype and got.shape == x.shape
    # bf16: y and the hidden round to bf16 in both; a flipped rounding moves
    # the output by about one bf16 step of its magnitude: 1e-2 * max |plain|.
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(dtype, 1e-2) * want.float().abs().max().item()
    # Flat [M, C] rows are the same rows.
    flat = fm.ln_mlp(x.reshape(-1, c), ls, lb, w1t, b1, w2t, b2, gamma, res.reshape(-1, c))
    assert torch.equal(flat.reshape(x.shape), got)


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", ROW_SHAPES)
@pytest.mark.parametrize("tail", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_mlp_fwd_kernel_matches_plain(cuda, c, b, h, w, tail, dtype):
    y, w1t, b1, w2t, b2, gamma, res = _mlp_args(np.random.default_rng(c + 11 * h), b, h, w, c,
                                                cuda, dtype)
    kw = {"gamma": gamma, "residual": res} if tail else {}
    before = fm.mlp_fwd.launches, fm.mlp_fwd.f32_launches
    got = fm.mlp_fwd(y, w1t, b1, w2t, b2, **kw)
    want = fm.mlp_reference(y, w1t, b1, w2t, b2, **kw)
    torch.cuda.synchronize()
    assert (fm.mlp_fwd.launches, fm.mlp_fwd.f32_launches) == (
        before[0] + 1, before[1] + (dtype == torch.float32))
    assert got.dtype == dtype and got.shape == y.shape
    # As the LN form: 1e-2 * max |plain| in bf16.
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(dtype, 1e-2) * want.float().abs().max().item()


def test_row_mlp_library_holds_only_the_hopper_launches(cuda):
    """No path falls back to the mma.sync row body: csrc/row_mlp.cu's library
    holds L and the wgmma products of every form at every width, and no
    row_mlp_kernel."""
    from spine_vision_torch.ops import cuda_build
    from spine_vision_torch.probes import build_diff

    cuda_build.load("row_mlp")
    names = build_diff.kernel_names(cuda_build.library_path("row_mlp"))
    assert not [n for n in names if n.startswith("row_mlp_kernel")], names
    assert {f"mlp_ln_rows<{c}>" for c in fm.KERNEL_WIDTHS} <= names
    assert {f"mlp_ln_rows<float, {c}>" for c in fm.KERNEL_WIDTHS} <= names
    for epi in (4, 5, 6):  # F1 (EPI_GELU), F2 with the tail (EPI_OUT) and without (EPI_BIAS)
        assert {f"wg_gemm<1, {nb}, false, {epi}>" for nb in (1, 2)} <= names, epi
        assert f"wg_gemm<float, 1, 1, false, {epi}>" in names, epi  # the f32 forms' products


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", MLP_BWD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_block_train_bwd_kernel_matches_plain(cuda, c, b, h, w, dtype):
    args = _block_args(np.random.default_rng(c + 13 * h), b, h, w, c, cuda, dtype)
    g = _t(np.random.default_rng(c), (b, h, w, c), 1.0, dtype, cuda)
    before = bt.block_train_bwd.launches, bt.block_train_bwd.f32_launches
    got = bt.block_train_bwd(*args, g)
    again = bt.block_train_bwd(*args, g)
    want = bt.block_train_bwd_reference(*args, g)
    torch.cuda.synchronize()
    assert (bt.block_train_bwd.launches, bt.block_train_bwd.f32_launches) == (
        before[0] + 2, before[1] + 2 * (dtype == torch.float32))
    names = ["g_u", "dk", "ddwb", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma"]
    for name, a, b_, ref in zip(names, got, again, want):
        assert a.dtype == ref.dtype and a.shape == ref.shape, name
        # Every cross-CTA sum has a fixed order: two runs agree bit for bit.
        assert torch.equal(a, b_), name
        # As the LN+MLP backward: 2e-2 of max |plain| (about three bf16 steps).
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= _tol(dtype, 2e-2) * max(ref.float().abs().max().item(), 1e-6), (name, err)


@pytest.mark.parametrize("mode,layer_scale,launches", [
    ("block", 1e-6, {"convnext_block": 15, "block_train_bwd": 15, "depthwise_conv7x7": 15}),
    ("mlp", 1e-6, {"ln_mlp": 15, "ln_mlp_bwd": 15}),
    ("mlp", 0.0, {"mlp_fwd": 15, "mlp_bwd": 15}),
])
def test_training_modes_give_block_gradients_on_the_card(cuda, mode, layer_scale, launches):
    """A bf16 convnext_tiny ConvNeXt on the card in the "block" and "mlp"
    modes (and "mlp" without LayerScale, the fused MLP route) launches its
    kernels once a block of C <= 512 in each direction, and every block
    parameter gets a finite gradient that is not all zeros."""
    from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS, ConvNeXt, ConvNeXtConfig

    cfg = CONVNEXT_CONFIGS["convnext_tiny"]
    cfg = ConvNeXtConfig(cfg.depths, cfg.dims, layer_scale_init=layer_scale)
    torch.manual_seed(0)
    model = ConvNeXt(cfg, dtype=torch.bfloat16, device=cuda, use_pallas=mode)
    if layer_scale:  # LayerScale large enough for the MLP's gradients to show
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                torch.nn.init.constant_(p, 0.5)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    proj = torch.randn(2, 768, device=cuda)
    counters = {"convnext_block": cb.convnext_block, "block_train_bwd": bt.block_train_bwd,
                "depthwise_conv7x7": dw.depthwise_conv7x7, "ln_mlp": fm.ln_mlp,
                "ln_mlp_bwd": fm.ln_mlp_bwd, "mlp_fwd": fm.mlp_fwd, "mlp_bwd": fm.mlp_bwd}
    before = {k: f.launches for k, f in counters.items()}
    (model(x).float() * proj).sum().backward()
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in counters.items()} == {
        k: launches.get(k, 0) for k in counters}
    blocks = [(n, p) for n, p in model.named_parameters() if "_block" in n]
    assert len(blocks) == 18 * (9 if layer_scale else 8)
    for name, p in blocks:
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max().item() > 0, name


TRAIN_SHAPES = [(32, 128, 128), (32, 64, 256), (32, 32, 512)]  # (B, H = W, C) of the train step


def _close(name, got, want, tol=2e-2):
    """Within ``tol * max |plain|``: the kernel's f32 sums run in another order
    than the plain stage's, and a value on a bf16 rounding boundary can round
    apart (2e-2 is about three bf16 steps)."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.float().abs().max().item(), 1e-6), (name, err)


@pytest.mark.parametrize("stage,ln", [(s, ln) for s in ("rows", "hidden", "gy", "ln", "grads")
                                      for ln in (True, False)
                                      if s != "ln" or ln])  # L is the LN form's stage only
@pytest.mark.parametrize("b,hw,c", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_mlp_bwd_stage_kernels_match_plain_stages(cuda, stage, ln, b, hw, c, dtype):
    """Each stage kernel of csrc/ln_mlp_bwd.cuh against its plain stage
    (ops/fused_mlp.py::bwd_*_reference) fed the kernel's own inputs to that
    stage, at the train step's shapes, with and without the LayerNorm."""
    rng = np.random.default_rng(c + 17 * ln)
    if ln:
        t, ls, lb, w1t, b1, w2t, b2, gamma, g = _bwd_args(rng, b, hw, hw, c, cuda, dtype)
    else:
        t, w1t, b1, w2t, b2, gamma, g = _mlp_args(rng, b, hw, hw, c, cuda, dtype)
        ls = lb = None
    o = fm.bwd_launch(t, g, w1t, b1, w2t, b2, gamma, ls, lb)
    torch.cuda.synchronize()
    lp = dtype
    close = functools.partial(_close, tol=_tol(dtype, 2e-2))
    gf = g.reshape(-1, c).float()
    small = o["small"]
    rows = fm.bwd_rows_reference(t.reshape(-1, c).float(), gamma, gf, lp, ls, lb)
    y = (o["y"] if ln else t.reshape(-1, c)).float()
    if stage == "rows":
        if ln:
            close("y", o["y"], rows["y"])
            close("rstd", o["stats"][:, 1], rows["rstd"][:, 0])
        close("gg", o["gg"], rows["gg"])
        close("db2", small[6 * c: 7 * c], rows["db2"])
        close("gsum", small[7 * c:], rows["gsum"])
    elif stage == "hidden":
        hid = fm.bwd_hidden_reference(y, o["gg"].float(), w1t, b1, w2t, lp)
        close("h", o["h"], hid["h"])
        close("gh", o["gh"], hid["gh"])
        close("db1", small[: 4 * c], hid["db1"])
    elif stage == "gy":
        g_y = fm.bwd_gy_reference(o["gh"].float(), w1t)
        close("g_y", o["gy"] if ln else o["dt"].reshape(-1, c), g_y)
    elif stage == "ln":
        dt, dls, dlb = fm.bwd_ln_reference(o["gy"], rows["yhat"], rows["rstd"], ls)
        close("dt", o["dt"].reshape(-1, c), dt)
        close("dls", small[4 * c: 5 * c], dls)
        close("dlb", small[5 * c: 6 * c], dlb)
    else:
        dw1t, dw2t, dgamma = fm.bwd_grads_reference(y, o["gh"].float(), gf, o["h"].float(), w2t,
                                                    b2, gamma, small[7 * c:], lp)
        close("dw1t", o["dw1t"], dw1t)
        close("dw2t", o["dw2t"], dw2t)
        close("dgamma", o["dgamma"], dgamma)


# The block forward's stages: every built width at 507 tokens (ragged P tiles
# at the image's right and bottom edges, a ragged last product tile, C = 96
# and 192 ending inside a column tile), and the train step's shapes.
BLOCK_STAGE_SHAPES = [(3, 13, 13, c) for c in cb.KERNEL_WIDTHS] + [
    (b, hw, hw, c) for b, hw, c in TRAIN_SHAPES]


@pytest.mark.parametrize("stage", ["prologue", "hidden", "out"])
@pytest.mark.parametrize("emit_conv", [False, True])
@pytest.mark.parametrize("b,h,w,c", BLOCK_STAGE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_block_stage_kernels_match_plain_stages(cuda, stage, emit_conv, b, h, w, c, dtype):
    """Each launch of csrc/convnext_block.cu (P, F1, F2) against its plain
    stage (ops/convnext_block.py) fed the kernel's own input to that stage, in
    both forms; a second call agrees bit for bit."""
    args = _block_args(np.random.default_rng(c + 3 * h + emit_conv), b, h, w, c, cuda, dtype)
    tol = _tol(dtype, 1e-2)
    o = cb.fwd_launch(*args, emit_conv=emit_conv)
    again = cb.fwd_launch(*args, emit_conv=emit_conv)
    torch.cuda.synchronize()
    for name in o:
        assert torch.equal(o[name], again[name]), name
    if stage == "prologue":
        y, t = cb.prologue_reference(*args[:5], emit_conv=emit_conv)
        _close("y", o["y"], y.reshape(-1, c), tol)
        if emit_conv:
            _close("t", o["t"], t, tol)
        else:
            assert "t" not in o
    elif stage == "hidden":
        _close("h", o["h"], cb.hidden_reference(o["y"], args[5], args[6]), tol)
    else:
        _close("out", o["out"], cb.out_reference(o["h"], args[7], args[8], args[9], args[0]), tol)


# The row forms' launches: every built width at 127, 129 and 507 tokens
# (ragged product tiles; C = 96 and 192 end inside a column tile), and the
# train step's shapes.
ROW_STAGE_SHAPES = [(m, c) for c in fm.KERNEL_WIDTHS for m in (127, 129, 507)] + [
    (b * hw * hw, c) for b, hw, c in TRAIN_SHAPES]


@pytest.mark.parametrize("stage,form", [(s, f) for s in ("ln", "hidden", "out")
                                        for f in ("ln", "tail", "no_tail")
                                        if s != "ln" or f == "ln"])  # L is the LN form's only
@pytest.mark.parametrize("m,c", ROW_STAGE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_row_stage_kernels_match_plain_stages(cuda, stage, form, m, c, dtype):
    """Each launch of csrc/row_mlp.cu (L, F1, F2) against its plain stage
    (ops/fused_mlp.py) fed the kernel's own input to that stage, in the LN
    form (#7) and the copy form with and without the tail (#5); a second
    call agrees bit for bit."""
    x, ls, lb, w1t, b1, w2t, b2, gamma, res = _bwd_args(
        np.random.default_rng(c + m + len(form)), 1, 1, m, c, cuda, dtype)
    tol = _tol(dtype, 1e-2)
    x, res = x.reshape(m, c), res.reshape(m, c)
    kw = {"ln": dict(gamma=gamma, residual=res, ln_scale=ls, ln_bias=lb),
          "tail": dict(gamma=gamma, residual=res), "no_tail": {}}[form]
    o = fm.row_launch(x, w1t, b1, w2t, b2, **kw)
    again = fm.row_launch(x, w1t, b1, w2t, b2, **kw)
    torch.cuda.synchronize()
    assert set(o) == ({"out", "h", "y"} if form == "ln" else {"out", "h"})
    for name in o:
        assert torch.equal(o[name], again[name]), name
    if stage == "ln":
        _close("y", o["y"], fm.ln_rows_reference(x, ls, lb), tol)
    elif stage == "hidden":
        _close("h", o["h"], fm.hidden_reference(o["y"] if form == "ln" else x, w1t, b1), tol)
    elif form == "no_tail":
        _close("out", o["out"], fm.bias_out_reference(o["h"], w2t, b2), tol)
    else:
        _close("out", o["out"], fm.out_reference(o["h"], w2t, b2, gamma, res), tol)


def test_kernels_reject_cpu_layouts_on_the_card(cuda):
    x = torch.zeros(1, 4, 4, 640, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(49, 640, dtype=torch.bfloat16, device=cuda)
    v = torch.zeros(640, device=cuda)
    with pytest.raises(ValueError):
        cb.convnext_block(x, k, v, v, v, torch.zeros(2560, 640, dtype=torch.bfloat16, device=cuda),
                          torch.zeros(2560, device=cuda),
                          torch.zeros(640, 2560, dtype=torch.bfloat16, device=cuda), v, v)
    with pytest.raises(ValueError):
        dw.dw_ln(x[..., :100].contiguous(), k[:, :100].contiguous(), v[:100], v[:100], v[:100])
    args = list(_bwd_args(np.random.default_rng(0), 1, 4, 4, 128, cuda))
    args[0] = args[0].float()
    with pytest.raises(TypeError):
        fm.ln_mlp_bwd(*args)
    margs = list(_mlp_args(np.random.default_rng(1), 1, 4, 4, 128, cuda))
    margs[0] = margs[0].float()
    with pytest.raises(TypeError):
        fm.mlp_bwd(*margs)
    with pytest.raises(ValueError):
        dw.depthwise_conv7x7(x[..., :100].contiguous(), k[:, :100].contiguous())
    bargs = list(_dw_bwd_args(np.random.default_rng(2), 1, 4, 4, 128, torch.bfloat16, cuda))
    with pytest.raises(ValueError):  # g in another dtype than x
        dw.dw_ln_bwd(*bargs[:4], bargs[4].float())
    with pytest.raises(ValueError):  # a channels-first (non-contiguous) g
        dw.dw_ln_bwd(*bargs[:4], bargs[4].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    largs = list(_bwd_args(np.random.default_rng(3), 1, 4, 4, 128, cuda))
    with pytest.raises(TypeError):  # an f32 residual
        fm.ln_mlp(*largs[:8], largs[8].float())
    with pytest.raises(ValueError):  # C = 640 has no kernel
        fm.mlp_fwd(x, torch.zeros(2560, 640, dtype=torch.bfloat16, device=cuda),
                   torch.zeros(2560, device=cuda),
                   torch.zeros(640, 2560, dtype=torch.bfloat16, device=cuda), v)
    targs = _block_args(np.random.default_rng(4), 1, 4, 4, 128, cuda)
    with pytest.raises(TypeError):  # an f32 filter with bf16 x
        bt.block_train_bwd(targs[0], targs[1].float(), *targs[2:], targs[0])
    w1t = torch.zeros(2560, 640, dtype=torch.bfloat16, device=cuda)
    w2t = torch.zeros(640, 2560, dtype=torch.bfloat16, device=cuda)
    b1 = torch.zeros(2560, device=cuda)
    with pytest.raises(ValueError):  # above MAX_FUSED_DIM: no kernel, no plain fallback
        fm.fused_ln_mlp(x, v, v, w1t, b1, w2t, v, v, x)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, w1t, b1, w2t, v, v, x)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, w1t, b1, w2t, v)


# --- the measurement probes (spine_vision_torch/probes) ---------------------


@pytest.mark.parametrize("dtype,shape,vector", [
    (torch.bfloat16, (1000, 128), True), (torch.bfloat16, (1000, 128), False),
    (torch.float32, (300, 512), True), (torch.float32, (300, 512), False),
    (torch.int8, (1024, 256), True), (torch.int8, (1024, 256), False)])
def test_probe_copy_tiled_copies(cuda, dtype, shape, vector):
    from spine_vision_torch.probes import copy_bw as cp

    x = (torch.randn(shape, device=cuda) * 50).clamp(-120, 120).to(dtype)
    before = cp.copy_tiled.launches
    got = cp.copy_tiled(x, 256, vector)  # a ragged last tile at 1000 and 300 rows
    torch.cuda.synchronize()
    assert cp.copy_tiled.launches == before + 1
    assert torch.equal(got, cp.copy_reference(x))


@pytest.mark.parametrize("slots", [2, 3, 4, 8, 12])
def test_probe_copy_staged_copies(cuda, slots):
    from spine_vision_torch.probes import copy_bw as cp

    x = torch.randn(20000, 128, device=cuda).to(torch.bfloat16)  # many tiles a CTA, ragged
    got = cp.copy_staged(x, slots, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, x)


@pytest.mark.parametrize("slots,slot_rows", [(2, 384), (4, 128), (8, 64), (16, 32)])
def test_probe_copy_bulk_copies(cuda, slots, slot_rows):
    from spine_vision_torch.probes import copy_bw as cp

    x = torch.randn(50001, 128, device=cuda).to(torch.bfloat16)
    before = cp.copy_bulk.launches
    got = cp.copy_bulk(x, slots, slot_rows)
    split = cp.copy_bulk_split(x, slots, slot_rows)
    torch.cuda.synchronize()
    assert cp.copy_bulk.launches == before + 3
    assert torch.equal(got, x) and torch.equal(split, x)


@pytest.mark.parametrize("ctas", [None, 1, 3])
def test_probe_read_only_token_is_the_ordered_sum(cuda, ctas):
    from spine_vision_torch.probes import copy_bw as cp

    x = torch.randn(4096, 128, device=cuda).to(torch.bfloat16)
    n = cp.read_only_ctas(x, 32, 8) if ctas is None else ctas
    assert n >= 1
    got = cp.read_only(x, 32, 8, n)
    torch.cuda.synchronize()
    # Each CTA's in-order f32 sums, added in order: the plain version repeats
    # every addition, so the token agrees bit for bit.
    assert torch.equal(got, cp.read_only_reference(x, 32, n))
    folded = x.view(-1, 8, 128).float().sum(0)  # every row r into token row r mod 8
    torch.testing.assert_close(got, folded, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bulk", [True, False])
def test_probe_write_only_broadcasts_the_seed_row(cuda, bulk):
    from spine_vision_torch.probes import copy_bw as cp

    seed = torch.randn(8, 128, device=cuda).to(torch.bfloat16)
    got = cp.write_only(seed, 1000, bulk)  # the last bulk tile is ragged
    torch.cuda.synchronize()
    assert torch.equal(got, cp.write_only_reference(seed, 1000))


def test_probe_inc_copy_forms_add_one(cuda):
    from spine_vision_torch.probes import copy_bw as cp

    a = torch.randn(3000, 128, device=cuda).to(torch.bfloat16)
    b = torch.randn(3000, 128, device=cuda).to(torch.bfloat16)
    before = cp.inc_copy.launches
    outs = [cp.inc_copy(a, b), cp.inc_two_streams(a, b), cp.inc_interleaved(a, b)]
    torch.cuda.synchronize()
    assert cp.inc_copy.launches == before + 5
    for ya, yb in outs:  # f32 sum rounded once, as PyTorch's bf16 x + 1
        assert torch.equal(ya, a + 1) and torch.equal(yb, b + 1)


@pytest.mark.parametrize("body", ["copy", "gelu", "gelu+grad", "tanh_gelu"])
def test_probe_gelu_map_matches_plain(cuda, body):
    from spine_vision_torch import probes
    from spine_vision_torch.probes import gelu_cost as gc

    x = (torch.randn(257, 512, device=cuda) * 3).to(torch.bfloat16)
    before = gc.gelu_map.launches
    got = gc.gelu_map(x, body)
    want = gc.gelu_reference(x, body)
    torch.cuda.synchronize()
    assert gc.gelu_map.launches == before + 1
    # The copy bit for bit; a body in f32 on both sides, rounded once: a last
    # f32 bit apart can carry a bf16 rounding one step, no more.
    probes.max_error(got, want, None if body == "copy" else "ulp")


@pytest.mark.parametrize("c", [128, 256, 512])
@pytest.mark.parametrize("m", [128, 100])
@pytest.mark.parametrize("variant", ["gelu_tanh", "full", "relu", "gelu_bf16", "matmul_only",
                                     "copy"])
def test_probe_mlp_ablate_matches_plain(cuda, c, m, variant):
    from spine_vision_torch.probes import ablate_mlp as am

    a = am.inputs(c, 1, cuda)
    args = [a[k] for k in ("x", "w1t", "b1", "w2t", "b2", "gamma", "res")]
    args[0], args[-1] = args[0][:m].contiguous(), args[-1][:m].contiguous()
    before = am.mlp_ablate.launches
    got = am.mlp_ablate(variant, *args)
    want = am.mlp_ablate_reference(variant, *args)
    torch.cuda.synchronize()
    assert am.mlp_ablate.launches == before + 1
    # As #5: the hidden rounds to bf16 on both sides; 2e-2 * max |plain|.
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    if variant == "gelu_tanh":  # #5's function in the old body, whose sums run in
        five = am.fm.mlp_fwd(args[0], *args[1:6], args[6])  # another order than #5's
        err5 = (got.float() - five.float()).abs().max().item()
        assert err5 <= 2e-2 * five.float().abs().max().item()


def _ocr_pages(files):
    from pathlib import Path

    from spine_vision_torch.data.png import read_png

    root = Path(__file__).resolve().parent / "fixtures" / "torch_ocr"
    return [read_png(root / f, mode="gray") for f in files]


def test_ocr_nets_on_the_card_match_the_cpu(cuda):
    """The OCR nets with the shipped weights, the card against the CPU on
    the same pages and patches: XLA's bf16 rounding points on both, f32 sums
    in another order, so a value now and then lands on the other side of a
    bf16 rounding step and moves what follows it. The maps within 1e-2 (the
    band of threshold ties the record allows), their median gap within 1e-5;
    the logits within 2e-2 of max |logit|, their median within 1e-3 of it:
    at full width the attention spreads each such step over the sequence,
    so the median sits well above f32 rounding, unlike at the CPU tests'
    width 16 (``chip_smoke.py``'s ocr phase prints both gaps)."""
    from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor
    from spine_vision_torch.models.textdet import extract_boxes_from_probmap

    pages = _ocr_pages(["bench_00.png", "bench_05.png", "report_clean.png"])
    card, cpu = DocumentExtractor(device=cuda), DocumentExtractor(device="cpu")
    for group in (pages[:2], pages[2:]):
        got = card.detector.probability_maps(group)
        want = cpu.detector.probability_maps(group)
        gap = np.abs(got - want)
        assert np.median(gap) <= 1e-5 and gap.max() <= 1e-2, (np.median(gap), gap.max())
    quads = [extract_boxes_from_probmap(m) for m in cpu.detector.probability_maps(pages[:2])]
    patches = card.rectify_pages(pages[:2], quads)
    assert patches.device.type == "cuda" and patches.shape[0] == sum(len(q) for q in quads) > 4
    np.testing.assert_allclose(patches.cpu().numpy(),
                               cpu.rectify_pages(pages[:2], quads).numpy(), rtol=0, atol=0.05)
    got = card.recognizer.logits(patches)
    want = cpu.recognizer.logits(patches.cpu())
    gap = np.abs(got - want) / np.abs(want).max()
    assert np.median(gap) <= 1e-3 and gap.max() <= 2e-2, (np.median(gap), gap.max())


@pytest.mark.parametrize("which", ["recognizer", "detector"])
def test_ocr_train_step_on_the_card_matches_the_cpu(cuda, which):
    """One OCR train step on the card against the CPU from the same
    variables and batch (``chip_smoke.py::ocr_grad_check``): in f32
    arithmetic the gradients within 2e-2 of each tensor's norm (median
    1e-3) and the running statistics within 1e-5 of each buffer's; in the
    trained bf16 arithmetic within the gap of the CPU's bf16 step to its f32
    step."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    chip_smoke.ocr_grad_check(cuda, (which,))


def test_middle_slice_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The isotropic middle slice (``io/series.py``: the hat-matrix products
    on the card, TF32 off for the call) against the same call on the CPU, on
    clinical sagittal series (17 slices of 512^2 at 0.59375 mm, 4 mm apart,
    one 5 degree oblique): within 4 f32 ulps of max |slice| (two nonzero
    terms a sum, whose order and fusion cuBLAS and the CPU choose apart),
    with TF32 left on by the caller; and ``study_input_from_paths`` from
    files the same. The fast slice against the whole-volume resample on the
    card within the JAX test's ``rtol=1e-4, atol=1e-2``."""
    from dataclasses import replace

    from spine_vision_torch import io as tio
    from spine_vision_torch.infer.pipeline import study_input_from_paths
    from spine_vision_torch.ops.resample import resample_to_isotropic

    rng = np.random.default_rng(0)
    sagittal = np.array([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    t = np.deg2rad(5.0)
    tilt = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1.0]])
    eps = float(np.finfo(np.float32).eps)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for k, direction in enumerate((sagittal, tilt @ sagittal)):
            vol = rng.normal(800, 200, (17, 512, 512)).clip(0, 4000).astype(np.int16)
            image = tio.MedicalImage(array=vol, spacing=(0.59375, 0.59375, 4.0),
                                     direction=direction)
            got, _ = tio.extract_isotropic_middle_slice(image, device=cuda)
            want, _ = tio.extract_isotropic_middle_slice(image, device="cpu")
            assert got.shape == want.shape == (1013, 1013)
            assert np.abs(got - want).max() <= 4 * eps * np.abs(want).max()
            tio.write_medical_image(image, tmp_path / f"t{k}.nii.gz")
        study = study_input_from_paths(tmp_path / "t0.nii.gz", tmp_path / "t1.nii.gz",
                                       device=cuda)
        cpu = study_input_from_paths(tmp_path / "t0.nii.gz", tmp_path / "t1.nii.gz",
                                     device="cpu")
        for a, b in ((study.t1_slice, cpu.t1_slice), (study.t2_slice, cpu.t2_slice)):
            assert np.abs(a - b).max() <= 4 * eps * np.abs(b).max()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    resampled, new = resample_to_isotropic(image.array, image.spacing_zyx, device=cuda)
    assert resampled.device.type == "cuda" and resampled.shape == (227, 1013, 1013)
    iso = replace(image, array=resampled.cpu().numpy(), spacing=new[::-1])
    np.testing.assert_allclose(got, iso.extract_middle_slice(), rtol=1e-4, atol=1e-2)


def _card_pipeline(cuda, loc_backbone="convnext_tiny", **config):
    """A bf16 study pipeline on the card from seeded Flax-layout trees."""
    from spine_vision_torch.infer.pipeline import StudyInferencePipeline, StudyPipelineConfig
    from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables

    loc = CoordinateRegressor(loc_backbone, dtype=torch.bfloat16, device=cuda)
    cls = Classifier("resnet18", dtype=torch.bfloat16, device=cuda)
    for model, seed in ((loc, 0), (cls, 1)):
        params, stats = random_flax_variables(model, seed)
        load_flax_variables(model, params, stats)
    return StudyInferencePipeline(loc, cls, config=StudyPipelineConfig(**config), device=cuda)


def _study_inputs(seed, n, hw=(640, 640)):
    from spine_vision_torch.infer.pipeline import StudyInput

    rng = np.random.default_rng(seed)
    return [StudyInput(t1_slice=rng.normal(100 + seed, 30, hw).astype(np.float32),
                       t2_slice=rng.normal(90 + seed, 25, hw).astype(np.float32),
                       t1_spacing=(0.3, 0.3), t2_spacing=(0.3, 0.3), study_id=f"t{seed}_{i}")
            for i in range(n)]


def _same_study_results(got, want):
    return all(
        np.array_equal(g.coords, w.coords) and np.array_equal(g.crops, w.crops)
        and all(np.array_equal(g.logits[k], w.logits[k]) for k in w.logits)
        for g, w in zip(got, want, strict=True))


def test_study_pipeline_run_from_two_threads_matches_serial(cuda):
    """Two threads call one pipeline's ``run`` with different studies of one
    shape (so one reused page-locked host buffer): every result equals the
    serial run's bit for bit. Without the run lock, a thread's packing
    overwrites the buffer while the other's upload is still queued."""
    import threading

    pipe = _card_pipeline(cuda)
    batches = [_study_inputs(seed, 8) for seed in (1, 2)]
    serial = [pipe.run(b) for b in batches]
    failures, errors = [], []

    def worker(k):
        try:
            for _ in range(6):
                if not _same_study_results(pipe.run(batches[k]), serial[k]):
                    failures.append(k)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and not failures, (errors, failures)


def test_serve_directory_on_the_card_equals_run(cuda, tmp_path):
    """``serve_directory`` on the card writes, for every request,
    ``run(..., fetch_crops=False)`` of the same files in the same batch."""
    import json

    from spine_vision_torch import io as tio
    from spine_vision_torch.infer import serve
    from spine_vision_torch.infer.pipeline import study_input_from_paths

    pipe = _card_pipeline(cuda)
    rng = np.random.default_rng(5)
    watch, out = tmp_path / "requests", tmp_path / "results"
    watch.mkdir()
    specs = []
    for i in range(3):
        pair = {}
        for series in ("t1", "t2"):
            vol = rng.normal(600, 150, (9, 256, 256)).clip(0, 4000).astype(np.int16)
            pair[series] = str(tmp_path / f"s{i}_{series}.nii.gz")
            tio.write_medical_image(tio.MedicalImage(array=vol, spacing=(0.6, 0.6, 4.0)),
                                    pair[series])
        (watch / f"r{i}.json").write_text(json.dumps({"study_id": f"s{i}", **pair}))
        specs.append(pair)
    stats = serve.serve_directory(pipe, watch, out, once=True)
    assert (stats.processed, stats.failed, stats.batches) == (3, 0, 1)
    studies = [study_input_from_paths(p["t1"], p["t2"], study_id=f"s{i}", device=cuda)
               for i, p in enumerate(specs)]
    for result in pipe.run(studies, fetch_crops=False):
        assert ((out / f"{result.study_id}.json").read_text()
                == json.dumps(serve._result_payload(result), indent=2))


def test_classification_builder_crops_on_the_card_match_the_cpu(cuda, tmp_path):
    """The classification builder at the fallback centres on the card and on
    the CPU: the same files and CSV, the crops within 1 uint8 level on at
    most 1% of the pixels (the CPU tests' tolerance against JAX)."""
    import csv

    from spine_vision_torch import io as tio
    from spine_vision_torch.data import builders
    from spine_vision_torch.data.png import read_png

    rng = np.random.default_rng(6)
    images = tmp_path / "raw" / "SPIDER" / "images"
    images.mkdir(parents=True)
    fields = ["Patient", "IVD label", "Pfirrman grade", "Modic"]
    with open(tmp_path / "raw" / "SPIDER" / "radiological_gradings.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        for pid in (1, 2, 3):
            writer.writerows({"Patient": pid, "IVD label": lvl, "Pfirrman grade": 3, "Modic": 0}
                             for lvl in range(1, 6))
            for s in ("t1", "t2"):
                vol = rng.normal(500, 120, (9, 320, 300)).clip(0, 4000).astype(np.int16)
                tio.write_medical_image(tio.MedicalImage(array=vol, spacing=(0.7, 0.7, 4.0)),
                                        images / f"{pid}_{s}.mha")
    outs = {}
    for dev in ("cpu", cuda):
        config = builders.ClassificationDatasetConfig(
            base_path=tmp_path, output_name=f"cls_{torch.device(dev).type}",
            include_phenikaa=False, device_batch_size=4, padded_hw=(1024, 1024))
        assert builders.create_classification_dataset(config, device=dev).num_samples == 30
        outs[torch.device(dev).type] = config.output_path
    cpu, card = outs["cpu"], outs["cuda"]
    assert (cpu / "annotations.csv").read_bytes() == (card / "annotations.csv").read_bytes()
    names = sorted(p.name for p in (cpu / "images").iterdir())
    assert names == sorted(p.name for p in (card / "images").iterdir()) and len(names) == 30
    for name in names:
        diff = np.abs(read_png(card / "images" / name, "gray").astype(int)
                      - read_png(cpu / "images" / name, "gray").astype(int))
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01, name
