"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (the kernels have no CPU mode) and skip without
one. The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

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


@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", [(2, 8, 8), (3, 9, 11)])
def test_block_kernel_matches_plain(cuda, c, b, h, w):
    rng = np.random.default_rng(c + h)
    f32, bf16 = torch.float32, torch.bfloat16
    args = (
        _t(rng, (b, h, w, c), 1.0, bf16, cuda),
        _t(rng, (49, c), 0.1, bf16, cuda),
        _t(rng, (c,), 0.1, f32, cuda),
        _t(rng, (c,), 0.1, f32, cuda, 1.0),
        _t(rng, (c,), 0.1, f32, cuda),
        _t(rng, (4 * c, c), c ** -0.5, bf16, cuda),
        _t(rng, (4 * c,), 0.1, f32, cuda),
        _t(rng, (c, 4 * c), (4 * c) ** -0.5, bf16, cuda),
        _t(rng, (c,), 0.1, f32, cuda),
        _t(rng, (c,), 0.1, f32, cuda, 1.0),
    )
    before = cb.convnext_block.launches
    got = cb.convnext_block(*args)
    want = cb.block_reference(*args)
    torch.cuda.synchronize()
    assert cb.convnext_block.launches == before + 1
    # y and the hidden round to bf16 in both; a flipped rounding moves the
    # output by about one bf16 step of its magnitude: 1e-2 * max |plain|.
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


def _block_args(rng, b, h, w, c, device):
    f32, bf16 = torch.float32, torch.bfloat16
    return (
        _t(rng, (b, h, w, c), 1.0, bf16, device),
        _t(rng, (49, c), 0.1, bf16, device),
        _t(rng, (c,), 0.1, f32, device),
        _t(rng, (c,), 0.1, f32, device, 1.0),
        _t(rng, (c,), 0.1, f32, device),
        _t(rng, (4 * c, c), c ** -0.5, bf16, device),
        _t(rng, (4 * c,), 0.1, f32, device),
        _t(rng, (c, 4 * c), (4 * c) ** -0.5, bf16, device),
        _t(rng, (c,), 0.1, f32, device),
        _t(rng, (c,), 0.1, f32, device, 1.0),
    )


@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", [(2, 8, 8), (3, 9, 11)])
def test_block_kernel_emit_conv_matches_plain(cuda, c, b, h, w):
    args = _block_args(np.random.default_rng(c + 7 * h), b, h, w, c, cuda)
    before, before_emit = cb.convnext_block.launches, cb.convnext_block.emit_launches
    out, t = cb.convnext_block(*args, emit_conv=True)
    want_out, want_t = cb.block_reference(*args, emit_conv=True)
    torch.cuda.synchronize()
    assert cb.convnext_block.launches == before + 1
    assert cb.convnext_block.emit_launches == before_emit + 1
    assert t.dtype == torch.bfloat16 and t.shape == args[0].shape
    # t: the same f32 conv sum in another order, rounded once: one bf16 step.
    t_err = (t.float() - want_t.float()).abs().max().item()
    assert t_err <= 1e-2 * want_t.float().abs().max().item()
    err = (out.float() - want_out.float()).abs().max().item()
    assert err <= 1e-2 * want_out.float().abs().max().item()
    # The inference form is unchanged beside it.
    torch.testing.assert_close(cb.convnext_block(*args), cb.block_reference(*args),
                               rtol=0, atol=1e-2 * want_out.float().abs().max().item())


def _bwd_args(rng, b, h, w, c, device):
    f32, bf16 = torch.float32, torch.bfloat16
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


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", [(2, 8, 8), (3, 9, 11), (1, 1, 5)])
def test_ln_mlp_bwd_kernel_matches_plain(cuda, c, b, h, w):
    args = _bwd_args(np.random.default_rng(c + h), b, h, w, c, cuda)
    before = fm.ln_mlp_bwd.launches
    got = fm.ln_mlp_bwd(*args)
    again = fm.ln_mlp_bwd(*args)
    want = fm.ln_mlp_bwd_reference(*args)
    torch.cuda.synchronize()
    assert fm.ln_mlp_bwd.launches == before + 2
    names = ["dt", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma"]
    for name, a, b_, ref in zip(names, got, again, want):
        assert a.dtype == ref.dtype and a.shape == ref.shape, name
        # Every cross-CTA sum has a fixed order: two runs agree bit for bit.
        assert torch.equal(a, b_), name
        # Same rounding points as the plain version; a value on a rounding
        # boundary can round apart, and the f32 sums run in another order:
        # 2e-2 of max |plain| (about three bf16 steps).
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * max(ref.float().abs().max().item(), 1e-6), (name, err)


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


def _mlp_args(rng, b, h, w, c, device):
    f32, bf16 = torch.float32, torch.bfloat16
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
@pytest.mark.parametrize("b,h,w", [(2, 8, 8)] + RAGGED)
def test_mlp_bwd_kernel_matches_plain(cuda, c, b, h, w):
    args = _mlp_args(np.random.default_rng(c + 3 * h), b, h, w, c, cuda)
    before = fm.mlp_bwd.launches, fm.ln_mlp_bwd.launches
    got = fm.mlp_bwd(*args)
    again = fm.mlp_bwd(*args)
    want = fm.mlp_bwd_reference(*args)
    torch.cuda.synchronize()
    assert (fm.mlp_bwd.launches, fm.ln_mlp_bwd.launches) == (before[0] + 2, before[1])
    for name, a, b_, ref in zip(["dy", "dw1t", "db1", "dw2t", "db2", "dgamma"], got, again, want):
        assert a.dtype == ref.dtype and a.shape == ref.shape, name
        assert torch.equal(a, b_), name
        # As the LN+MLP backward: 2e-2 of max |plain| (about three bf16 steps).
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * max(ref.float().abs().max().item(), 1e-6), (name, err)


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


ROW_SHAPES = [(2, 8, 8), (3, 9, 11), (1, 1, 5)]  # whole, ragged and single-row token tiles


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", ROW_SHAPES)
def test_ln_mlp_kernel_matches_plain(cuda, c, b, h, w):
    x, ls, lb, w1t, b1, w2t, b2, gamma, res = _bwd_args(np.random.default_rng(c + 5 * h), b, h,
                                                         w, c, cuda)
    args = (x, ls, lb, w1t, b1, w2t, b2, gamma, res)
    before = fm.ln_mlp.launches
    got = fm.ln_mlp(*args)
    want = fm.ln_mlp_reference(*args)
    torch.cuda.synchronize()
    assert fm.ln_mlp.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    # y and the hidden round to bf16 in both; a flipped rounding moves the
    # output by about one bf16 step of its magnitude: 1e-2 * max |plain|.
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()
    # Flat [M, C] rows are the same rows.
    flat = fm.ln_mlp(x.reshape(-1, c), ls, lb, w1t, b1, w2t, b2, gamma, res.reshape(-1, c))
    assert torch.equal(flat.reshape(x.shape), got)


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", ROW_SHAPES)
@pytest.mark.parametrize("tail", [True, False])
def test_mlp_fwd_kernel_matches_plain(cuda, c, b, h, w, tail):
    y, w1t, b1, w2t, b2, gamma, res = _mlp_args(np.random.default_rng(c + 11 * h), b, h, w, c,
                                                cuda)
    kw = {"gamma": gamma, "residual": res} if tail else {}
    before = fm.mlp_fwd.launches
    got = fm.mlp_fwd(y, w1t, b1, w2t, b2, **kw)
    want = fm.mlp_reference(y, w1t, b1, w2t, b2, **kw)
    torch.cuda.synchronize()
    assert fm.mlp_fwd.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == y.shape
    # As the LN form: 1e-2 * max |plain|.
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("c", fm.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w", [(2, 8, 8)] + RAGGED)
def test_block_train_bwd_kernel_matches_plain(cuda, c, b, h, w):
    args = _block_args(np.random.default_rng(c + 13 * h), b, h, w, c, cuda)
    g = _t(np.random.default_rng(c), (b, h, w, c), 1.0, torch.bfloat16, cuda)
    before = bt.block_train_bwd.launches
    got = bt.block_train_bwd(*args, g)
    again = bt.block_train_bwd(*args, g)
    want = bt.block_train_bwd_reference(*args, g)
    torch.cuda.synchronize()
    assert bt.block_train_bwd.launches == before + 2
    names = ["g_u", "dk", "ddwb", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma"]
    for name, a, b_, ref in zip(names, got, again, want):
        assert a.dtype == ref.dtype and a.shape == ref.shape, name
        # Every cross-CTA sum has a fixed order: two runs agree bit for bit.
        assert torch.equal(a, b_), name
        # As the LN+MLP backward: 2e-2 of max |plain| (about three bf16 steps).
        err = (a.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * max(ref.float().abs().max().item(), 1e-6), (name, err)


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
    with pytest.raises(ValueError):  # an f32 filter
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
    if variant == "gelu_tanh":  # the production activation: #5's own result
        assert torch.equal(got, am.fm.mlp_fwd(args[0], *args[1:6], args[6]))
