"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (the kernels have no CPU mode) and skip without
one. The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

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
