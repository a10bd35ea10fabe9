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
