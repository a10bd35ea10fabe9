"""Port of the whole-ConvNeXt-block op against the JAX package's megakernel.

The JAX side runs ``convnext_block_fused`` in interpret mode on the CPU; the
port's wrapper, given CPU tensors, runs its plain PyTorch version. Inputs
come from numpy with a seed and go to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.ops import convnext_block as tcb
from spine_vision_tpu.ops.convnext_block import convnext_block_fused


def _args(rng, b, h, w, c):
    return [
        (rng.normal(size=(b, h, w, c)) * 0.5).astype(np.float32),
        (rng.normal(size=(7, 7, c)) * 0.1).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        (rng.normal(size=(c,)) + 1.0).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        (rng.normal(size=(c, 4 * c)) * 0.05).astype(np.float32),
        (rng.normal(size=(4 * c,)) * 0.1).astype(np.float32),
        (rng.normal(size=(4 * c, c)) * 0.05).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        (rng.normal(size=(c,)) * 1e-2).astype(np.float32),
    ]


def _jax(args, dtype):
    x, k, bias, scale, beta, w1, b1, w2, b2, gamma = args
    out = convnext_block_fused(
        jnp.asarray(x, dtype), jnp.asarray(k, dtype), jnp.asarray(bias),
        jnp.asarray(scale), jnp.asarray(beta), jnp.asarray(w1, dtype),
        jnp.asarray(b1), jnp.asarray(w2, dtype), jnp.asarray(b2),
        jnp.asarray(gamma), tile_h=8, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def _torch_args(args, dtype):
    """The port's layouts: [49, C] filter, [out, in] products."""
    x, k, bias, scale, beta, w1, b1, w2, b2, gamma = (torch.from_numpy(a) for a in args)
    c = x.shape[-1]
    return (
        x.to(dtype), k.reshape(49, c).to(dtype), bias, scale, beta,
        w1.t().contiguous().to(dtype), b1, w2.t().contiguous().to(dtype), b2, gamma,
    )


@pytest.mark.parametrize("b,h,w,c", [(1, 8, 8, 128), (2, 20, 8, 128), (1, 9, 11, 96)])
def test_block_f32_matches_jax(b, h, w, c):
    args = _args(np.random.default_rng(0), b, h, w, c)
    got = tcb.convnext_block(*_torch_args(args, torch.float32))
    assert got.shape == (b, h, w, c)
    # Same tolerance as the JAX package's own megakernel test.
    np.testing.assert_allclose(got.numpy(), _jax(args, jnp.float32), atol=2e-3)


def test_block_bf16_matches_jax():
    args = _args(np.random.default_rng(2), 1, 8, 8, 128)
    got = tcb.convnext_block(*_torch_args(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # As the JAX package's bf16 test: both round y and the hidden to bf16.
    np.testing.assert_allclose(got.float().numpy(), _jax(args, jnp.bfloat16), atol=0.25)


def test_cpu_tensors_take_the_plain_version():
    targs = _torch_args(_args(np.random.default_rng(3), 1, 8, 8, 128), torch.bfloat16)
    before = tcb.convnext_block.launches
    got = tcb.convnext_block(*targs)
    assert tcb.convnext_block.launches == before
    torch.testing.assert_close(got, tcb.block_reference(*targs), rtol=0, atol=0)


@pytest.mark.parametrize(
    "c,dtype,error", [(640, torch.bfloat16, ValueError), (128, torch.float32, TypeError)]
)
def test_kernel_checks_reject_what_it_does_not_take(c, dtype, error):
    targs = _torch_args(_args(np.random.default_rng(4), 1, 4, 4, c), torch.bfloat16)
    with pytest.raises(error):
        tcb._check(targs[0].to(dtype), *targs[1:])
