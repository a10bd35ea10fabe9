"""Port of the fused dwconv+LayerNorm op against the JAX package's kernel.

The JAX side runs its Pallas kernel in interpret mode on the CPU; the port's
wrapper, given CPU tensors, runs its plain PyTorch version. Inputs come from
numpy with a seed and go to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.ops import dwconv as tdw
from spine_vision_tpu.ops.dwconv import depthwise_conv7x7_ln


def _args(rng, b, h, w, c):
    return (
        rng.normal(size=(b, h, w, c)).astype(np.float32),
        (rng.normal(size=(7, 7, c)) * 0.1).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        (rng.normal(size=(c,)) + 1.0).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
    )


def _jax(args, dtype):
    x, k, bias, scale, beta = args
    out = depthwise_conv7x7_ln(
        jnp.asarray(x, dtype), jnp.asarray(k, dtype), jnp.asarray(bias),
        jnp.asarray(scale), jnp.asarray(beta), tile_h=8, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def _torch(args, dtype):
    x, k, bias, scale, beta = args
    c = x.shape[-1]
    return tdw.dw_ln(
        torch.from_numpy(x).to(dtype), torch.from_numpy(k.reshape(49, c)).to(dtype),
        torch.from_numpy(bias), torch.from_numpy(scale), torch.from_numpy(beta),
    )


@pytest.mark.parametrize("b,h,w,c", [(1, 8, 8, 128), (2, 12, 9, 96), (1, 16, 16, 768)])
def test_dw_ln_f32_matches_jax(b, h, w, c):
    args = _args(np.random.default_rng(0), b, h, w, c)
    got = _torch(args, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (b, h, w, c)
    # Same tolerance as the JAX package's own dwconv tests.
    np.testing.assert_allclose(got.numpy(), _jax(args, jnp.float32), atol=1e-4)


def test_dw_ln_bf16_matches_jax():
    args = _args(np.random.default_rng(1), 2, 8, 8, 256)
    got = _torch(args, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # Both accumulate in f32 and round once to bf16; sums in another order
    # can move a value by one bf16 step (2^-6 at |y| < 4): stated atol 3e-2.
    np.testing.assert_allclose(got.float().numpy(), _jax(args, jnp.bfloat16), atol=3e-2)


def test_cpu_tensors_take_the_plain_version():
    args = _args(np.random.default_rng(2), 1, 8, 8, 128)
    before = tdw.dw_ln.launches
    got = _torch(args, torch.float32)
    assert tdw.dw_ln.launches == before
    x, k, bias, scale, beta = (torch.from_numpy(a) for a in args)
    want = tdw.dw_ln_reference(x, k.reshape(49, -1), bias, scale, beta)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "c,dtype,contiguous,error",
    [(100, torch.float32, True, ValueError), (768, torch.float16, True, TypeError),
     (768, torch.float32, False, ValueError)],
)
def test_kernel_checks_reject_what_it_does_not_take(c, dtype, contiguous, error):
    x = torch.zeros(1, 4, 4, c, dtype=dtype)
    if not contiguous:
        x = torch.zeros(1, 4, c, 4, dtype=dtype).transpose(2, 3)
    k = torch.zeros(49, c, dtype=dtype)
    vec = torch.zeros(c)
    with pytest.raises(error):
        tdw._check(x, k, vec, vec, vec)
