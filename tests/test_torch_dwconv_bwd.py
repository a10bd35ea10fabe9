"""Port of the depthwise 7x7 stencil, the dwconv+LayerNorm backward and the
differentiable dwconv+LayerNorm against the JAX package's kernels.

The JAX side runs its Pallas kernels in interpret mode (``tile_h=8``; H = 12
takes its padded-rows path); the port's wrappers, given CPU tensors, run
their plain versions. Inputs come from numpy with a seed and go to both.

Tolerances, each scaled by max(1, max |JAX output|): f32 2e-4, the same sums
taken in another order; bf16 2e-2, about three bf16 steps, since both sides
round at the same points but a value on a rounding boundary can round apart
and the parameter sums add hundreds of such terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.ops import dwconv as tdw
from spine_vision_tpu.ops.dwconv import (
    _dw_ln_bwd_pallas,
    depthwise_conv7x7,
    depthwise_conv7x7_ln,
)

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
NAMES = ["x", "kernel", "bias", "ln_scale", "ln_bias"]


def _args(rng, b, h, w, c):
    return [
        rng.normal(size=(b, h, w, c)).astype(np.float32),
        (rng.normal(size=(7, 7, c)) * 0.1).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
        (rng.normal(size=(c,)) + 1.0).astype(np.float32),
        (rng.normal(size=(c,)) * 0.1).astype(np.float32),
    ]


def _close(got, want, dtype, name):
    ref = np.asarray(want, np.float32)
    port = got.float().detach().numpy().reshape(ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port / scale, ref / scale, atol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("b,h,w,c", [(2, 12, 9, 128), (1, 8, 8, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_conv7x7_matches_jax(b, h, w, c, dtype):
    x, k = _args(np.random.default_rng(c), b, h, w, c)[:2]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = depthwise_conv7x7(jnp.asarray(x, jdt), jnp.asarray(k, jdt), tile_h=8, interpret=True)
    got = tdw.depthwise_conv7x7(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(k.reshape(49, c)).to(tdt))
    assert got.dtype == tdt and got.shape == (b, h, w, c)
    _close(got, want, dtype, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_ln_bwd_matches_jax(dtype):
    b, h, w, c = 2, 12, 9, 128
    rng = np.random.default_rng(7)
    x, k, bias, scale, _ = _args(rng, b, h, w, c)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _dw_ln_bwd_pallas(
        jnp.asarray(x, jdt), jnp.asarray(k, jdt), jnp.asarray(bias), jnp.asarray(scale),
        jnp.asarray(g, jdt), 8, 1e-6, True,
    )
    got = tdw.dw_ln_bwd(
        torch.from_numpy(x).to(tdt), torch.from_numpy(k.reshape(49, c)).to(tdt),
        torch.from_numpy(bias), torch.from_numpy(scale), torch.from_numpy(g).to(tdt),
    )
    assert got[0].dtype == tdt and got[0].shape == (b, h, w, c)
    assert got[1].shape == (49, c)
    for out in got[1:]:
        assert out.dtype == torch.float32
    for name, a, ref in zip(["dx", "dk", "dbias", "dscale", "dbeta"], got, want):
        _close(a, ref, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_conv7x7_ln_gradients_match_jax(dtype):
    args = _args(np.random.default_rng(8), 1, 12, 8, 96)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(*a):
        out = depthwise_conv7x7_ln(*a, tile_h=8, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jargs = [jnp.asarray(a, jdt if i < 2 else jnp.float32) for i, a in enumerate(args)]
    want = jax.grad(loss, argnums=tuple(range(5)))(*jargs)
    x, k, bias, scale, beta = (torch.from_numpy(a) for a in args)
    targs = [t.clone().requires_grad_(True)
             for t in (x.to(tdt), k.reshape(49, -1).to(tdt), bias, scale, beta)]
    out = tdw.depthwise_conv7x7_ln(*targs)
    assert out.dtype == tdt
    (out.float() ** 2).sum().backward()
    for name, t, ref in zip(NAMES, targs, want):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad, ref, dtype, name)


def test_cpu_tensors_take_the_plain_versions():
    x, k, bias, scale, _ = (torch.from_numpy(a) for a in _args(np.random.default_rng(9), 1, 8, 8, 128))
    k49 = k.reshape(49, -1)
    g = torch.from_numpy(np.random.default_rng(10).normal(size=x.shape).astype(np.float32))
    before = tdw.depthwise_conv7x7.launches, tdw.dw_ln_bwd_sums.launches
    got = tdw.dw_ln_bwd(x, k49, bias, scale, g)
    conv = tdw.depthwise_conv7x7(x, k49)
    assert (tdw.depthwise_conv7x7.launches, tdw.dw_ln_bwd_sums.launches) == before
    for a, b in zip(got, tdw.dw_ln_bwd_reference(x, k49, bias, scale, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(conv, tdw.depthwise_conv7x7_reference(x, k49), rtol=0, atol=0)


def test_flipped_filter_is_the_transpose_of_the_conv():
    """dx of a SAME depthwise conv is the same conv with k49.flip(0): against
    autograd through the plain conv, in f64."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(1, 6, 5, 96))).requires_grad_(True)
    k49 = torch.from_numpy(rng.normal(size=(49, 96)))
    g = torch.from_numpy(rng.normal(size=(1, 6, 5, 96)))
    (tdw.depthwise_conv7x7_reference(x, k49).double() * g).sum().backward()
    want = x.grad
    got = tdw.depthwise_conv7x7_reference(g, k49.flip(0)).double()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "c,dtype,contiguous,g_dtype,error",
    [(100, torch.float32, True, torch.float32, ValueError),
     (768, torch.float16, True, torch.float16, TypeError),
     (768, torch.float32, False, torch.float32, ValueError),
     (768, torch.bfloat16, True, torch.float32, ValueError)],
)
def test_backward_checks_reject_what_the_kernel_does_not_take(c, dtype, contiguous, g_dtype,
                                                              error):
    x = torch.zeros(1, 4, 4, c, dtype=dtype)
    if not contiguous:
        x = torch.zeros(1, 4, c, 4, dtype=dtype).transpose(2, 3)
    vec = torch.zeros(c)
    with pytest.raises(error):
        tdw._check_args("dw_ln_bwd", x, torch.zeros(49, c, dtype=dtype),
                        (("bias", vec), ("ln_scale", vec)), torch.zeros(1, 4, 4, c, dtype=g_dtype))
