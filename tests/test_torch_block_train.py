"""Port of the hybrid training block against the JAX package's.

The JAX side runs ``convnext_block_hybrid(tile_h=8, interpret=True)`` (the
megakernel's ``emit_conv`` form forward, the LN+MLP backward kernel in
interpret mode); the port's autograd function, given CPU tensors, runs both
kernels' plain versions. Inputs come from numpy with a seed and go to both;
the loss is ``sum(out.float() ** 2)``, as in ``tests/test_block_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.models.classifier import CoordinateRegressor as TRegressor
from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
from spine_vision_torch.ops import block_train as tbt
from spine_vision_torch.ops import convnext_block as tcb
from spine_vision_tpu.models import CoordinateRegressor
from spine_vision_tpu.ops.block_train import convnext_block_hybrid
from spine_vision_tpu.ops.convnext_block import _block_pallas

NAMES = ["x", "dw_kernel", "dw_bias", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "gamma"]
# Arguments that are cast to the compute dtype (the rest stay f32).
LOW = {"x", "dw_kernel", "w1", "w2"}


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
        (rng.normal(size=(c,)) * 0.5).astype(np.float32),
    ]


def _jax_args(args, dtype):
    return [jnp.asarray(a, dtype if n in LOW else jnp.float32) for n, a in zip(NAMES, args)]


def _torch_args(args, dtype):
    """The port's layouts: [49, C] filter, [out, in] products."""
    x, k, bias, scale, beta, w1, b1, w2, b2, gamma = (torch.from_numpy(a) for a in args)
    c = x.shape[-1]
    out = [
        x.to(dtype), k.reshape(49, c).to(dtype), bias, scale, beta,
        w1.t().contiguous().to(dtype), b1, w2.t().contiguous().to(dtype), b2, gamma,
    ]
    return [a.clone().requires_grad_(True) for a in out]


def _to_flax_layout(name, grad, c):
    g = grad.float().numpy()
    if name == "dw_kernel":
        return g.reshape(7, 7, c)
    if name in ("w1", "w2"):
        return g.T
    return g


@pytest.mark.parametrize(
    "b,h,w,c",
    [
        (1, 8, 8, 128),   # single tile, single hidden chunk
        (2, 20, 8, 128),  # padded rows in the JAX kernels + batch
        (1, 16, 8, 512),  # the resident-weights backward (#8)
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_gradients_match_jax(b, h, w, c, dtype):
    args = _args(np.random.default_rng(1), b, h, w, c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(*a):
        out = convnext_block_hybrid(*a, tile_h=8, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jargs = _jax_args(args, jdt)
    want = jax.grad(loss, argnums=tuple(range(10)))(*jargs)
    targs = _torch_args(args, tdt)
    out = tbt.convnext_block_hybrid(*targs)
    (out.float() ** 2).sum().backward()
    # f32: the same sums in another order, atol 5e-3 of max(1, max |grad|)
    # as the JAX package's own test. bf16: both round y, h, g*gamma, the
    # hidden gradient and dt at the same points, but a value on a rounding
    # boundary can round apart; 3e-2 of the scale is about four bf16 steps.
    tol = 5e-3 if dtype == "float32" else 3e-2
    for name, ta, ja, wa in zip(NAMES, targs, jargs, want):
        assert ta.grad.dtype == tdt if name in LOW else ta.grad.dtype == torch.float32
        assert np.dtype(wa.dtype) == np.dtype(ja.dtype)
        ref = np.asarray(wa, np.float32)
        scale = max(1.0, float(np.max(np.abs(ref))))
        np.testing.assert_allclose(
            _to_flax_layout(name, ta.grad, c) / scale, ref / scale, atol=tol,
            err_msg=f"grad mismatch for {name}",
        )


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-3), ("bfloat16", 0.25)])
def test_emit_conv_forward_matches_jax(dtype, atol):
    args = _args(np.random.default_rng(2), 2, 12, 8, 128)
    jargs = _jax_args(args, getattr(jnp, dtype))
    want_out, want_t = _block_pallas(*jargs, 8, 1e-6, True, emit_conv=True)
    with torch.no_grad():
        out, t = tcb.convnext_block(*_torch_args(args, getattr(torch, dtype)), emit_conv=True)
    assert t.dtype == getattr(torch, dtype)
    # t: one rounding of the same conv sum (f32: 1e-5; bf16: one step of |t| < 4).
    t_atol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(t.float().numpy(), np.asarray(want_t, np.float32), atol=t_atol)
    # out: as the inference block's test (f32 2e-3, bf16 0.25).
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want_out, np.float32), atol=atol)


def test_hybrid_forward_without_grad_is_the_emit_form():
    targs = [a.detach() for a in _torch_args(_args(np.random.default_rng(3), 1, 8, 8, 128),
                                             torch.bfloat16)]
    with torch.no_grad():
        got = tbt.convnext_block_hybrid(*targs)
        want, _ = tcb.block_reference(*targs, emit_conv=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_hybrid_regressor_eval_forward_matches_jax():
    """The training model in eval mode (bf16 on f32 masters, every block's t
    rounded, as JAX's eval step under "hybrid") against the JAX model."""
    port = TRegressor("convnext_tiny", dtype=torch.bfloat16, device="cpu",
                      use_pallas="hybrid", param_dtype=torch.float32)
    params, _ = random_flax_variables(port, seed=5)
    load_flax_variables(port, params)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    ref = CoordinateRegressor(backbone_name="convnext_tiny", dtype=jnp.bfloat16,
                              use_pallas="hybrid")
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(x), train=False), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).float().numpy()
    # bf16 through 18 blocks, as the inference model's test: atol 2e-2.
    np.testing.assert_allclose(got, want, atol=2e-2)
