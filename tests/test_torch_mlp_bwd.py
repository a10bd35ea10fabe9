"""Port of the MLP + LayerScale backward and of the trainable all-kernel
ConvNeXt block against the JAX package's.

The JAX side runs ``_mlp_bwd_pallas`` and ``convnext_block_fused(tile_h=8)``
in interpret mode; the port's ``mlp_bwd`` and ``convnext_block_fused``, given
CPU tensors, run the plain versions of their kernels. The same seeded numpy
inputs go to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.ops import convnext_block as tcb
from spine_vision_torch.ops import fused_mlp as tfm
from spine_vision_tpu.ops.convnext_block import convnext_block_fused
from spine_vision_tpu.ops.fused_mlp import _mlp_bwd_pallas
from test_torch_block_train import LOW, NAMES, _args, _jax_args, _to_flax_layout, _torch_args

OUTPUTS = ["dy", "dw1", "db1", "dw2", "db2", "dgamma"]


@pytest.mark.parametrize(
    "m,c",
    [(1100, 128), (300, 512)],  # two token tiles of 1024 / 256, the last one ragged
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_bwd_matches_jax(m, c, dtype):
    rng = np.random.default_rng(c)
    y = rng.normal(size=(m, c)).astype(np.float32)
    w1 = (rng.normal(size=(c, 4 * c)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(4 * c,))).astype(np.float32)
    w2 = (rng.normal(size=(4 * c, c)) * (4 * c) ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    gamma = (0.5 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    g = rng.normal(size=(m, c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _mlp_bwd_pallas(
        jnp.asarray(y, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1), jnp.asarray(w2, jdt),
        jnp.asarray(b2), jnp.asarray(gamma), jnp.asarray(g, jdt), True,
    )
    t = torch.from_numpy
    got = tfm.mlp_bwd(
        t(y).to(tdt), t(w1).t().contiguous().to(tdt), t(b1), t(w2).t().contiguous().to(tdt),
        t(b2), t(gamma), t(g).to(tdt),
    )
    assert got[0].dtype == tdt and got[0].shape == (m, c)
    for name, out in zip(OUTPUTS[1:], got[1:]):
        assert out.dtype == torch.float32, name
    # f32: sums in another order; 2e-4 of max(1, max |ref|). bf16: the same
    # rounding points on both sides, but a value on a rounding boundary can
    # round apart and a weight gradient sums a thousand such products; 2e-2
    # of the scale is about three bf16 steps.
    tol = 2e-4 if dtype == "float32" else 2e-2
    for name, g_port, g_ref in zip(OUTPUTS, got, want):
        ref = np.asarray(g_ref, np.float32).reshape(-1)
        port = g_port.float().numpy()
        if name in ("dw1", "dw2"):
            port = port.T  # the port keeps [out, in]
        port = port.reshape(-1)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(port / scale, ref / scale, atol=tol, err_msg=name)


def test_mlp_bwd_is_ln_mlp_bwd_without_the_layernorm():
    """With a LayerNorm that is the identity on its input (rows already of mean
    0 and variance 1, scale 1, bias 0), both plain versions agree."""
    rng = np.random.default_rng(3)
    c = 128
    y = torch.from_numpy(rng.normal(size=(64, c)))
    y = ((y - y.mean(-1, keepdim=True)) / y.std(-1, unbiased=False, keepdim=True)).float()
    w1t = torch.from_numpy(rng.normal(size=(4 * c, c)).astype(np.float32)) * c ** -0.5
    w2t = torch.from_numpy(rng.normal(size=(c, 4 * c)).astype(np.float32)) * (4 * c) ** -0.5
    b1, b2 = torch.zeros(4 * c), torch.full((c,), 0.1)
    gamma, g = torch.full((c,), 0.5), torch.from_numpy(rng.normal(size=(64, c)).astype(np.float32))
    got = tfm.mlp_bwd(y, w1t, b1, w2t, b2, gamma, g)
    dt, _, _, *want = tfm.ln_mlp_bwd_reference(y, torch.ones(c), torch.zeros(c), w1t, b1, w2t,
                                                b2, gamma, g)
    # The LayerNorm's epsilon (1e-6) scales y by 1 - 5e-7: 1e-5 of the scale.
    for a, b in zip(got[1:], want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_gradients_match_jax(dtype):
    """The trainable all-kernel block (forward #1; backward #2, #6, #4 and #3)
    against ``jax.grad`` of ``convnext_block_fused``; loss ``sum(out ** 2)``.
    H = 12 takes the JAX kernels' padded-rows path."""
    c = 128
    args = _args(np.random.default_rng(4), 1, 12, 8, c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(*a):
        out = convnext_block_fused(*a, tile_h=8, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jargs = _jax_args(args, jdt)
    want = jax.grad(loss, argnums=tuple(range(10)))(*jargs)
    targs = _torch_args(args, tdt)
    out = tcb.convnext_block_fused(*targs)
    assert out.dtype == tdt and out.grad_fn is not None
    (out.float() ** 2).sum().backward()
    # As the hybrid block's comparison: f32 5e-3 of max(1, max |grad|), bf16
    # 3e-2 (about four bf16 steps: y, h, g*gamma, the hidden gradient, dy and
    # da round at the same points on both sides, but a value on a rounding
    # boundary can round apart).
    tol = 5e-3 if dtype == "float32" else 3e-2
    for name, ta, wa in zip(NAMES, targs, want):
        assert ta.grad.dtype == (tdt if name in LOW else torch.float32), name
        ref = np.asarray(wa, np.float32)
        scale = max(1.0, float(np.max(np.abs(ref))))
        np.testing.assert_allclose(
            _to_flax_layout(name, ta.grad, c) / scale, ref / scale, atol=tol,
            err_msg=f"grad mismatch for {name}",
        )


def test_fused_block_without_grad_is_the_inference_kernel():
    targs = [a.detach() for a in _torch_args(_args(np.random.default_rng(5), 1, 8, 8, 128),
                                             torch.bfloat16)]
    with torch.no_grad():
        got = tcb.convnext_block_fused(*targs)
    torch.testing.assert_close(got, tcb.block_reference(*targs), rtol=0, atol=0)
