"""Port of the LN+MLP backward against the JAX package's kernels.

The JAX side runs ``_ln_mlp_bwd_pallas`` in interpret mode: at C = 128 the
(token, hidden-chunk) grid kernel (#9), at C = 512 the resident-weights
kernel (#8). The port's ``ln_mlp_bwd``, given CPU tensors, runs its plain
version. The same seeded numpy inputs go to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.ops import fused_mlp as tfm
from spine_vision_tpu.ops.fused_mlp import _gelu_and_grad, _ln_mlp_bwd_pallas

OUTPUTS = ["dt", "dls", "dlb", "dw1", "db1", "dw2", "db2", "dgamma"]


def _inputs(rng, shape):
    c = shape[-1]
    return {
        "t": rng.normal(size=shape).astype(np.float32),
        "ls": (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
        "lb": (0.1 * rng.normal(size=(c,))).astype(np.float32),
        "w1": (rng.normal(size=(c, 4 * c)) * c ** -0.5).astype(np.float32),
        "b1": (0.1 * rng.normal(size=(4 * c,))).astype(np.float32),
        "w2": (rng.normal(size=(4 * c, c)) * (4 * c) ** -0.5).astype(np.float32),
        "b2": (0.1 * rng.normal(size=(c,))).astype(np.float32),
        "gamma": (0.5 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
        "g": rng.normal(size=shape).astype(np.float32),
    }


@pytest.mark.parametrize(
    "shape",
    [(2, 10, 8, 128), (1, 16, 8, 512)],  # grid form (#9, ragged tiles), resident (#8)
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_mlp_bwd_matches_jax(shape, dtype):
    v = _inputs(np.random.default_rng(shape[-1]), shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _ln_mlp_bwd_pallas(
        jnp.asarray(v["t"], jdt), jnp.asarray(v["ls"]), jnp.asarray(v["lb"]),
        jnp.asarray(v["w1"], jdt), jnp.asarray(v["b1"]), jnp.asarray(v["w2"], jdt),
        jnp.asarray(v["b2"]), jnp.asarray(v["gamma"]), jnp.asarray(v["g"], jdt), True,
    )
    tt = lambda k: torch.from_numpy(v[k])  # noqa: E731
    got = tfm.ln_mlp_bwd(
        tt("t").to(tdt), tt("ls"), tt("lb"), tt("w1").t().contiguous().to(tdt), tt("b1"),
        tt("w2").t().contiguous().to(tdt), tt("b2"), tt("gamma"), tt("g").to(tdt),
    )
    assert got[0].dtype == tdt and got[0].shape == shape
    for name, out in zip(OUTPUTS[1:], got[1:]):
        assert out.dtype == torch.float32, name
    # f32: sums in another order; 2e-4 of max(1, max |ref|). bf16: the same
    # rounding points on both sides, but a value on a rounding boundary can
    # round apart and a weight gradient sums thousands of such products; 2e-2
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


def test_gelu_and_grad_matches_jax():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    h, dh = tfm.gelu_and_grad(torch.from_numpy(x))
    jh, jdh = _gelu_and_grad(jnp.asarray(x))
    # f32 tanh of two libraries: a few units in the last place of values <= 1.1.
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=1e-5)
    # And the derivative is the derivative of tanh_gelu.
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
    tfm.tanh_gelu(xt).sum().backward()
    np.testing.assert_allclose(dh.numpy(), xt.grad.numpy(), atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    v = _inputs(np.random.default_rng(0), (1, 4, 4, 128))
    args = [torch.from_numpy(v[k]) for k in ("t", "ls", "lb")] + [
        torch.from_numpy(v["w1"]).t().contiguous(), torch.from_numpy(v["b1"]),
        torch.from_numpy(v["w2"]).t().contiguous(), torch.from_numpy(v["b2"]),
        torch.from_numpy(v["gamma"]), torch.from_numpy(v["g"]),
    ]
    before = tfm.ln_mlp_bwd.launches
    got = tfm.ln_mlp_bwd(*args)
    assert tfm.ln_mlp_bwd.launches == before
    for a, b in zip(got, tfm.ln_mlp_bwd_reference(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("m,c,splits", [(32 * 128 * 128, 128, 33), (32 * 32 * 32, 512, 3), (40, 96, 2)])
def test_token_splits(m, c, splits):
    """Enough CTAs for the card, never more splits than 32-token steps."""
    assert tfm.token_splits(m, c) == splits
