"""Port's training BatchNorm and the ResNet stem pool against the JAX package.

``batch_norm_train`` (forward, batch statistics and the three-term VJP) and
the ``BatchNorm`` module's running update are held to
``spine_vision_tpu/ops/batchnorm.py`` on the same seeded numpy inputs, in f32
and bf16; the stem max pool's gradient to Flax's ``nn.max_pool`` on inputs
with planted ties.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.models.resnet import stem_pool
from spine_vision_torch.ops import batchnorm as tbn
from spine_vision_tpu.ops import batchnorm as jbn


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * rng.uniform(0.5, 3.0, c) + rng.normal(size=c)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    if dtype == "bfloat16":  # both sides read the same bf16 values
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        g = np.array(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return x, g, scale, bias


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize(
    "dtype,atol_x,rtol_p",
    # f32: the same sums in another order, stated 1e-5 (x, dx) and 1e-5
    # relative (dscale, dbias, statistics). bf16: y and dx round once to bf16
    # at the end on both sides, so they agree within one bf16 step of their
    # scale (2**-8 of |value| up to 8: 3.2e-2); the f32 sums as in f32.
    [("float32", 1e-5, 1e-5), ("bfloat16", 3.2e-2, 1e-5)],
)
def test_batch_norm_train_matches_jax(dtype, atol_x, rtol_p):
    x, g, scale, bias = _inputs(0, (4, 6, 5, 16), dtype)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jy, jmean, jvar = jbn.batch_norm_train(jx, jnp.asarray(scale), jnp.asarray(bias))

    def j_loss(xx, s, b):
        y, _, _ = jbn.batch_norm_train(xx, s, b)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g))

    jdx, jds, jdb = jax.grad(j_loss, argnums=(0, 1, 2))(jx, jnp.asarray(scale), jnp.asarray(bias))

    tx = _t(x, dtype).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    ty, tmean, tvar = tbn.batch_norm_train(tx, ts, tb)
    assert ty.dtype == tx.dtype
    (ty.float() * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == tx.dtype

    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=rtol_p, atol=1e-6)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=rtol_p, atol=1e-6)
    np.testing.assert_allclose(ty.float().detach().numpy(), np.asarray(jy, np.float32),
                               atol=atol_x)
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(jdx, np.float32),
                               atol=atol_x)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), rtol=rtol_p, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=rtol_p, atol=1e-4)


def test_batch_norm_train_gradient_is_the_full_batch_norm_gradient():
    """The three-term backward (f32) equals autograd through the plain
    formula in f64, statistics included (f32 rounding: 1e-5)."""
    x, g, scale, bias = _inputs(1, (3, 4, 4, 8), "float32")
    tx, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias))
    y, _, _ = tbn.batch_norm_train(tx, ts, tb)
    grads = torch.autograd.grad((y * torch.from_numpy(g)).sum(), (tx, ts, tb))
    dx, ds, db = (torch.from_numpy(a).double().requires_grad_(True) for a in (x, scale, bias))
    mean = dx.mean(dim=(0, 1, 2))
    var = dx.var(dim=(0, 1, 2), unbiased=False)
    ref = (dx - mean) * torch.rsqrt(var + 1e-5) * ds + db
    want = torch.autograd.grad((ref * torch.from_numpy(g).double()).sum(), (dx, ds, db))
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.double(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_module_running_update_matches_jax(dtype):
    """Two training-mode calls, then one in eval mode: the running mean and
    the biased running variance move as 0.9 * old + 0.1 * batch in both (f32
    sums in another order: 1e-5 relative); eval mode uses them."""
    x, _, scale, bias = _inputs(2, (4, 5, 5, 8), dtype)
    x2 = _inputs(3, (4, 5, 5, 8), dtype)[0]
    rng = np.random.default_rng(4)
    stats = {"mean": rng.normal(size=8).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    ref = jbn.TpuBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {k: jnp.asarray(v) for k, v in stats.items()}}
    for xi in (x, x2):
        _, upd = ref.apply(variables, jnp.asarray(xi, getattr(jnp, dtype)),
                           mutable=["batch_stats"])
        variables = {**variables, "batch_stats": upd["batch_stats"]}
    jeval = jbn.TpuBatchNorm(use_running_average=True).apply(
        variables, jnp.asarray(x, getattr(jnp, dtype)))

    port = tbn.BatchNorm(8)
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.mean.copy_(torch.from_numpy(stats["mean"]))
        port.var.copy_(torch.from_numpy(stats["var"]))
    port.train()
    for xi in (x, x2):
        port(_t(xi, dtype))
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(variables["batch_stats"][name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    port.eval()
    with torch.no_grad():
        got = port(_t(x, dtype))
    # Eval mode: one fused pass from the same statistics; bf16 rounds once.
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jeval, np.float32),
                               atol=1e-5 if dtype == "float32" else 3.2e-2)


def test_batch_norm_parameters_train_and_last_block_norm_starts_at_zero():
    from spine_vision_torch.models.resnet import BasicBlock

    block = BasicBlock(8, 8, 1)
    assert block.bn1.scale.requires_grad and block.bn1.bias.requires_grad
    assert torch.all(block.bn1.scale == 1) and torch.all(block.bn2.scale == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_pool_gradient_on_ties_matches_jax(dtype):
    """Inputs of a few levels (every window holds equal maxima), odd and even
    sizes: the gradient of relu(pool(x)) goes to the same element in both
    (the first maximum of a window), bit for bit."""
    rng = np.random.default_rng(5)
    for shape in ((2, 9, 9, 4), (1, 8, 10, 3)):
        x = rng.integers(-2, 3, size=shape).astype(np.float32)
        w = rng.normal(size=(shape[0], -(-shape[1] // 2), -(-shape[2] // 2), shape[3]))
        w = w.astype(np.float32)

        def j_loss(xx):
            y = fnn.max_pool(xx, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])
            return jnp.sum(jax.nn.relu(y).astype(jnp.float32) * w)

        jx = jnp.asarray(x, getattr(jnp, dtype))
        want = np.asarray(jax.grad(j_loss)(jx), np.float32)
        tx = _t(x, dtype).requires_grad_(True)
        (torch.relu(stem_pool(tx)).float() * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(tx.grad.float().numpy(), want)
