"""The port's ResNet family and ``ops/pool.py`` against the JAX package's.

Small custom configurations of ``ResNetConfig`` (two stages of one block)
cover each code path of the family: bottleneck, grouped (ResNeXt), widened
(WideResNet), the RS deep stem with squeeze-excitation, and
``norm_impl="flax"`` with ``pool_impl="tpu"``. Each runs in eval mode at
f32 and bf16 and in training mode at f32 (the output and the running
statistics against JAX's ``mutable=["batch_stats"]`` apply), then one
classification train step. ``max_pool`` is held bit for bit on exact ties,
where its gradient rule differs from ``F.max_pool2d``'s. Last, the repair:
both packages' ``Classifier()`` default to ResNet-50.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo_helpers import (
    carry,
    check_stats,
    check_step,
    forward_pair,
    images,
    port_shapes,
    rel_err,
    shapes,
    train_step_pair,
)

from spine_vision_torch.models import classifier as tcls
from spine_vision_torch.models import resnet as tr
from spine_vision_torch.models.layers import FlaxBatchNorm
from spine_vision_torch.ops.pool import max_pool as t_max_pool
from spine_vision_tpu.models import Classifier
from spine_vision_tpu.models import resnet as jr
from spine_vision_tpu.ops.pool import max_pool as j_max_pool

CASES = {
    "bottleneck": ({"block_type": "bottleneck"}, {}),
    "resnext": ({"block_type": "bottleneck", "cardinality": 4, "base_width": 8}, {}),
    "wide": ({"block_type": "bottleneck", "width_factor": 2}, {}),
    "rs": ({"block_type": "bottleneck", "deep_stem": True, "use_se": True}, {}),
    "flax_norm_tpu_pool": ({"block_type": "bottleneck"},
                           {"norm_impl": "flax", "pool_impl": "tpu"}),
}


def _pair(case, dtype):
    fields, impl = CASES[case]
    cfg = {"stage_sizes": (1, 1), "num_features": 512, **fields}
    port = tr.ResNet(tr.ResNetConfig(**cfg), dtype=getattr(torch, dtype), **impl)
    ref = jr.ResNet(config=jr.ResNetConfig(**cfg), dtype=getattr(jnp, dtype), **impl)
    return port, ref


# f32 within 1e-4 of the features' largest magnitude (measured 1.7e-7 to
# 2.4e-7). bf16: convolutions round per layer in both, in sums of another
# order; within 5e-2, test_torch_models.py's ResNet-18 bound (measured 2.8e-3
# to 5.6e-3).
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resnet_variant_forward_matches_jax(case, dtype, bound):
    port, ref = _pair(case, dtype)
    variables = carry(port, ref, (1, 32, 32, 3), seed=1, train=False)
    got, want, _ = forward_pair(port, ref, images(2, (2, 32, 32, 3)), variables)
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    assert rel_err(got.numpy(), want) <= bound


@pytest.mark.parametrize("case", sorted(CASES))
def test_resnet_variant_training_mode_matches_jax(case):
    """Batch statistics in the forward (within 1e-5 of the largest feature,
    measured 2.1e-6 to 3.5e-6) and the running averages after it (within
    1e-5)."""
    port, ref = _pair(case, "float32")
    variables = carry(port, ref, (1, 32, 32, 3), seed=3, train=False)
    got, want, upd = forward_pair(port, ref, images(4, (4, 32, 32, 3)), variables, train=True)
    assert rel_err(got.numpy(), want) <= 1e-5
    check_stats(port, upd)


def test_resnet_train_step_matches_jax(monkeypatch):
    """One f32 step of a Classifier over the RS bottleneck with groups, Flax
    BatchNorm and the scatter-free pool: every path of the family's
    backward at once."""
    fields = {"stage_sizes": (1, 1), "block_type": "bottleneck", "cardinality": 2,
              "base_width": 32, "deep_stem": True, "use_se": True, "num_features": 512}
    impl = {"norm_impl": "flax", "pool_impl": "tpu"}
    tloss, jloss, port, state, jstate = train_step_pair(
        monkeypatch, lambda: tr.ResNet(tr.ResNetConfig(**fields), **impl),
        lambda: jr.ResNet(config=jr.ResNetConfig(**fields), dtype=jnp.float32, **impl),
        512, seed=7)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    check_step(port, state, jstate)


def _value_and_vjp(f, x, g):
    y, vjp = jax.vjp(f, x)
    return y, vjp(g)[0]


def _tied(seed, shape, dtype):
    """Small integers: many exact ties in every window."""
    return np.random.default_rng(seed).integers(-2, 3, shape).astype(dtype)


@pytest.mark.parametrize("geometry", [((3, 3), (2, 2), (1, 1)), ((2, 2), (2, 2), (0, 0)),
                                      ((3, 3), (1, 1), (1, 1))])
def test_max_pool_matches_jax_bit_for_bit_on_ties(geometry):
    window, strides, padding = geometry
    x = _tied(0, (2, 9, 11, 3), np.float32)
    g = np.random.default_rng(1).normal(size=(2, *[(n + 2 * p - w) // s + 1 for n, w, s, p in zip(
        (9, 11), window, strides, padding)], 3)).astype(np.float32)
    want, want_dx = jax.jit(lambda a, gy: _value_and_vjp(
        lambda b: j_max_pool(b, window, strides, padding), a, gy))(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = t_max_pool(xt, window, strides, padding)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))


def test_max_pool_sends_ties_everywhere_unlike_the_first_maximum_rule():
    """On a window of equal values the cotangent reaches every element;
    ``F.max_pool2d`` (the ``pool_impl="flax"`` stem) sends it to one."""
    x = torch.zeros(1, 4, 4, 1, requires_grad=True)
    t_max_pool(x).sum().backward()
    every = x.grad.clone()
    x.grad = None
    tr.stem_pool(x).sum().backward()
    first = x.grad
    assert every.sum() > first.sum() == 4  # 4 output windows
    assert (every > 0).sum() == 16 and (first > 0).sum() == 4
    x16 = torch.from_numpy(_tied(2, (1, 8, 8, 2), np.float32)).bfloat16().requires_grad_(True)
    y = t_max_pool(x16)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    want, dx = jax.jit(lambda a: _value_and_vjp(j_max_pool, a, jnp.ones(y.shape, jnp.bfloat16)))(
        jnp.asarray(x16.detach().float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(x16.grad.float().numpy(), np.asarray(dx, np.float32))


def test_classifier_defaults_to_resnet50_as_in_jax():
    """The repair: ``Classifier()`` builds ResNet-50 in both packages, with
    the same variable tree (names and shapes), built on the meta device."""
    with torch.device("meta"):
        port = tcls.Classifier(device="meta")
    assert port.feature_dim == 2048
    got = port_shapes(port)
    init = jax.eval_shape(lambda: Classifier().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    assert got["params"] == shapes(init["params"])
    assert got["batch_stats"] == shapes(init["batch_stats"])


_RANK = """
import sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from spine_vision_torch.models.layers import FlaxBatchNorm
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
x, g = (torch.from_numpy(a[rank * 3:(rank + 1) * 3]) for a in np.load(out + "/in.npy"))
bn = FlaxBatchNorm(5, momentum=0.9, dtype=torch.float32, round_grads=False)
bn.process_group = dist.group.WORLD
x.requires_grad_(True)
y = bn(x, True)
(y * g).sum().backward()
np.savez(f"{out}/rank{rank}.npz", y=y.detach().numpy(), dx=x.grad.numpy(),
         dscale=bn.scale.grad.numpy(), mean=bn.mean.numpy(), var=bn.var.numpy())
dist.destroy_process_group()
"""


def test_flax_batchnorm_syncs_over_the_process_group(tmp_path):
    """Two ``gloo`` ranks, each with half of a batch: the outputs, running
    statistics and input gradients are the whole batch's (the cotangents of
    the group's sums are summed over the group, so each rank's input
    gradient is the global loss's, which the data-parallel average of the
    weights' gradients expects); the scales' gradients are each rank's
    share of the whole batch's. Within 1e-5 (f64 sums in another order)."""
    import socket
    import subprocess
    import sys

    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (6, 4, 3, 5)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    np.save(tmp_path / "in.npy", np.stack([x, g]))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(port), str(tmp_path)])
             for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    bn = FlaxBatchNorm(5, momentum=0.9, dtype=torch.float32, round_grads=False)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, True)
    (y * torch.from_numpy(g)).sum().backward()
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), y.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]), xt.grad.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(ranks[0]["dscale"] + ranks[1]["dscale"], bn.scale.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], bn.mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(r["var"], bn.var.numpy(), atol=1e-5)
