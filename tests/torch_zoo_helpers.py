"""Shared helpers of the ``test_torch_zoo_*`` files: one module of the JAX
package and its port on the same seeded Flax-layout weights.

Weights are seeded numpy trees (``random_flax_variables`` of the port's
module), checked leaf for leaf against ``jax.eval_shape`` of the JAX
module's init, applied by JAX as they are and carried into the port by
``load_flax_variables``. Each comparison states its bound relative to the
output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spine_vision_torch.models.convert import (
    _entries,
    export_flax_variables,
    load_flax_variables,
    random_flax_variables,
)

torch.set_num_threads(1)


def shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def port_shapes(module):
    """``{"params": ..., "batch_stats": ...}`` trees of the Flax shapes of a
    port module's variables (no values drawn: a meta-device build will do)."""
    trees = {"params": {}, "batch_stats": {}}
    for e in _entries(module):
        node = trees[e.collection]
        for key in e.path[:-1]:
            node = node.setdefault(key, {})
        node[e.path[-1]] = e.flax_shape
    return trees


def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in leaves}


def carry(port, ref, x_shape, seed, **init_kw):
    """Seeded ``(params, batch_stats)`` loaded into ``port``, checked against
    ``ref``'s init tree; returns the JAX variables."""
    params, stats = random_flax_variables(port, seed)
    init = jax.eval_shape(
        lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), **init_kw))
    assert shapes(params) == shapes(init["params"])
    assert shapes(stats) == shapes(init.get("batch_stats", {}))
    load_flax_variables(port, params, stats)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return variables


def images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def forward_pair(port, ref, x, variables, train=False, **apply_kw):
    """Both modules on ``x`` (numpy): ``(port out, JAX out, JAX updates)``;
    in training mode the port's running statistics move as JAX's mutable
    ``batch_stats`` apply does. The JAX apply is jitted (op-by-op dispatch
    costs several times the compile on the CPU)."""
    if train:
        want, upd = jax.jit(lambda v, a: ref.apply(
            v, a, train=True, mutable=["batch_stats"], **apply_kw))(variables, jnp.asarray(x))
        port.train()
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        port.eval()
        return got, want, upd
    want = jax.jit(lambda v, a: ref.apply(v, a, train=False, **apply_kw))(
        variables, jnp.asarray(x))
    port.eval()
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    return got, want, None


def check_stats(port, upd, rtol=1e-5, atol=1e-5):
    """The port's running statistics against JAX's updated ``batch_stats``."""
    got = flat(export_flax_variables(port)[1])
    want = flat(upd["batch_stats"])
    assert got.keys() == want.keys() and got
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol, err_msg=path)


LR, WD, CLIP = 1e-3, 1e-5, 1.0


def _cls_batch(seed, n, hw):
    from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, get_task

    rng = np.random.default_rng(seed)
    targets = {}
    for name in AVAILABLE_TASK_NAMES:
        task = get_task(name)
        if task.is_multiclass:
            targets[name] = rng.integers(0, task.num_classes, n).astype(np.int32)
        else:
            targets[name] = rng.integers(0, 2, n).astype(np.float32)
    return {"image": rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8), "targets": targets}


def train_step_pair(monkeypatch, make_port, make_ref, dim, seed, n=2, hw=32):
    """One f32 classification train step (dropout 0, no augmentation,
    clipping, AdamW) of a ``Classifier`` over the port's backbone and over
    the JAX one, from the same weights: ``(port loss, JAX loss, port model,
    port state, JAX state)``."""
    import optax

    import spine_vision_torch.models.classifier as tcls
    import spine_vision_tpu.models.classifier as jcls
    from spine_vision_torch.models.classifier import make_multitask_loss_fn as t_multitask
    from spine_vision_torch.ops.image import imagenet_normalize as t_normalize
    from spine_vision_torch.train import schedules as tsched
    from spine_vision_torch.train.classification import create_tasks_for_training as t_create
    from spine_vision_torch.train.state import TrainState as TState
    from spine_vision_torch.train.steps import train_step as t_train_step
    from spine_vision_tpu.models.classifier import make_multitask_loss_fn as j_multitask
    from spine_vision_tpu.ops.image import imagenet_normalize as j_normalize
    from spine_vision_tpu.train.classification import create_tasks_for_training as j_create
    from spine_vision_tpu.train.state import TrainState as JState
    from spine_vision_tpu.train.steps import make_train_step

    monkeypatch.setattr(tcls, "create_backbone", lambda *a, **k: (make_port(), dim))

    class _Factory:
        @staticmethod
        def create(*a, **k):
            return make_ref(), dim

    monkeypatch.setattr(jcls, "BackboneFactory", _Factory)
    port = tcls.Classifier("zoo", tasks=tuple(t_create()), dtype=torch.float32, device="cpu",
                           dropout=0.0, param_dtype=torch.float32)
    ref = jcls.Classifier(backbone_name="zoo", tasks=tuple(j_create()), dtype=jnp.float32,
                          dropout=0.0)
    variables = carry(port, ref, (1, hw, hw, 3), seed)
    state = TState(model=port, optimizer=tsched.build_optimizer(port.parameters(), LR, WD),
                   schedule=lambda count: LR, generator=torch.Generator().manual_seed(0),
                   grad_clip=CLIP)
    t_loss = t_multitask(t_create())
    j_loss = j_multitask(j_create())
    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=WD))
    jstate = JState.create(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                           tx=tx, batch_stats=jax.tree_util.tree_map(
                               jnp.asarray, variables.get("batch_stats", {})))
    step = make_train_step(
        ref.apply, lambda out, b: j_loss(out, b["targets"]),
        has_batch_stats="batch_stats" in variables,
        preprocess=lambda b, key, train: {
            **b, "image": j_normalize(b["image"].astype(jnp.float32) / 255.0)})
    batch = _cls_batch(seed + 1, n, hw)
    jstate, jloss = step(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    tloss = t_train_step(state, batch, lambda out, b: t_loss(out, b["targets"]),
                         lambda b, g, train: {**b, "image": t_normalize(b["image"].float() / 255.0)})
    return float(tloss), float(jloss), port, state, jstate


def check_step(port, state, jstate, atol=0.1 * LR, worst=5e-2, median=1e-3):
    """Adam's first moments (the clipped gradients) each within ``worst`` of
    its tensor's norm and their median within ``median``; each parameter
    within ``atol`` where its moment's sign is settled (|mu| above a quarter
    of the tensor's largest) and within two Adam steps everywhere; the
    running statistics within 1e-5 (``tests/test_torch_cls_step.py``'s
    bounds and reasons)."""
    grads = {id(p): p.grad for p in port.parameters()}
    for p in port.parameters():
        p.grad = state.optimizer.state[p]["exp_avg"]
    got_m = flat(export_flax_variables(port, grads=True)[0])
    for p in port.parameters():
        p.grad = grads[id(p)]
    want_m = flat(jstate.opt_state[1][0].mu)
    assert got_m.keys() == want_m.keys()
    # Some gradients are 0 in exact arithmetic and rounding noise in both
    # packages: the attention's key bias adds the same logit to every key of
    # a query, which the softmax cancels; a BatchNorm bias that reaches the
    # next training BatchNorm through linear layers only is cancelled by its
    # batch mean (8e-8 of the largest norm measured). Norms below 1e-5 of
    # the largest tensor's count as that floor.
    floor = 1e-5 * max(np.linalg.norm(w) for w in want_m.values())
    errs = {k: np.linalg.norm(got_m[k] - w) / max(np.linalg.norm(w), floor)
            for k, w in want_m.items()}
    assert max(errs.values()) <= worst, max(errs.items(), key=lambda kv: kv[1])
    assert np.median(list(errs.values())) <= median, np.median(list(errs.values()))
    params, stats = export_flax_variables(port)
    got, want = flat(params), flat(jstate.params)
    for k, w in want.items():
        mu = np.abs(want_m[k])
        # A gradient that is rounding noise has no settled sign.
        settled = (mu > 0.25 * mu.max()) & (np.linalg.norm(want_m[k]) > floor)
        np.testing.assert_allclose(got[k][settled], w[settled], atol=atol, err_msg=k)
        assert np.abs(got[k] - w).max() <= 2 * LR + atol, k
    got_s, want_s = flat(stats), flat(jstate.batch_stats or {})
    assert got_s.keys() == want_s.keys()
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
    return errs
