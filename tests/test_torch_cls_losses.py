"""Port's task losses and multi-task loss against the JAX package's.

Every registered task's loss and per-sample loss, with the training-time
overrides (label smoothing, focal loss), plus the multilabel, ordinal and
regression strategies; ``make_multitask_loss_fn`` with and without
``sample_weight``, and the per-task breakdown. The same seeded numpy logits
and targets go to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.core import tasks as ttasks
from spine_vision_torch.models.classifier import (
    make_multitask_loss_breakdown_fn as t_breakdown,
)
from spine_vision_torch.models.classifier import make_multitask_loss_fn as t_multitask
from spine_vision_torch.train.classification import create_tasks_for_training as t_create
from spine_vision_tpu.core import tasks as jtasks
from spine_vision_tpu.models.classifier import (
    make_multitask_loss_breakdown_fn as j_breakdown,
)
from spine_vision_tpu.models.classifier import make_multitask_loss_fn as j_multitask
from spine_vision_tpu.train.classification import create_tasks_for_training as j_create

# f32 log-sigmoid / log-softmax and means in two libraries: 1e-6 relative.
RTOL = 1e-6

OVERRIDES = {
    "plain": {},
    "smoothing": {"label_smoothing": 0.1},
    "focal": {"use_focal_loss": True, "focal_gamma": 2.0, "focal_alpha": 0.25},
    "focal_no_alpha": {"use_focal_loss": True, "focal_gamma": 1.5},
}
EXTRA_TASKS = {  # task types the registry does not hold: (num_classes, type)
    "labels3": (3, "multilabel"),
    "grade": (4, "ordinal"),
    "size": (2, "regression"),
}


def _data(task, n, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, task.num_classes)) * 2).astype(np.float32)
    if task.task_type in ("multiclass", "ordinal"):
        targets = rng.integers(0, task.num_classes, n).astype(np.int32)
    elif task.task_type == "binary":
        targets = rng.integers(0, 2, n).astype(np.float32)
    elif task.task_type == "multilabel":
        targets = rng.integers(0, 2, (n, task.num_classes)).astype(np.float32)
    else:
        targets = rng.normal(size=(n, task.num_classes)).astype(np.float32)
    return logits, targets


def _pair(name, overrides):
    if name in EXTRA_TASKS:
        c, kind = EXTRA_TASKS[name]
        return (ttasks.TaskConfig(name, c, kind).with_overrides(**overrides),
                jtasks.TaskConfig(name, c, kind).with_overrides(**overrides))
    return (ttasks.get_task(name).with_overrides(**overrides),
            jtasks.get_task(name).with_overrides(**overrides))


@pytest.mark.parametrize("overrides", list(OVERRIDES))
@pytest.mark.parametrize("name", list(ttasks.AVAILABLE_TASK_NAMES) + list(EXTRA_TASKS))
def test_task_losses_match_jax(name, overrides):
    tt, jt = _pair(name, OVERRIDES[overrides])
    logits, targets = _data(tt, 7, seed=len(name))
    ts, js = ttasks.get_strategy(tt), jtasks.get_strategy(jt)
    t_target = ts.format_target(torch.from_numpy(targets))
    j_target = js.format_target(targets)
    assert tuple(t_target.shape) == tuple(j_target.shape)
    for t_fn, j_fn in ((ts.loss_fn(tt), js.loss_fn(jt)),
                       (ts.per_sample_loss_fn(tt), js.per_sample_loss_fn(jt))):
        got = t_fn(torch.from_numpy(logits), t_target)
        want = np.asarray(j_fn(jnp.asarray(logits), j_target))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)


def test_bf16_logits_compute_in_f32():
    task = ttasks.get_task("pfirrmann")
    logits, targets = _data(task, 5, 0)
    lb = torch.from_numpy(logits).bfloat16()
    strategy = ttasks.get_strategy(task)
    got = strategy.loss_fn(task)(lb, strategy.format_target(torch.from_numpy(targets)))
    want = strategy.loss_fn(task)(lb.float(), strategy.format_target(torch.from_numpy(targets)))
    assert got.dtype == torch.float32 and got.item() == want.item()


def test_registry_and_training_overrides_match_jax():
    assert ttasks.AVAILABLE_TASK_NAMES == jtasks.AVAILABLE_TASK_NAMES
    for kw in ({}, {"target_labels": ["modic", "spondy"], "label_smoothing": 0.2,
                    "use_focal_loss": True, "focal_alpha": 0.3}):
        got, want = t_create(**kw), j_create(**kw)
        assert [(t.name, t.task_type, t.num_classes, t.label_smoothing, t.use_focal_loss,
                 t.focal_gamma, t.focal_alpha, t.loss_weight, t.is_binary, t.is_multiclass)
                for t in got] == [
                (t.name, t.task_type, t.num_classes, t.label_smoothing, t.use_focal_loss,
                 t.focal_gamma, t.focal_alpha, t.loss_weight, t.is_binary, t.is_multiclass)
                for t in want]
    for bad in (["nope"], ["modic", "modic"]):
        with pytest.raises(ValueError):
            t_create(target_labels=bad)


@pytest.mark.parametrize("weighted", ["none", "ones", "padded"])
def test_multitask_loss_matches_jax(weighted):
    """All 8 tasks with the training overrides (focal on the binary tasks,
    one of weight 2), and a task missing from the targets; the weighted form
    with all-ones weights and with the last two rows zeroed (padding)."""
    kw = {"label_smoothing": 0.1, "use_focal_loss": True, "focal_alpha": 0.25}
    t_tasks, j_tasks = t_create(**kw), j_create(**kw)
    t_tasks[2] = t_tasks[2].with_overrides(loss_weight=2.0)
    j_tasks[2] = j_tasks[2].with_overrides(loss_weight=2.0)
    n = 6
    preds, targets = {}, {}
    for i, task in enumerate(t_tasks):
        preds[task.name], targets[task.name] = _data(task, n, 10 + i)
    del targets["bulging"]
    sw = {"none": None, "ones": np.ones(n, np.float32),
          "padded": np.array([1, 1, 1, 1, 0, 0], np.float32)}[weighted]
    got = t_multitask(t_tasks)(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()},
        sample_weight=None if sw is None else torch.from_numpy(sw),
    )
    want = j_multitask(j_tasks)(
        {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in targets.items()},
        sample_weight=None if sw is None else jnp.asarray(sw),
    )
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)

    got_b = t_breakdown(t_tasks)({k: torch.from_numpy(v) for k, v in preds.items()},
                                 {k: torch.from_numpy(v) for k, v in targets.items()})
    want_b = j_breakdown(j_tasks)({k: jnp.asarray(v) for k, v in preds.items()},
                                  {k: jnp.asarray(v) for k, v in targets.items()})
    assert got_b.keys() == want_b.keys() and "bulging" not in got_b
    for name, value in want_b.items():
        np.testing.assert_allclose(got_b[name].item(), float(value), rtol=RTOL, err_msg=name)


def test_multitask_loss_gradient_matches_a_padded_batch_dropped():
    """Zero sample weights remove rows exactly: the loss and its gradient
    equal those of the batch without them."""
    tasks = t_create()
    preds, targets = {}, {}
    for i, task in enumerate(tasks):
        p, t = _data(task, 5, 30 + i)
        preds[task.name], targets[task.name] = torch.from_numpy(p), torch.from_numpy(t)
    fn = t_multitask(tasks)
    full = {k: v.clone().requires_grad_(True) for k, v in preds.items()}
    w = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0])
    loss = fn(full, targets, sample_weight=w)
    loss.backward()
    head = {k: v[:3].clone().requires_grad_(True) for k, v in preds.items()}
    want = fn(head, {k: v[:3] for k, v in targets.items()})
    want.backward()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    for k in preds:
        torch.testing.assert_close(full[k].grad[:3], head[k].grad, rtol=1e-6, atol=1e-8)
        assert torch.all(full[k].grad[3:] == 0)
