"""Port's classification metrics and classification data path against the
JAX package's.

``roc_auc``, ``macro_ovr_auc``, ``ClassificationMetrics`` and
``ClassifierMetrics`` on the same seeded predictions (ties, single-class
splits and their NaN AUCs included) give the same numbers (float64 host
math in the same order: 1e-12); the weighted loader draws the same index
stream, and ``collate_classification`` the same batches.
"""

import numpy as np
import pytest

from spine_vision_torch import metrics as tm
from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, get_task
from spine_vision_torch.data import loader as tl
from spine_vision_tpu import metrics as jm
from spine_vision_tpu.data import loader as jl
from spine_vision_tpu.data.datasets import collate_classification as j_collate

TOL = 1e-12


def _close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("case", ["random", "ties", "one_class", "perfect"])
def test_auc_matches_jax(case):
    rng = np.random.default_rng(0)
    scores = rng.normal(size=40)
    labels = rng.integers(0, 2, 40)
    if case == "ties":
        scores = np.round(scores)
    elif case == "one_class":
        labels = np.ones(40, int)
    elif case == "perfect":
        scores = labels + 0.1 * rng.uniform(size=40)
    got, want = tm.roc_auc(scores, labels), jm.roc_auc(scores, labels)
    assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want, abs=TOL)
    probs = rng.dirichlet(np.ones(4), size=40)
    targets = rng.integers(0, 4, 40) if case != "one_class" else np.full(40, 2)
    if case == "ties":
        probs = np.round(probs, 1)
    got, want = tm.macro_ovr_auc(probs, targets), jm.macro_ovr_auc(probs, targets)
    assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want, abs=TOL)


@pytest.mark.parametrize("absent", [False, True])
def test_classification_metrics_match_jax(absent):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(50, 5))
    targets = rng.integers(0, 4 if absent else 5, 50)  # class 4 never a target
    names = [f"c{i}" for i in range(5)]
    port, ref = tm.ClassificationMetrics(5, names), jm.ClassificationMetrics(5, names)
    for sl in (slice(0, 20), slice(20, 50)):
        port.update(logits[sl], targets[sl])
        ref.update(logits[sl], targets[sl])
    _close(port.compute(), ref.compute())
    _close(port.compute(logits.argmax(1), targets), ref.compute(logits.argmax(1), targets))
    port.reset()
    assert port.compute() == {} == jm.ClassificationMetrics(5).compute()


def _outputs(rng, n, labels, single_class=()):
    preds, targets = {}, {}
    for name in labels:
        task = get_task(name)
        preds[name] = (rng.normal(size=(n, task.num_classes)) * 2).astype(np.float32)
        k = task.num_classes if task.is_multiclass else 2
        t = rng.integers(0, k, n)
        if name in single_class:
            t = np.zeros(n, int)
        targets[name] = t.astype(np.int32 if task.is_multiclass else np.float32)
    return preds, targets


@pytest.mark.parametrize(
    "labels,single_class",
    [(None, ()), (None, ("herniation", "modic")), (["pfirrmann"], ()), (["spondy"], ()),
     (["spondy"], ("spondy",)), (["modic", "narrowing"], ("modic",))],
    ids=["all", "all_one_class", "pfirrmann", "spondy", "spondy_one_class", "two"],
)
def test_classifier_metrics_match_jax(labels, single_class):
    """Batches of logits and targets; a task whose split holds one class
    only has no AUC (the JAX package leaves it out of ``macro_auc``)."""
    rng = np.random.default_rng(2)
    names = list(AVAILABLE_TASK_NAMES) if labels is None else labels
    port = tm.ClassifierMetrics(target_labels=labels)
    ref = jm.ClassifierMetrics(target_labels=labels)
    for n in (16, 9):
        preds, targets = _outputs(rng, n, names, single_class)
        port.update(preds, targets)
        ref.update(preds, targets)
    got, want = port.compute(), ref.compute()
    _close(got, want)
    for name in single_class:
        assert f"{name}_auc" not in got
    assert ("f1" in got) == (len(names) == 1) and ("macro_f1" in got) == (len(names) > 1)
    port.reset()
    ref.reset()
    _close(port.compute(), ref.compute())


class _Labels:
    def __init__(self, labels):
        self.labels = labels

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"i": np.asarray([i])}


@pytest.mark.parametrize("n,batch", [(23, 4), (16, 16)])
def test_weighted_loader_index_stream_matches_jax(n, batch):
    labels = np.random.default_rng(n).integers(0, 3, n)
    labels[0] = 7  # a rare class
    weights = tl.compute_inverse_frequency_weights(labels)
    np.testing.assert_array_equal(weights, jl.compute_inverse_frequency_weights(labels))
    kw = dict(batch_size=batch, shuffle=True, seed=3, sample_weights=weights, num_workers=2)
    port = tl.DataLoader(_Labels(labels), **kw)
    ref = jl.DataLoader(_Labels(labels), process_index=0, process_count=1, **kw)
    assert len(port) == len(ref)
    for epoch in (0, 1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = [b["i"].ravel().tolist() for b in port]
        assert got == [b["i"].ravel().tolist() for b in ref]
        assert len({i for b in got for i in b}) < n or n <= batch  # with replacement


def test_collate_classification_matches_jax():
    rng = np.random.default_rng(4)
    samples = [{"image": rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                "targets": {name: int(rng.integers(0, 2)) for name in AVAILABLE_TASK_NAMES},
                "level_idx": i % 5, "metadata": {"id": i}} for i in range(3)]
    got, want = tl.collate_classification(samples), j_collate(samples)
    assert got.keys() == want.keys() and got["metadata"] == want["metadata"]
    for key in ("image", "level_idx"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    for name, value in want["targets"].items():
        assert got["targets"][name].dtype == value.dtype, name
        np.testing.assert_array_equal(got["targets"][name], value)
