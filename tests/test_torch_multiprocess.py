"""The port's data parallelism across two real processes: a ``gloo`` group on
the CPU, one torch thread a process, no simulated ranks.

The module-scoped fixture builds the seeded ResNet-18, forks two ranks of
``tests/torch_mp_worker.py`` and a third process with the port's
single-process runs and, while they run, computes the JAX references in
the test process:

(a) A ResNet-18 ``CoordinateRegressor`` (f32, 32^2, weights carried from one
    seeded Flax-layout tree), one step of ``LocalizationTrainer``'s DDP step
    over a global batch of 8 whose halves hold different counts of visible
    levels, AdamW at lr 1e-3, no augmentation or dropout: against the JAX
    package's ``make_train_step`` on one device over the same global batch
    (params within ``tests/test_parallel.py``'s atol 2e-4 wherever the
    gradient is not within f32 rounding of 0, see that test; the loss within
    rtol 1e-5, the BatchNorm running statistics within 1e-5).
(b) The same model with augmentation and dropout on, ``train()`` for one
    epoch of two steps with validation over 5 images (a padded trailing
    batch), against the port's own single-process run: each rank's draws are
    its rows of the single process's, both ranks log the same losses, the
    params agree within the bound stated at ``UNSETTLED``, the validation
    loss is one process's on the same params, and rank 0's checkpoint loads
    in this process to rank 0's params.
(c) A hybrid ConvNeXt-tiny (the block's ``autograd.Function`` with its plain
    versions on the CPU) two DDP steps against the single-process steps.
(d) The synced BatchNorm alone: output, running statistics and gradients
    against the JAX ``TpuBatchNorm`` math on the global batch.
(e) ``ClassificationTrainer``: validation over 5 samples (rank 1 holds the
    padded batch's repeated row) and one step; both ranks log the same
    losses, and the validation loss is one process's on the same params.
"""

from __future__ import annotations

import json
import multiprocessing
import socket
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spine_vision_torch.data.loader import DataLoader, collate_localization
from spine_vision_tpu.models import CoordinateRegressor, make_coordinate_loss_fn
from spine_vision_tpu.ops import batchnorm as jbn
from spine_vision_tpu.ops.image import imagenet_normalize
from spine_vision_tpu.train.state import TrainState
from spine_vision_tpu.train.steps import make_train_step
from tests import torch_mp_worker as w
from tests.torch_mp_worker import GLOBAL_BATCH, LR, WD, WORLD

# Two runs of AdamW whose gradients differ by the order of their sums (the
# batch split over ranks, the convolutions' algorithms at another batch
# size): an Adam update is about lr * g / (|g| + 1e-8), at most about lr in
# size, so rounding moves it by a small fraction of lr unless g is within
# the gradients' error of 0, where it can take any value in [-lr, lr]. The
# share of such elements is about the gradients' relative error. So: every
# element within 2 lr a step, and at most UNSETTLED of the elements off by
# more than a fifth of lr. Here the f32 gradients differ by about 2e-5 of
# their norms, but at 32^2 ResNet-18's stages 3 and 4 are 2x2 and 1x1, and
# many of their kernels' taps see only padding: gradients that are 0 but for
# rounding (measured on this CPU after two steps: (b) 1.0e-3 of the
# elements, at most 1.73e-3 apart; (c) none, 1.7e-5 apart). chip_smoke.py's
# ddp phase applies the rule at full size with its gradients' bounds.
UNSETTLED = 1e-2
TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as the suite's other processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _references() -> dict:
    """The JAX package's results the ranks are held to."""
    ref: dict = {}
    # (d) the JAX BatchNorm on the global batch: its output and gradients
    # from one trace.
    x, g, scale, bias = (jnp.asarray(a) for a in w.bn_inputs())

    def bn_loss(xx, s, b):
        y, mean, var = jbn.batch_norm_train(xx, s, b)
        return jnp.sum(y * g), (y, mean, var)

    grads, (jy, jmean, jvar) = jax.jit(jax.grad(bn_loss, argnums=(0, 1, 2), has_aux=True))(
        x, scale, bias)
    ref["bn"] = {"y": np.asarray(jy), "dx": np.asarray(grads[0]),
                 "dscale": np.asarray(grads[1]), "dbias": np.asarray(grads[2]),
                 # TpuBatchNorm's running update, from its initial 0 and 1.
                 "mean": 0.1 * np.asarray(jmean), "var": 0.9 + 0.1 * np.asarray(jvar)}

    # (a) JAX's one-device step over the global batch the ranks share.
    params, stats = w.flax_variables()
    batch = next(iter(DataLoader(w.Samples(GLOBAL_BATCH, 0), GLOBAL_BATCH, shuffle=True,
                                 seed=w.LOADER_SEED, collate_fn=collate_localization,
                                 num_workers=1, process_index=0, process_count=1)))
    model = CoordinateRegressor(backbone_name="resnet18", dtype=jnp.float32, dropout=0.0)
    coord_loss = make_coordinate_loss_fn("smooth_l1")

    def j_pre(b, key, train):
        return {**b, "image": imagenet_normalize(b["image"].astype(jnp.float32) / 255.0)}

    step = make_train_step(model.apply, lambda out, b: coord_loss(out, b["coords"], b["mask"]),
                           has_batch_stats=True, preprocess=j_pre)
    tx = optax.adamw(LR, weight_decay=WD)
    state = jax.jit(lambda p, s: TrainState.create(params=p, tx=tx, batch_stats=s))(
        params, stats)
    jbatch = {k: jnp.asarray(batch[k]) for k in ("image", "coords", "mask")}
    state, loss = step(state, jbatch)
    ref["a_loss"] = float(loss)
    # After one step Adam's first moment is 0.1 * the gradient.
    ref["a_grad"] = w._flat(jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                                   state.opt_state[0].mu), "params")
    ref["a"] = {**w._flat(jax.tree_util.tree_map(np.asarray, state.params), "params"),
                **w._flat(jax.tree_util.tree_map(np.asarray, state.batch_stats), "batch_stats")}
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory, one_thread):
    """Both ranks' results, the single-process runs' and the references,
    from one launch. The processes are forked from this one (one torch
    thread, the seeded ResNet-18 the references need built), so they start
    without importing anything."""
    out = tmp_path_factory.mktemp("ranks")
    port = _free_port()
    w.flax_variables()
    fork = multiprocessing.get_context("fork")
    procs = [fork.Process(target=w.forked_rank, args=(rank, port, out))
             for rank in (*range(WORLD), -1)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        ref = _references()
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        if any(p.is_alive() for p in procs):
            pytest.fail(f"the ranks did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for rank, p in zip((*range(WORLD), -1), procs):
        log = (out / f"log{rank}.txt").read_text()
        assert p.exitcode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]
    ref.update(json.loads((out / "single.json").read_text()))
    ref["b"], ref["c"] = _load(out, "single_b.npz"), _load(out, "single_c.npz")
    ref["b_draws"] = list(_load(out, "single_b_draws.npz").values())
    return out, ranks, ref


def _load(out: Path, name: str) -> dict:
    with np.load(out / name) as f:
        return dict(f)


def check_adam_params(got: dict, want: dict, lr: float, steps: int) -> tuple[float, float]:
    """Hold ``got``'s parameters to ``want``'s after ``steps`` AdamW updates
    at ``lr`` whose gradients differ by rounding (see ``UNSETTLED``); return
    the largest gap and the share of elements off by more than lr / 5."""
    assert got.keys() == want.keys()
    gaps = [np.abs(got[k] - want[k]) for k in want if k.startswith("params")]
    largest = max(float(g.max()) for g in gaps)
    share = sum(int((g > 0.2 * lr).sum()) for g in gaps) / sum(g.size for g in gaps)
    assert largest <= 2 * lr * steps, largest
    assert share <= UNSETTLED, share
    return largest, share


def test_synced_batchnorm_matches_jax_on_the_global_batch(run):
    out, _, ref = run
    bn = [_load(out, f"bn{r}.npz") for r in range(WORLD)]
    want = ref["bn"]
    # f32 sums over 96 rows per channel in another order: 1e-5.
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([b[key] for b in bn]), want[key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("dscale", "dbias"):  # each rank's share; the DDP average sums them
        np.testing.assert_allclose(sum(b[key] for b in bn), want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
        assert not np.allclose(bn[0][key], bn[1][key]), key
    for key in ("mean", "var"):  # the global batch's statistics, the same on both ranks
        np.testing.assert_array_equal(bn[0][key], bn[1][key])
        np.testing.assert_allclose(bn[0][key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_ddp_resnet18_step_matches_jax_one_device(run):
    out, ranks, ref = run
    # The ranks' halves hold different counts of visible levels, so a loss
    # normalised by each rank's own count would differ from JAX's.
    assert ranks[0]["a_local_count"] != ranks[1]["a_local_count"]
    for r in ranks:
        assert r["a_loss"] == pytest.approx(ref["a_loss"], rel=1e-5)
    got = [_load(out, f"a{r}.npz") for r in range(WORLD)]
    for key in got[0]:
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    want = ref["a"]
    assert got[0].keys() == want.keys()
    for key, value in want.items():
        if key.startswith("params"):
            # tests/test_parallel.py's bound, a fifth of one lr-sized update,
            # where the gradient is settled. The port's and JAX's f32
            # gradients differ by about 2e-5 of each tensor's norm (the same
            # in the port's single-process step); the first Adam update is
            # lr * g / (|g| + 1e-8), so an element whose gradient is within
            # that noise of 0 (below 1e-4 of the tensor's largest; the ones
            # past 2e-4 here sit below 7e-6 of it) can move by up to 2 lr.
            grad = np.abs(ref["a_grad"][key])
            settled = grad >= 1e-4 * grad.max()
            np.testing.assert_allclose(got[0][key][settled], value[settled], atol=2e-4,
                                       err_msg=key)
            assert np.abs(got[0][key] - value).max() <= 2 * LR, key
        else:  # 0.9 * old + 0.1 * the global batch's f32 moments
            np.testing.assert_allclose(got[0][key], value, rtol=1e-5, atol=1e-5, err_msg=key)


def test_draws_are_the_global_batch_rows_of_one_process(run):
    """Augmentation and dropout draw for the global batch: each rank's draws
    are its rows of the single process's, and the two ranks' differ."""
    out, _, ref = run
    draws = [list(_load(out, f"b_draws{r}.npz").values()) for r in range(WORLD)]
    want = ref["b_draws"]
    # Per step: 7 augmentation draws (6 uniforms and the flip), 2 dropouts.
    assert len(draws[0]) == len(draws[1]) == len(want) == 2 * 9
    for k, full in enumerate(want):
        assert not np.array_equal(draws[0][k], draws[1][k]), k
        np.testing.assert_array_equal(np.concatenate([draws[0][k], draws[1][k]]), full,
                                      err_msg=str(k))


def test_ddp_trainer_matches_single_process_run(run):
    out, ranks, ref = run
    h0, h1 = ranks[0]["b_history"], ranks[1]["b_history"]
    assert h0["train_loss"] == h1["train_loss"] and h0["val_loss"] == h1["val_loss"]
    assert "med" not in h0 and "med" in ref["b_history"]  # metrics: one process only
    # The epoch's mean holds the second step's loss, whose params differ as
    # stated at UNSETTLED: 1e-3 relative (measured 5.9e-5).
    assert h0["train_loss"] == pytest.approx(ref["b_history"]["train_loss"], rel=1e-3)
    got = [_load(out, f"b{r}.npz") for r in range(WORLD)]
    for key in got[0]:
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    check_adam_params(got[0], ref["b"], LR, steps=2)


@pytest.fixture(scope="module")
def rank0_model(run):
    """Rank 0's checkpoint of (b), loaded in this process."""
    from spine_vision_torch.train.checkpoint import load_model_state

    model = w.model(dropout=0.2)
    load_model_state(run[0] / "run_b" / "best_model", model)
    return model


def test_ddp_validation_loss_weights_the_padded_batch_by_global_counts(run, rank0_model):
    """The ranks' validation loss over 5 images (padded to 6, the repeated
    row masked out on rank 1) equals one process's on the same params."""
    out, ranks, _ = run
    trainer = w.trainer(w.config(out / "val_single"), rank0_model, w.Samples(GLOBAL_BATCH, 1),
                        w.Samples(5, 2))
    val_loss, metrics = trainer._validate_epoch()
    assert "med" in metrics
    # The same params, sums over 5 rows in another order: 1e-6.
    assert ranks[0]["b_history"]["val_loss"][0] == pytest.approx(val_loss, rel=1e-6)


def test_rank0_checkpoint_loads_in_one_process(run, rank0_model):
    out, _, _ = run
    saved = _load(out, "b0.npz")
    for key, value in w.variables(rank0_model).items():
        np.testing.assert_array_equal(value, saved[key], err_msg=key)
    assert (out / "run_b" / "config.yaml").exists()


def test_ddp_hybrid_convnext_block_matches_single_process(run):
    out, ranks, ref = run
    assert ranks[0]["c_losses"] == ranks[1]["c_losses"]
    assert ranks[0]["c_losses"][0] == pytest.approx(ref["c_losses"][0], rel=1e-5)
    assert ranks[0]["c_losses"][1] == pytest.approx(ref["c_losses"][1], rel=1e-3)
    check_adam_params(_load(out, "c0.npz"), ref["c"], LR, steps=2)



def test_ddp_classification_validation_matches_one_process(run):
    """The classification trainer over two ranks: the padded validation
    batch's repeated row (on rank 1) weighs nothing, both ranks take the
    same collectives and log the same losses, and the validation loss is
    one process's on the same params."""
    out, ranks, _ = run
    assert ranks[0]["cls_val_loss"] == ranks[1]["cls_val_loss"]
    assert ranks[0]["cls_losses"] == ranks[1]["cls_losses"]
    val_loss, metrics = w.cls_trainer(out / "cls_single")._validate_epoch()
    assert "f1" in metrics or "macro_f1" in metrics
    # The same params, sums over 5 rows in another order: 1e-6.
    assert ranks[0]["cls_val_loss"] == pytest.approx(val_loss, rel=1e-6)
