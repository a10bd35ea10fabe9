"""One rank of ``tests/test_torch_multiprocess.py``, and the builders it
shares with that test. Imports torch and the port only.

A rank joins a two-process ``gloo`` group on 127.0.0.1 with one torch
thread and writes its results into ``out``; rank -1 runs the same trainers
in one process (:func:`single`). The test forks its ranks with
:func:`forked_rank` once the seeded models are built, so that a rank
neither imports nor builds again; ``python tests/torch_mp_worker.py <rank>
<port> <out>`` runs one from the shell.
"""

from __future__ import annotations

import copy
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

WORLD = 2
GLOBAL_BATCH = 8
HW = 32
LR, WD = 1e-3, 1e-4
MODEL_SEED = 7
LOADER_SEED = 3


class Samples:
    """Seeded in-memory localization samples: uint8 images, coords, and
    masks whose count of visible levels varies by sample (so the ranks'
    halves of a batch hold different counts)."""

    def __init__(self, n: int, seed: int) -> None:
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
        self.coords = rng.uniform(0.1, 0.9, (n, 5, 2)).astype(np.float32)
        self.mask = np.ones((n, 5), np.float32)
        for i in range(n):
            self.mask[i, : (i * i) % 5] = 0.0

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> dict:
        return {"image": self.images[i], "coords": self.coords[i], "mask": self.mask[i],
                "series_type_idx": 0, "metadata": {"image_path": f"{i}.png"}}


class Grades:
    """Seeded in-memory classification samples: a label per task, uniform
    over the task's classes."""

    def __init__(self, n: int, seed: int) -> None:
        from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, get_task

        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
        self.targets = {}
        for name in AVAILABLE_TASK_NAMES:
            task = get_task(name)
            self.targets[name] = rng.integers(0, task.num_classes if task.is_multiclass else 2, n)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> dict:
        return {"image": self.images[i], "targets": {k: v[i] for k, v in self.targets.items()},
                "level_idx": i % 5, "metadata": {"image_path": f"{i}.png"}}


_BUILT: dict = {}


def _seeded(kind: str):
    """The process's seeded f32 model ``kind`` ("resnet18" or
    "convnext_tiny" ``CoordinateRegressor``, "classifier" a ResNet-18
    ``Classifier``), built once: its modules on the meta device (no
    initial draws), then every parameter and BatchNorm statistic from the
    seeded Flax-layout tree, the same in every process."""
    if kind not in _BUILT:
        from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor
        from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables

        kw = dict(dtype=torch.float32, device="meta", param_dtype=torch.float32)
        with torch.device("meta"):
            built = (Classifier("resnet18", dropout=0.0, **kw) if kind == "classifier" else
                     CoordinateRegressor(kind, dropout=0.0, use_pallas="hybrid", **kw))
        built = built.to_empty(device="cpu")
        trees = random_flax_variables(built, MODEL_SEED)
        load_flax_variables(built, *trees)
        _BUILT[kind] = (built, trees)
    return _BUILT[kind]


def model(backbone: str = "resnet18", dropout: float = 0.0):
    """A fresh copy of the process's seeded ``CoordinateRegressor`` (see
    :func:`_seeded`) with ``dropout``."""
    out = copy.deepcopy(_seeded(backbone)[0])
    out.dropout = dropout
    return out


def flax_variables() -> tuple[dict, dict]:
    """The ResNet-18 regressor's ``(params, batch_stats)`` in the Flax layout."""
    return _seeded("resnet18")[1]


def config(run: Path, **kw):
    from spine_vision_torch.train.localization import LocalizationConfig

    base = dict(backbone="resnet18", image_size=(HW, HW), batch_size=GLOBAL_BATCH,
                num_epochs=1, output_path=run, num_workers=1, seed=LOADER_SEED, pretrained=False,
                learning_rate=LR, weight_decay=WD, grad_clip=None, scheduler_type="none",
                augment=False, mixed_precision=False, early_stopping=False)
    return LocalizationConfig(**{**base, **kw})


def trainer(cfg, net, train, val=()):
    from spine_vision_torch.train.localization import LocalizationTrainer

    return LocalizationTrainer(cfg, model=net, train_dataset=train, val_dataset=list(val),
                               device="cpu")


def cls_trainer(run: Path, **kw):
    """A ResNet-18 ``ClassificationTrainer`` (f32, the seeded classifier, no
    augmentation or dropout) on 8 training and 5 validation samples."""
    from spine_vision_torch.train.classification import (
        ClassificationConfig,
        ClassificationTrainer,
    )

    cfg = ClassificationConfig(
        backbone="resnet18", output_size=(HW, HW), batch_size=GLOBAL_BATCH, num_epochs=1,
        output_path=run, num_workers=1, seed=LOADER_SEED, pretrained=False, learning_rate=LR,
        weight_decay=WD, grad_clip=None, scheduler_type="none", augment=False, dropout=0.0,
        mixed_precision=False, early_stopping=False, use_weighted_sampling=False, **kw)
    return ClassificationTrainer(cfg, model=copy.deepcopy(_seeded("classifier")[0]),
                                 train_dataset=Grades(GLOBAL_BATCH, 8),
                                 val_dataset=Grades(5, 9), device="cpu")


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        out.update(_flat(value, name) if isinstance(value, dict) else {name: np.asarray(value)})
    return out


def variables(net) -> dict:
    """``net``'s parameters and BatchNorm statistics, flat, Flax names."""
    from spine_vision_torch.models.convert import export_flax_variables

    params, stats = export_flax_variables(net)
    return {**_flat(params, "params"), **_flat(stats, "batch_stats")}


def steps(tr, n: int) -> list[float]:
    """``n`` train steps over the trainer's loader; each step's group loss."""
    losses = []
    for _, batch in zip(range(n), tr.train_loader):
        loss = tr.train_step_fn(tr.state, batch)
        losses.append(float(tr._group_mean(loss)))
    return losses


class DrawLog:
    """Records every draw of ``ops/draws.py::rand`` made by the augmentation
    and the dropout, in order."""

    def __init__(self) -> None:
        from spine_vision_torch.models import classifier
        from spine_vision_torch.ops import augment, draws

        self.draws: list[np.ndarray] = []
        self._modules = (augment, classifier)

        def rand(*args, **kwargs):
            out = draws.rand(*args, **kwargs)
            self.draws.append(out.numpy().copy())
            return out

        for module in self._modules:
            module.rand = rand

    def close(self) -> None:
        from spine_vision_torch.ops import draws

        for module in self._modules:
            module.rand = draws.rand


def bn_inputs():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(GLOBAL_BATCH, 4, 3, 6)) * 2 + 1).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    return x, g, scale, bias


def single(out: Path) -> None:
    """The port's single-process runs of (b) and (c): their params and draws,
    histories and losses into ``out``."""
    log = DrawLog()
    try:
        tr = trainer(config(out / "single_b", augment=True, dropout=0.2), model(dropout=0.2),
                     Samples(2 * GLOBAL_BATCH, 1), Samples(5, 2))
        history = tr.train().history
    finally:
        log.close()
    np.savez(out / "single_b.npz", **variables(tr.model))
    np.savez(out / "single_b_draws.npz", *log.draws)
    tr = trainer(config(out / "single_c", backbone="convnext_tiny"), model("convnext_tiny"),
                 Samples(2 * GLOBAL_BATCH, 4))
    losses = steps(tr, 2)
    np.savez(out / "single_c.npz", **variables(tr.model))
    (out / "single.json").write_text(json.dumps({"b_history": history, "c_losses": losses}))


def worker(rank: int, port: int, out: Path) -> None:
    """One rank: (d), (a), (b), (c) and the classification run in that
    order, results into ``out``; rank -1 runs :func:`single` instead."""
    import torch.distributed as dist

    from spine_vision_torch.ops.batchnorm import BatchNorm
    from spine_vision_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    if rank < 0:
        single(out)
        return
    if not initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, backend="gloo"):
        raise RuntimeError("the rank found a process group before joining its own")
    b = GLOBAL_BATCH // WORLD
    rows = slice(rank * b, (rank + 1) * b)
    record: dict = {}

    # (d) the synced BatchNorm on this rank's rows.
    x, g, scale, bias = bn_inputs()
    bn = BatchNorm(6).train()
    bn.process_group = dist.group.WORLD
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(x[rows]).requires_grad_(True)
    y = bn(tx)
    (y * torch.from_numpy(g[rows])).sum().backward()
    np.savez(out / f"bn{rank}.npz", y=y.detach().numpy(), dx=tx.grad.numpy(),
             dscale=bn.scale.grad.numpy(), dbias=bn.bias.grad.numpy(), mean=bn.mean.numpy(),
             var=bn.var.numpy())

    # (a) one DDP step, no draws.
    tr = trainer(config(out / f"a{rank}", distributed=True), model(), Samples(GLOBAL_BATCH, 0))
    batch = next(iter(tr.train_loader))
    record["a_local_count"] = float(batch["mask"].sum())
    loss = tr.train_step_fn(tr.state, batch)
    record["a_loss"] = float(tr._group_mean(loss))
    np.savez(out / f"a{rank}.npz", **variables(tr.model))

    # (b) train() with augmentation and dropout, the draws recorded.
    log = DrawLog()
    cfg = config(out / "run_b", distributed=True, augment=True, dropout=0.2)
    tr = trainer(cfg, model(dropout=0.2), Samples(2 * GLOBAL_BATCH, 1), Samples(5, 2))
    record["b_history"] = tr.train().history
    log.close()
    np.savez(out / f"b{rank}.npz", **variables(tr.model))
    np.savez(out / f"b_draws{rank}.npz", *log.draws)

    # (c) the hybrid ConvNeXt-tiny block under the DDP reducer, two steps.
    tr = trainer(config(out / f"c{rank}", distributed=True, backbone="convnext_tiny"),
                 model("convnext_tiny"), Samples(2 * GLOBAL_BATCH, 4))
    record["c_losses"] = steps(tr, 2)
    np.savez(out / f"c{rank}.npz", **variables(tr.model))

    # The classification trainer: validation over 5 samples (padded to 6:
    # rank 1 holds the repeated row), then one step.
    tr = cls_trainer(out / f"cls{rank}", distributed=True)
    record["cls_val_loss"] = tr._validate_epoch()[0]
    record["cls_losses"] = steps(tr, 1)

    (out / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def forked_rank(rank: int, port: int, out: Path) -> None:
    """:func:`worker` in a forked process, its output into
    ``out/log{rank}.txt``."""
    log = os.open(out / f"log{rank}.txt", os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log, 1)
    os.dup2(log, 2)
    sys.stdout = os.fdopen(1, "w", buffering=1)
    sys.stderr = os.fdopen(2, "w", buffering=1)
    worker(rank, port, out)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
