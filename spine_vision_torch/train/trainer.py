"""Base trainer: epoch loop, validation, checkpointing, hooks.

Counterpart of ``spine_vision_tpu/train/trainer.py`` on one card:

- per-update schedules (cosine, step) and the plateau decay of the learning
  rate on a stalled validation loss;
- optional weighted sampling of the train set (``sample_weights``);
- a frozen backbone for the first ``freeze_backbone_epochs`` epochs
  (``frozen_backbone_at_start``, ``set_backbone_frozen``): its gradients
  and updates are zeroed, as in ``train/steps.py``;
- early stopping with ``patience`` and ``min_delta``; best-model gating on
  ``get_metric_for_checkpoint`` (lower is better), and the best model
  reloaded when training ends;
- the hooks ``on_train_begin``, ``on_epoch_begin(epoch)``,
  ``on_epoch_end(epoch, metrics)``, ``on_train_end(result)`` and ``history``;
- the run-dir layout of ``train/checkpoint.py`` with a ``config.yaml``;
- ``sample_cache_dir``: the train and validation sets decoded once into
  packed caches (``data/cache.py``) under ``<dir>/train`` and ``<dir>/val``,
  reused by later runs whose samples and seed match;
- ``pretrained_path``: the backbone's parameters and BatchNorm statistics
  replaced by a converted checkpoint (``models/convert.py``, an ``.npz``
  artifact or a torch state dict) after the state is built, leaf by leaf;
- ``profile_steps`` (each step's wall time, ``utils/profiling.py``'s
  ``StepTimer``) and ``profile_trace`` (a ``torch.profiler`` trace of the
  first epoch in ``logs/profile``);
- data parallelism, one process per device (``parallel/mesh.py``):
  ``distributed=True`` joins the process group (``torchrun``'s environment),
  each rank loads its slice of every global batch and trains a
  ``DistributedDataParallel`` replica on ``cuda:{LOCAL_RANK}``; its
  BatchNorms reduce over the group, its draws are the global batch's, the
  losses divide by global counts, and the logged train and validation
  losses are the group's, so every rank takes the same plateau, early-stop
  and best-model decisions. Validation weights each batch by its global
  count and computes metrics only at world size 1; rank 0 writes the
  checkpoints and configs, every rank loads them;
- ``use_tracker``: the experiment tracker (``viz/tracker.py``) on rank 0,
  its config snapshot, each epoch's metrics, the test metrics and the
  figures the visualizer saves, under ``logs/``.

``TrainingVisualizer`` (``viz/visualizer.py``, matplotlib) is loaded by the
trainers only when ``visualize_predictions`` is set
(:func:`training_visualizer`).
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from dataclasses import asdict, dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Generic, Literal, TypeVar

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from spine_vision_torch.core.config import BaseConfig
from spine_vision_torch.data.cache import packed_view
from spine_vision_torch.data.loader import DataLoader
from spine_vision_torch.device import resolve_device
from spine_vision_torch.models.convert import load_flax_variables, load_pretrained_backbone
from spine_vision_torch.ops.batchnorm import BatchNorm
from spine_vision_torch.ops.draws import DrawShard
from spine_vision_torch.parallel import MeshContext, initialize_distributed, make_mesh
from spine_vision_torch.train import schedules
from spine_vision_torch.train.checkpoint import load_checkpoint, save_checkpoint
from spine_vision_torch.train.state import TrainState
from spine_vision_torch.train.steps import eval_step, train_step
from spine_vision_torch.utils.profiling import StepTimer, trace_profile

logger = logging.getLogger("spine_vision_torch")


def generate_run_id() -> str:
    """Unique run ID: YYYYMMDD_HHMMSS_<short_uuid>."""
    return f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"


def to_host(outputs: torch.Tensor | dict[str, torch.Tensor]) -> Any:
    """A model's outputs (a tensor, or a classifier's ``{task: logits}``) as
    f32 numpy."""
    if isinstance(outputs, dict):
        return {k: v.float().cpu().numpy() for k, v in outputs.items()}
    return outputs.float().cpu().numpy()


def training_visualizer(config: "TrainingConfig"):
    """The ``TrainingVisualizer`` class for a trainer built with
    ``visualize_predictions``; an ``ImportError`` naming matplotlib and the
    option when matplotlib is not installed (the JAX trainers import it at
    construction too)."""
    try:
        from spine_vision_torch.viz.visualizer import TrainingVisualizer
    except ImportError as exc:
        raise ImportError(
            f"visualize_predictions=True draws its figures with matplotlib, which cannot be "
            f"imported here ({exc}); install matplotlib or set visualize_predictions=False"
        ) from exc
    return TrainingVisualizer


def trainer_mesh(config: "TrainingConfig", device: str | torch.device) -> MeshContext:
    """The data axis of a trainer: join the process group when
    ``config.distributed`` (gloo for a CPU ``device``), then this rank's
    context; ``"cuda"`` without an index is ``cuda:{LOCAL_RANK}``, which
    becomes the current device. A batch size the world size does not
    divide raises."""
    dev = torch.device(device)
    if config.distributed:
        initialize_distributed(backend="gloo" if dev.type == "cpu" else None)
    dev = resolve_device(dev)
    mesh = make_mesh(num_devices=config.num_devices,
                     device=None if dev.type == "cuda" and dev.index is None else dev)
    if mesh.device.type == "cuda" and mesh.world_size > 1:
        torch.cuda.set_device(mesh.device)
    if config.batch_size % mesh.data_axis_size != 0:
        raise ValueError(f"batch_size={config.batch_size} not divisible by data-parallel "
                         f"size {mesh.data_axis_size}")
    return mesh


EVALUATE_SINGLE_CONTROLLER = (
    "evaluate() is single-controller only; load the checkpoint in a single-process "
    "session to compute test metrics"
)


@dataclass
class TrainingConfig(BaseConfig):
    """Configuration for training (the JAX package's ``TrainingConfig``,
    with ``BaseConfig``'s ``verbose``, ``enable_file_log`` and ``log_path``).

    Output structure: ``weights/<task>/<run_id>/`` with ``best_model/``,
    ``checkpoint_epoch_N/``, ``config.yaml`` and ``logs/``; an explicit
    ``output_path`` is the run dir itself.
    """

    run_id: str = ""
    task: str = "training"

    data_path: Path = Path("data/processed/localization")
    output_path: Path | None = None
    checkpoint_path: Path | None = None

    batch_size: int = 32
    num_epochs: int = 15
    freeze_backbone_epochs: int = 0
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    grad_clip: float | None = 1.0

    scheduler_type: Literal["cosine", "step", "plateau", "none"] = "cosine"
    scheduler_patience: int = 10
    scheduler_step_size: int = 30
    scheduler_gamma: float = 0.1
    warmup_epochs: int = 0

    early_stopping: bool = True
    patience: int = 20
    min_delta: float = 1e-4

    val_split: float = 0.2
    val_frequency: int = 1

    num_devices: int | None = None
    distributed: bool = False
    num_workers: int = 8
    sample_cache_dir: Path | None = None
    """Decode-once packed sample cache (``data/cache.py``) of the train and
    validation sets, built on first use and reused while its fingerprint
    matches."""
    mixed_precision: bool = True
    """bf16 compute on f32 master weights."""

    log_frequency: int = 10
    save_frequency: int = 10

    pretrained_path: Path | None = None
    """The backbone's pretrained weights: an ``.npz`` artifact of
    ``models/convert.py::convert_checkpoint`` or a torch state-dict file
    converted on the fly."""

    profile_steps: bool = False
    """Record each train step's wall time (synchronising the card) in
    ``step_times``, and log the p50 and p95 each epoch."""
    profile_trace: bool = False
    """Trace the first training epoch with ``torch.profiler`` into
    ``logs/profile``."""

    use_tracker: bool = False
    tracker_project: str = "spine-vision-torch"
    tracker_run_name: str | None = None

    seed: int = 42

    def __post_init__(self) -> None:
        if self.scheduler_type not in ("cosine", "step", "plateau", "none"):
            raise ValueError(f"Unknown scheduler type: {self.scheduler_type}")
        for name in ("data_path", "output_path", "checkpoint_path", "sample_cache_dir",
                     "pretrained_path"):
            value = getattr(self, name)
            if value is not None and not isinstance(value, Path):
                setattr(self, name, Path(value))
        if not self.run_id:
            self.run_id = generate_run_id()
        if self.output_path is None:
            self.output_path = Path("weights") / self.task / self.run_id
        if self.use_tracker and self.tracker_run_name is None:
            self.tracker_run_name = self.run_id

    @property
    def logs_path(self) -> Path:
        return self.output_path / "logs"

    @property
    def config_path(self) -> Path:
        return self.output_path / "config.yaml"

    def to_dict(self) -> dict[str, Any]:
        """Fields with paths as strings and tuples as lists."""
        out = {}
        for key, value in asdict(self).items():
            if isinstance(value, Path):
                value = str(value)
            elif isinstance(value, tuple):
                value = list(value)
            out[key] = value
        return out

    def save_config(self) -> None:
        """Snapshot the config into the run dir, one ``key: value`` a line
        (values in JSON's syntax, which YAML reads)."""
        self.output_path.mkdir(parents=True, exist_ok=True)
        lines = [f"{k}: {json.dumps(v)}" for k, v in self.to_dict().items()]
        self.config_path.write_text("\n".join(lines) + "\n")
        logger.info("Saved config to: %s", self.config_path)


@dataclass
class TrainingResult:
    """Container for training results."""

    best_epoch: int
    best_metric: float
    final_train_loss: float
    final_val_loss: float
    history: dict[str, list[float]] = field(default_factory=dict)
    checkpoint_path: Path | None = None
    metadata: dict[str, Any] = field(default_factory=dict)


TConfig = TypeVar("TConfig", bound=TrainingConfig)


class BaseTrainer(Generic[TConfig]):
    """Trainer with the JAX package's loop, hook and checkpoint surface.

    Subclasses give the model, the loss over outputs, the device
    preprocessing and the metrics; this class owns the data axis, the
    loaders, the optimizer and schedule, the epoch loop, early stopping and
    checkpoints. ``train_step_fn(state, batch) -> loss`` is the step the loop
    calls. The data axis (``mesh_ctx``) is joined first; a subclass that
    builds its own model does so in :meth:`_build_model` on that axis's
    device, called when ``model`` is None.
    """

    find_unused_parameters = False
    """``DistributedDataParallel``'s option: True where a parameter can miss
    the loss in a step (a task head whose targets a batch lacks)."""

    def __init__(
        self,
        config: TConfig,
        model: torch.nn.Module | None,
        train_dataset: Any,
        val_dataset: Any | None = None,
        collate_fn: Callable | None = None,
        device: str | torch.device = "cuda",
        sample_weights: np.ndarray | None = None,
    ) -> None:
        self.config = config
        self.mesh_ctx = mesh = trainer_mesh(config, device)
        self.device = mesh.device
        if model is None:
            model = self._build_model(mesh.device)
        # Draws for the global batch once the world is above 1.
        self._draw_shard = DrawShard(mesh.rank, mesh.world_size) if mesh.world_size > 1 else None
        self.model = model
        self._collate_fn = collate_fn

        if config.sample_cache_dir is not None:
            token = f"{type(train_dataset).__name__}:{config.seed}"
            train_dataset = packed_view(
                train_dataset, config.sample_cache_dir / "train",
                num_workers=config.num_workers, fingerprint_token=token + ":train",
            )
            if val_dataset is not None and len(val_dataset) > 0:
                val_dataset = packed_view(
                    val_dataset, config.sample_cache_dir / "val",
                    num_workers=config.num_workers, fingerprint_token=token + ":val",
                )
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset

        self.train_loader = DataLoader(
            train_dataset, batch_size=config.batch_size, shuffle=True, seed=config.seed,
            sample_weights=sample_weights, collate_fn=collate_fn,
            num_workers=config.num_workers,
        )
        self.val_loader = (
            DataLoader(
                val_dataset, batch_size=config.batch_size, shuffle=False, drop_last=False,
                seed=config.seed, collate_fn=collate_fn, num_workers=config.num_workers,
            )
            if val_dataset is not None and len(val_dataset) > 0
            else None
        )

        steps_per_epoch = max(len(self.train_loader), 1)
        schedule = schedules.build_lr_schedule(
            config.scheduler_type, config.learning_rate, steps_per_epoch * config.num_epochs,
            steps_per_epoch, warmup_epochs=config.warmup_epochs,
            scheduler_step_size=config.scheduler_step_size,
            scheduler_gamma=config.scheduler_gamma,
        )
        params = [p for p in model.parameters() if p.requires_grad]
        self.state = TrainState(
            model=model,
            optimizer=schedules.build_optimizer(params, config.learning_rate, config.weight_decay),
            schedule=schedule,
            generator=torch.Generator(device=self.device).manual_seed(config.seed),
            grad_clip=config.grad_clip,
            draw_shard=self._draw_shard,
        )
        if config.pretrained_path is not None:
            self._load_pretrained_backbone(config.pretrained_path)
        if dist.is_available() and dist.is_initialized():
            self._replicate(model)
        backbone = list(model.backbone.parameters()) if hasattr(model, "backbone") else []
        self._frozen = self.frozen_backbone_at_start()
        if self._frozen and not backbone:
            raise ValueError("a frozen backbone needs a model with a `backbone` submodule")
        loss_fn, preprocess = self._loss_from_outputs, self._preprocess_fn()
        self.train_step_fn = lambda state, batch: train_step(
            state, batch, loss_fn, preprocess, frozen=backbone if self._frozen else ())
        self.eval_step_fn = lambda state, batch: eval_step(state, batch, loss_fn, preprocess)

        self.step_times: list[float] = []  # profile_steps: every step's seconds
        self.current_epoch = 0
        self.best_metric = float("inf")
        self.best_epoch = 0
        self.patience_counter = 0
        self.plateau_counter = 0
        self.history: dict[str, list[float]] = {"train_loss": [], "val_loss": [], "lr": []}

        self.config.output_path.mkdir(parents=True, exist_ok=True)
        self.config.logs_path.mkdir(parents=True, exist_ok=True)
        if mesh.is_main:
            self.config.save_config()
        self.tracker = None
        if config.use_tracker and mesh.is_main:
            from spine_vision_torch.viz.tracker import ExperimentTracker

            self.tracker = ExperimentTracker(
                project=config.tracker_project,
                run_name=config.tracker_run_name or config.run_id,
                output_path=config.logs_path,
            )
            self.tracker.log_config(asdict(config))
        mesh.barrier()

    def _replicate(self, model: torch.nn.Module) -> None:
        """Wrap the model for the group: BatchNorm statistics over the group
        (above one rank), so the buffers need no broadcast, and the
        ``DistributedDataParallel`` replica the train step calls."""
        if self.mesh_ctx.world_size > 1:
            for module in model.modules():
                if isinstance(module, BatchNorm):
                    module.process_group = dist.group.WORLD
        dev = self.device
        self.state.replica = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=self.find_unused_parameters,
        )

    def _group_mean(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` (detached) averaged over the ranks; itself at world size 1.
        For a per-rank loss, the group's loss."""
        mesh = self.mesh_ctx
        return value if mesh.world_size == 1 else mesh.all_sum(value) / mesh.world_size

    def _counted_rows(self, batch: dict[str, Any], counted: torch.Tensor,
                      per_row: int = 1) -> tuple[torch.Tensor, torch.Tensor | None]:
        """What a loss counts, and what it divides by. ``counted`` holds
        ``[B, ...]`` 0/1 weights; the rows the loader repeated on this rank
        (``_valid`` 0) are zeroed in it. The divisor is None at world size 1
        (the loss counts its own batch); above, it is the group's count (of
        ``counted``, times ``per_row``) over the world size, so that DDP's
        mean of the ranks' losses divides the global sum by the global
        count. Above one rank the localization loss calls this for every
        batch, the classification loss for every batch with ``_valid``, and
        the eval loop gives every batch ``_valid`` on every rank: the ranks
        run the same collectives in the same order."""
        valid = batch.get("_valid")
        if valid is not None:
            counted = counted * valid.to(counted.dtype).reshape(-1, *[1] * (counted.dim() - 1))
        mesh = self.mesh_ctx
        if mesh.world_size == 1:
            return counted, None
        count = mesh.all_sum(counted.detach().float().sum() * per_row)
        return counted, count / mesh.world_size

    # Subclass surface ---------------------------------------------------

    def _build_model(self, device: torch.device) -> torch.nn.Module:
        """The model to train when none is given, on ``device``."""
        raise NotImplementedError

    def _loss_from_outputs(self, outputs: torch.Tensor, batch: dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def _preprocess_fn(self) -> Callable | None:
        """Optional ``(batch, generator, train) -> batch`` on the device."""
        return None

    def _compute_metrics(self, outputs_list: list[Any], batches: list[Any]) -> dict[str, float]:
        return {}

    def frozen_backbone_at_start(self) -> bool:
        """Whether the backbone starts frozen."""
        return self.config.freeze_backbone_epochs > 0

    def set_backbone_frozen(self, frozen: bool) -> None:
        """Freeze or unfreeze the backbone from the next train step on."""
        self._frozen = frozen

    def on_train_begin(self) -> None:  # noqa: B027
        pass

    def on_epoch_begin(self, epoch: int) -> None:  # noqa: B027
        pass

    def on_epoch_end(self, epoch: int, metrics: dict[str, Any]) -> None:  # noqa: B027
        pass

    def on_train_end(self, result: TrainingResult) -> None:  # noqa: B027
        pass

    def get_metric_for_checkpoint(self, val_loss: float | None, metrics: dict[str, float]) -> float:
        """Metric for best-model selection; lower is better."""
        if val_loss is not None:
            return val_loss
        return self.history["train_loss"][-1] if self.history["train_loss"] else float("inf")

    # Engine -------------------------------------------------------------

    def count_parameters(self) -> int:
        return int(sum(p.numel() for p in self.model.parameters()))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _load_pretrained_backbone(self, path: Path) -> None:
        """Replace the backbone's parameters and BatchNorm statistics with the
        converted checkpoint at ``path`` for ``config.backbone``; every leaf of
        the backbone must be in it with its shape, and every leaf of it used."""
        backbone = getattr(self.model, "backbone", None)
        if backbone is None:
            raise ValueError("pretrained_path needs a model with a `backbone` submodule")
        params, stats = load_pretrained_backbone(Path(path), getattr(self.config, "backbone", ""))
        load_flax_variables(backbone, params, stats)
        logger.info("Loaded pretrained backbone weights: %s", path)

    def train(self) -> TrainingResult:
        """Run the full training loop."""
        cfg = self.config
        logger.info("Starting training for %d epochs", cfg.num_epochs)
        logger.info("Parameters: %s", f"{self.count_parameters():,}")
        logger.info("Train samples: %d", len(self.train_dataset))
        if cfg.checkpoint_path:
            self._load(cfg.checkpoint_path)
        self.on_train_begin()

        if self._frozen:
            logger.info("Backbone frozen for the first %d epochs", cfg.freeze_backbone_epochs)
        first_epoch = self.current_epoch
        for epoch in range(first_epoch, cfg.num_epochs):
            self.current_epoch = epoch
            if self._frozen and epoch >= cfg.freeze_backbone_epochs:
                logger.info("Unfreezing backbone at epoch %d", epoch + 1)
                self.set_backbone_frozen(False)
            self.on_epoch_begin(epoch)
            start = time.perf_counter()
            if cfg.profile_trace and epoch == first_epoch:
                with trace_profile(cfg.logs_path / "profile"):
                    train_loss = self._train_epoch()
            else:
                train_loss = self._train_epoch()
            epoch_time = time.perf_counter() - start
            lr = self.state.last_lr
            self.history["train_loss"].append(train_loss)
            self.history["lr"].append(lr)

            val_loss: float | None = None
            metrics: dict[str, float] = {}
            if self.val_loader and (epoch + 1) % cfg.val_frequency == 0:
                val_loss, metrics = self._validate_epoch()
                self.history["val_loss"].append(val_loss)
                for key, value in metrics.items():
                    self.history.setdefault(key, []).append(value)

            if cfg.scheduler_type == "plateau" and val_loss is not None:
                self._plateau_step(val_loss)
            self._log_epoch(epoch, train_loss, val_loss, metrics, lr, epoch_time)
            if self.tracker is not None:
                tracked = {"train/loss": train_loss, "train/lr": lr}
                if val_loss is not None:
                    tracked["val/loss"] = val_loss
                tracked.update({f"val/{k}": v for k, v in metrics.items()})
                self.tracker.log_metrics(tracked, step=epoch)
            self.on_epoch_end(epoch, {"train_loss": train_loss, "val_loss": val_loss, **metrics})

            # Gating and early stopping on validated epochs only.
            if val_loss is not None or self.val_loader is None:
                metric = self.get_metric_for_checkpoint(val_loss, metrics)
                if metric < self.best_metric - cfg.min_delta:
                    self.best_metric = metric
                    self.best_epoch = epoch
                    self.patience_counter = 0
                    self._save(is_best=True)
                else:
                    self.patience_counter += 1
            if (epoch + 1) % cfg.save_frequency == 0:
                self._save(is_best=False)
            if cfg.early_stopping and self.patience_counter >= cfg.patience:
                logger.info("Early stopping at epoch %d", epoch + 1)
                break

        # Reload the best weights; keep this run's loop state and history.
        best = cfg.output_path / "best_model"
        if best.exists():
            self._load(best, restore_loop_state=False)
        history = self.history
        result = TrainingResult(
            best_epoch=self.best_epoch,
            best_metric=self.best_metric,
            final_train_loss=history["train_loss"][-1] if history["train_loss"] else 0.0,
            final_val_loss=history["val_loss"][-1] if history["val_loss"] else 0.0,
            history=history,
            checkpoint_path=best,
        )
        self.on_train_end(result)
        if self.tracker is not None:
            self.tracker.finish()
        return result

    def _train_epoch(self) -> float:
        self.train_loader.set_epoch(self.current_epoch)
        timer = StepTimer() if self.config.profile_steps else None
        loss_sum = None  # on the device; read once an epoch
        count = 0
        for batch_idx, batch in enumerate(self.train_loader):
            if timer is not None:
                self._sync()
                timer.start()
            loss = self.train_step_fn(self.state, batch)
            if timer is not None:
                self._sync()
                timer.stop()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            count += 1
            if (batch_idx + 1) % self.config.log_frequency == 0:
                logger.debug("Epoch %d [%d/%d] Loss: %.6f", self.current_epoch, batch_idx + 1,
                             len(self.train_loader), float(loss))
        if timer is not None and len(timer):
            self.step_times.extend(timer.times)
            summary = timer.summary(skip_first=0)  # this epoch's every step
            logger.info("Step timing: p50 %.1f ms, p95 %.1f ms over %d steps",
                        summary["p50_s"] * 1e3, summary["p95_s"] * 1e3, int(summary["steps"]))
        if loss_sum is None:
            return 0.0
        return float(self._group_mean(loss_sum)) / max(count, 1)

    def _validate_epoch(self) -> tuple[float, dict[str, float]]:
        return self._eval_loop(self.val_loader, self._on_validation_outputs)

    def _on_validation_outputs(self, outputs_list: list[Any], batches: list[Any]) -> None:
        """Called with a validation pass's host outputs and batches (world
        size 1): the per-epoch figures."""

    def _test_metrics(self, test_dataset: Any, on_outputs: Callable | None = None
                      ) -> dict[str, float]:
        """The metrics of the model on ``test_dataset`` ({} when it is empty),
        logged, and to the tracker under ``test/``. ``on_outputs(outputs_list,
        batches)`` gets the pass's host outputs and batches."""
        if len(test_dataset) == 0:
            logger.warning("Empty test dataset (too small for the split ratios): no "
                           "evaluation metrics")
            return {}
        _, metrics = self._eval_loop(DataLoader(
            test_dataset, batch_size=self.config.batch_size, shuffle=False, drop_last=False,
            seed=self.config.seed, collate_fn=self._collate_fn,
            num_workers=self.config.num_workers,
        ), on_outputs)
        logger.info("Test Results:")
        for key, value in sorted(metrics.items()):
            logger.info("  %s: %.4f", key, value)
        if self.tracker is not None:
            self.tracker.log_metrics({f"test/{k}": v for k, v in metrics.items()})
        return metrics

    def _eval_loop(self, loader: DataLoader, on_outputs: Callable | None = None
                   ) -> tuple[float, dict[str, float]]:
        """The mean loss and the metrics of one pass over ``loader``.

        Each batch's loss is the group's weighted by its global count, the
        same on every rank. Above one rank every batch carries ``_valid``
        (0 on the rows the loader repeated on this rank, 1 elsewhere), so
        that every rank's loss takes the same path (:meth:`_counted_rows`).
        The metrics need every output on one host, so a multi-process run
        computes none ({}), as in the JAX package."""
        world = self.mesh_ctx.world_size
        total, count = 0.0, 0
        outputs_list: list[Any] = []
        batches: list[dict[str, Any]] = []
        for batch in loader:
            n = len(batch["image"])
            step_batch = batch
            if world > 1:
                valid = (np.arange(n) < batch.get("_n_valid", n)).astype(np.float32)
                step_batch = {**batch, "_valid": valid}
            outputs, loss = self.eval_step_fn(self.state, step_batch)
            weight = batch.get("_n_valid_global", n * world)
            total += float(self._group_mean(loss)) * weight
            count += weight
            if world == 1:
                outputs_list.append(to_host(outputs))
                batches.append(batch)
        metrics = self._compute_metrics(outputs_list, batches) if world == 1 else {}
        if on_outputs is not None and world == 1:
            on_outputs(outputs_list, batches)
        return total / max(count, 1), metrics

    def _plateau_step(self, val_loss: float) -> None:
        best_val = min(self.history["val_loss"][:-1], default=float("inf"))
        if val_loss < best_val - 1e-12:
            self.plateau_counter = 0
            return
        self.plateau_counter += 1
        if self.plateau_counter > self.config.scheduler_patience:
            new_lr = self.state.last_lr * self.config.scheduler_gamma
            logger.info("Plateau: reducing lr to %.2e", new_lr)
            self.state.set_lr(new_lr)
            self.plateau_counter = 0

    def _log_epoch(self, epoch, train_loss, val_loss, metrics, lr, epoch_time) -> None:
        msg = f"Epoch {epoch + 1}/{self.config.num_epochs} - Train Loss: {train_loss:.6f}"
        if val_loss is not None:
            msg += f" - Val Loss: {val_loss:.6f}"
        for key, value in metrics.items():
            msg += f" - {key}: {value:.4f}"
        logger.info(msg + f" - LR: {lr:.2e} - {epoch_time:.1f}s")

    def _save(self, is_best: bool) -> None:
        """Rank 0 writes, then every rank waits for it."""
        name = "best_model" if is_best else f"checkpoint_epoch_{self.current_epoch + 1}"
        meta = {
            "epoch": self.current_epoch,
            "best_metric": self.best_metric,
            "best_epoch": self.best_epoch,
            "history": self.history,
            "config": self.config.to_dict(),
        }
        if self.mesh_ctx.is_main:
            save_checkpoint(self.config.output_path / name, self.state, meta)
        self.mesh_ctx.barrier()

    def _load(self, path: Path, restore_loop_state: bool = True) -> None:
        """Restore the model and optimizer; optionally the loop state too."""
        meta = load_checkpoint(Path(path), self.state)
        if meta and restore_loop_state:
            self.current_epoch = int(meta.get("epoch", -1)) + 1
            self.best_metric = float(meta.get("best_metric", float("inf")))
            self.best_epoch = int(meta.get("best_epoch", 0))
            self.history = meta.get("history", self.history)
        logger.info("Loaded checkpoint from %s", path)
