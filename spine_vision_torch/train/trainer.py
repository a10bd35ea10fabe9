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
- the run-dir layout of ``train/checkpoint.py`` with a ``config.yaml``.

There is no mesh: one process drives one device. Options whose modules are
not ported yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from dataclasses import asdict, dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Generic, TypeVar

import numpy as np
import torch

from spine_vision_torch.data.loader import DataLoader
from spine_vision_torch.device import resolve_device
from spine_vision_torch.train import schedules
from spine_vision_torch.train.checkpoint import load_checkpoint, save_checkpoint
from spine_vision_torch.train.state import TrainState
from spine_vision_torch.train.steps import eval_step, train_step

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


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet: ROADMAP.md, {item}")


@dataclass
class TrainingConfig:
    """Configuration for training (the JAX package's ``TrainingConfig``).

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

    scheduler_type: str = "cosine"  # cosine | step | plateau | none
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
    mixed_precision: bool = True
    """bf16 compute on f32 master weights."""

    log_frequency: int = 10
    save_frequency: int = 10

    pretrained_path: Path | None = None

    profile_steps: bool = False
    """Record each train step's wall time (synchronising the card) in
    ``step_times``, and log the p50 and p95 each epoch."""
    profile_trace: bool = False

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
    preprocessing and the metrics; this class owns the loaders, the
    optimizer and schedule, the epoch loop, early stopping and checkpoints.
    ``train_step_fn(state, batch) -> loss`` is the step the loop calls.
    """

    def __init__(
        self,
        config: TConfig,
        model: torch.nn.Module,
        train_dataset: Any,
        val_dataset: Any | None = None,
        collate_fn: Callable | None = None,
        device: str | torch.device = "cuda",
        sample_weights: np.ndarray | None = None,
    ) -> None:
        if config.distributed or (config.num_devices or 1) > 1:
            raise _not_ported("distributed / multi-device training", "Queue 1 item 9")
        if config.sample_cache_dir is not None:
            raise _not_ported("sample_cache_dir (data/cache.py)", "Queue 1 item 7")
        if config.pretrained_path is not None:
            raise _not_ported("pretrained_path (pretrained backbone loading)", "Queue 1 item 7")
        if config.use_tracker:
            raise _not_ported("use_tracker (viz/tracker.py)", "Queue 1 item 13")
        if config.profile_trace:
            raise _not_ported("profile_trace", "Queue 1 item 7")
        self.config = config
        self.device = resolve_device(device)
        self.model = model
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self._collate_fn = collate_fn

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
        )
        backbone = list(model.backbone.parameters()) if hasattr(model, "backbone") else []
        self._frozen = self.frozen_backbone_at_start()
        if self._frozen and not backbone:
            raise ValueError("a frozen backbone needs a model with a `backbone` submodule")
        loss_fn, preprocess = self._loss_from_outputs, self._preprocess_fn()
        self.train_step_fn = lambda state, batch: train_step(
            state, batch, loss_fn, preprocess, frozen=backbone if self._frozen else ())
        self.eval_step_fn = lambda state, batch: eval_step(state, batch, loss_fn, preprocess)

        self.step_times: list[float] = []
        self.current_epoch = 0
        self.best_metric = float("inf")
        self.best_epoch = 0
        self.patience_counter = 0
        self.plateau_counter = 0
        self.history: dict[str, list[float]] = {"train_loss": [], "val_loss": [], "lr": []}

        self.config.output_path.mkdir(parents=True, exist_ok=True)
        self.config.logs_path.mkdir(parents=True, exist_ok=True)
        self.config.save_config()

    # Subclass surface ---------------------------------------------------

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
        for epoch in range(self.current_epoch, cfg.num_epochs):
            self.current_epoch = epoch
            if self._frozen and epoch >= cfg.freeze_backbone_epochs:
                logger.info("Unfreezing backbone at epoch %d", epoch + 1)
                self.set_backbone_frozen(False)
            self.on_epoch_begin(epoch)
            start = time.perf_counter()
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
        return result

    def _train_epoch(self) -> float:
        self.train_loader.set_epoch(self.current_epoch)
        timed = self.config.profile_steps
        times: list[float] = []
        loss_sum = None  # on the device; read once an epoch
        count = 0
        for batch_idx, batch in enumerate(self.train_loader):
            if timed:
                self._sync()
                start = time.perf_counter()
            loss = self.train_step_fn(self.state, batch)
            if timed:
                self._sync()
                times.append(time.perf_counter() - start)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            count += 1
            if (batch_idx + 1) % self.config.log_frequency == 0:
                logger.debug("Epoch %d [%d/%d] Loss: %.6f", self.current_epoch, batch_idx + 1,
                             len(self.train_loader), float(loss))
        if times:
            self.step_times.extend(times)
            logger.info("Step timing: p50 %.1f ms, p95 %.1f ms over %d steps",
                        np.percentile(times, 50) * 1e3, np.percentile(times, 95) * 1e3, len(times))
        return float(loss_sum) / max(count, 1) if loss_sum is not None else 0.0

    def _validate_epoch(self) -> tuple[float, dict[str, float]]:
        return self._eval_loop(self.val_loader)

    def _test_metrics(self, test_dataset: Any) -> dict[str, float]:
        """The metrics of the model on ``test_dataset`` ({} when it is empty),
        logged."""
        if len(test_dataset) == 0:
            logger.warning("Empty test dataset (too small for the split ratios): no "
                           "evaluation metrics")
            return {}
        _, metrics = self._eval_loop(DataLoader(
            test_dataset, batch_size=self.config.batch_size, shuffle=False, drop_last=False,
            seed=self.config.seed, collate_fn=self._collate_fn,
            num_workers=self.config.num_workers,
        ))
        logger.info("Test Results:")
        for key, value in sorted(metrics.items()):
            logger.info("  %s: %.4f", key, value)
        return metrics

    def _eval_loop(self, loader: DataLoader) -> tuple[float, dict[str, float]]:
        """The mean loss and the metrics of one pass over ``loader``."""
        total, count = 0.0, 0
        outputs_list: list[Any] = []
        batches: list[dict[str, Any]] = []
        for batch in loader:
            outputs, loss = self.eval_step_fn(self.state, batch)
            n = len(batch["image"])
            total += float(loss) * n
            count += n
            outputs_list.append(to_host(outputs))
            batches.append(batch)
        return total / max(count, 1), self._compute_metrics(outputs_list, batches)

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
        name = "best_model" if is_best else f"checkpoint_epoch_{self.current_epoch + 1}"
        meta = {
            "epoch": self.current_epoch,
            "best_metric": self.best_metric,
            "best_epoch": self.best_epoch,
            "history": self.history,
            "config": self.config.to_dict(),
        }
        save_checkpoint(self.config.output_path / name, self.state, meta)

    def _load(self, path: Path, restore_loop_state: bool = True) -> None:
        """Restore the model and optimizer; optionally the loop state too."""
        meta = load_checkpoint(Path(path), self.state)
        if meta and restore_loop_state:
            self.current_epoch = int(meta.get("epoch", -1)) + 1
            self.best_metric = float(meta.get("best_metric", float("inf")))
            self.best_epoch = int(meta.get("best_epoch", 0))
            self.history = meta.get("history", self.history)
        logger.info("Loaded checkpoint from %s", path)
