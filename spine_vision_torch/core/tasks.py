"""The eight lumbar-spine grading tasks: their losses and host-side decode.

Counterpart of ``spine_vision_tpu/core/tasks.py``: ``TaskConfig``,
``TASK_REGISTRY`` and one strategy per task type, which gives the task's
loss as a function ``(logits, formatted targets) -> scalar`` (and its
per-sample form ``-> [B]``, for weighted batch means), formats targets for
it, and decodes logits into predictions and probabilities (host numpy,
float64 math as in the JAX package). Losses compute in f32 whatever the
logits' dtype (``ops/losses.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Literal

import numpy as np
import torch

from spine_vision_torch.ops import losses as L

TaskType = Literal["binary", "multiclass", "multilabel", "ordinal", "regression"]
LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class TaskConfig:
    """Configuration of one grading task. ``label_smoothing`` acts on the
    multiclass and ordinal cross entropy; ``use_focal_loss``,
    ``focal_gamma`` and ``focal_alpha`` on the binary and multilabel loss;
    ``loss_weight`` weights the task in the multi-task sum."""

    name: str
    num_classes: int
    task_type: TaskType
    display_name: str = ""
    class_names: tuple[str, ...] = ()
    color: str = "#1f77b4"
    label_smoothing: float = 0.0
    use_focal_loss: bool = False
    focal_gamma: float = 2.0
    focal_alpha: float | None = None
    loss_weight: float = 1.0

    def __post_init__(self) -> None:
        if not self.display_name:
            object.__setattr__(self, "display_name", self.name.replace("_", " ").title())
        if not self.class_names and self.task_type == "multiclass":
            names = tuple(f"Class {i}" for i in range(self.num_classes))
            object.__setattr__(self, "class_names", names)

    def with_overrides(self, **kwargs: Any) -> "TaskConfig":
        """A copy with the given fields replaced."""
        return replace(self, **kwargs)

    @property
    def is_binary(self) -> bool:
        return self.task_type == "binary"

    @property
    def is_multiclass(self) -> bool:
        return self.task_type == "multiclass"


def _row_mean(elem: torch.Tensor) -> torch.Tensor:
    return elem.reshape(elem.shape[0], -1).mean(dim=1)


def _sigmoid64(logits: Any) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.asarray(logits).astype(np.float64)))


class BinaryStrategy:
    """BCE with logits (or the focal loss); sigmoid > 0.5, a trailing unit
    axis squeezed from the predictions."""

    def loss_fn(self, task: TaskConfig) -> LossFn:
        if task.use_focal_loss:
            gamma, alpha = task.focal_gamma, task.focal_alpha
            return lambda logits, targets: L.focal_loss_with_logits(
                logits, targets, gamma=gamma, alpha=alpha, reduction="mean")
        return lambda logits, targets: L.binary_cross_entropy_with_logits(logits, targets).mean()

    def per_sample_loss_fn(self, task: TaskConfig) -> LossFn:
        if task.use_focal_loss:
            gamma, alpha = task.focal_gamma, task.focal_alpha
            return lambda logits, targets: _row_mean(L.focal_loss_with_logits(
                logits, targets, gamma=gamma, alpha=alpha, reduction="none"))
        return lambda logits, targets: _row_mean(
            L.binary_cross_entropy_with_logits(logits, targets))

    def format_target(self, target: torch.Tensor) -> torch.Tensor:
        """f32 ``[B, 1]`` from ``[B]`` or ``[B, 1]``."""
        t = target.float()
        return t[:, None] if t.ndim == 1 else t

    def compute_predictions(self, logits: Any) -> np.ndarray:
        preds = (_sigmoid64(logits) > 0.5).astype(np.int32)
        if preds.shape and preds.shape[-1] == 1:
            preds = preds.squeeze(-1)
        return preds

    def compute_probabilities(self, logits: Any) -> np.ndarray:
        return _sigmoid64(logits).astype(np.float32)


class MulticlassStrategy:
    """Softmax cross entropy with label smoothing; argmax over classes,
    softmax probabilities."""

    def loss_fn(self, task: TaskConfig) -> LossFn:
        smoothing = task.label_smoothing
        return lambda logits, targets: L.softmax_cross_entropy(
            logits, targets, label_smoothing=smoothing).mean()

    def per_sample_loss_fn(self, task: TaskConfig) -> LossFn:
        smoothing = task.label_smoothing
        return lambda logits, targets: L.softmax_cross_entropy(
            logits, targets, label_smoothing=smoothing)

    def format_target(self, target: torch.Tensor) -> torch.Tensor:
        """Integer class labels."""
        return target.long()

    def compute_predictions(self, logits: Any) -> np.ndarray:
        return np.argmax(np.asarray(logits), axis=1)

    def compute_probabilities(self, logits: Any) -> np.ndarray:
        x = np.asarray(logits).astype(np.float64)
        x = x - x.max(axis=1, keepdims=True)
        e = np.exp(x)
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


class MultilabelStrategy(BinaryStrategy):
    """Per-label BCE (or focal) loss; per-label sigmoid > 0.5 (no squeeze)."""

    def format_target(self, target: torch.Tensor) -> torch.Tensor:
        return target.float()

    def compute_predictions(self, logits: Any) -> np.ndarray:
        return (_sigmoid64(logits) > 0.5).astype(np.int32)


class OrdinalStrategy(MulticlassStrategy):
    """Trained and decoded as multiclass."""


class RegressionStrategy:
    """MSE loss; identity predictions and probabilities."""

    def loss_fn(self, task: TaskConfig) -> LossFn:
        return lambda logits, targets: L.mse_loss(logits, targets).mean()

    def per_sample_loss_fn(self, task: TaskConfig) -> LossFn:
        return lambda logits, targets: _row_mean(L.mse_loss(logits, targets))

    def format_target(self, target: torch.Tensor) -> torch.Tensor:
        return target.float()

    def compute_predictions(self, logits: Any) -> np.ndarray:
        return np.asarray(logits)

    def compute_probabilities(self, logits: Any) -> np.ndarray:
        return np.asarray(logits)


_STRATEGIES = {
    "binary": BinaryStrategy(),
    "multiclass": MulticlassStrategy(),
    "multilabel": MultilabelStrategy(),
    "ordinal": OrdinalStrategy(),
    "regression": RegressionStrategy(),
}


def get_strategy(task: TaskConfig | str):
    task_type = task.task_type if isinstance(task, TaskConfig) else task
    if task_type not in _STRATEGIES:
        raise ValueError(f"Unknown task type: {task_type}")
    return _STRATEGIES[task_type]


TASK_REGISTRY: dict[str, TaskConfig] = {
    "pfirrmann": TaskConfig(
        name="pfirrmann", num_classes=5, task_type="multiclass",
        display_name="Pfirrmann Grade",
        class_names=("Grade I", "Grade II", "Grade III", "Grade IV", "Grade V"),
        color="#1f77b4",
    ),
    "modic": TaskConfig(
        name="modic", num_classes=4, task_type="multiclass", display_name="Modic Type",
        class_names=("Normal", "Type I", "Type II", "Type III"), color="#ff7f0e",
    ),
    "herniation": TaskConfig(
        name="herniation", num_classes=1, task_type="binary",
        display_name="Disc Herniation", color="#2ca02c",
    ),
    "bulging": TaskConfig(
        name="bulging", num_classes=1, task_type="binary",
        display_name="Disc Bulging", color="#d62728",
    ),
    "upper_endplate": TaskConfig(
        name="upper_endplate", num_classes=1, task_type="binary",
        display_name="Upper Endplate Defect", color="#9467bd",
    ),
    "lower_endplate": TaskConfig(
        name="lower_endplate", num_classes=1, task_type="binary",
        display_name="Lower Endplate Defect", color="#8c564b",
    ),
    "spondy": TaskConfig(
        name="spondy", num_classes=1, task_type="binary",
        display_name="Spondylolisthesis", color="#e377c2",
    ),
    "narrowing": TaskConfig(
        name="narrowing", num_classes=1, task_type="binary",
        display_name="Disc Narrowing", color="#7f7f7f",
    ),
}


AVAILABLE_TASK_NAMES: tuple[str, ...] = tuple(TASK_REGISTRY)


def get_task(name: str) -> TaskConfig:
    if name not in TASK_REGISTRY:
        raise KeyError(f"Unknown task: {name}. Available: {list(TASK_REGISTRY)}")
    return TASK_REGISTRY[name]


def get_tasks(names: list[str] | None = None) -> list[TaskConfig]:
    """Task configurations (all registered ones if ``names`` is None)."""
    if names is None:
        return list(TASK_REGISTRY.values())
    return [get_task(n) for n in names]


def create_loss_functions(
    tasks: list[TaskConfig],
) -> tuple[dict[str, LossFn], dict[str, float]]:
    """Each task's loss function and loss weight, by task name."""
    loss_fns = {t.name: get_strategy(t).loss_fn(t) for t in tasks}
    return loss_fns, {t.name: t.loss_weight for t in tasks}


def compute_predictions_for_tasks(
    outputs: dict[str, Any], tasks: list[TaskConfig]
) -> dict[str, np.ndarray]:
    """Discrete predictions for each task's logits."""
    return {
        t.name: get_strategy(t).compute_predictions(outputs[t.name])
        for t in tasks if t.name in outputs
    }


def compute_probabilities_for_tasks(
    outputs: dict[str, Any], tasks: list[TaskConfig]
) -> dict[str, np.ndarray]:
    """Probabilities for each task's logits."""
    return {
        t.name: get_strategy(t).compute_probabilities(outputs[t.name])
        for t in tasks if t.name in outputs
    }


def get_task_display_name(name: str) -> str:
    """Display name for a task (name itself if unregistered)."""
    if name in TASK_REGISTRY:
        return TASK_REGISTRY[name].display_name
    return name


def get_task_color(name: str) -> str:
    """Color for a task (default gray if unregistered)."""
    if name in TASK_REGISTRY:
        return TASK_REGISTRY[name].color
    return "#333333"


def get_task_display_names() -> dict[str, str]:
    """Display names for all registered tasks."""
    return {name: task.display_name for name, task in TASK_REGISTRY.items()}


def get_task_colors() -> dict[str, str]:
    """Colors for all registered tasks."""
    return {name: task.color for name, task in TASK_REGISTRY.items()}
