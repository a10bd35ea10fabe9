"""The eight lumbar-spine grading tasks and their host-side decode.

Counterpart of ``spine_vision_tpu/core/tasks.py`` for inference:
``TaskConfig``, ``TASK_REGISTRY`` and the strategies' predictions and
probabilities (host numpy, float64 math as in the JAX package). The losses
wait for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Literal

import numpy as np

TaskType = Literal["binary", "multiclass", "multilabel", "ordinal", "regression"]


@dataclass(frozen=True)
class TaskConfig:
    """Configuration of one grading task (see the JAX package for the loss
    fields, which this slice carries but does not use)."""

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


def _sigmoid64(logits: Any) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.asarray(logits).astype(np.float64)))


class BinaryStrategy:
    """sigmoid > 0.5; a trailing unit axis is squeezed from the predictions."""

    def compute_predictions(self, logits: Any) -> np.ndarray:
        preds = (_sigmoid64(logits) > 0.5).astype(np.int32)
        if preds.shape and preds.shape[-1] == 1:
            preds = preds.squeeze(-1)
        return preds

    def compute_probabilities(self, logits: Any) -> np.ndarray:
        return _sigmoid64(logits).astype(np.float32)


class MulticlassStrategy:
    """argmax over classes; softmax probabilities."""

    def compute_predictions(self, logits: Any) -> np.ndarray:
        return np.argmax(np.asarray(logits), axis=1)

    def compute_probabilities(self, logits: Any) -> np.ndarray:
        x = np.asarray(logits).astype(np.float64)
        x = x - x.max(axis=1, keepdims=True)
        e = np.exp(x)
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


class MultilabelStrategy(BinaryStrategy):
    """Per-label sigmoid > 0.5 (no squeeze)."""

    def compute_predictions(self, logits: Any) -> np.ndarray:
        return (_sigmoid64(logits) > 0.5).astype(np.int32)


class OrdinalStrategy(MulticlassStrategy):
    """Decoded as multiclass."""


class RegressionStrategy:
    """Identity predictions and probabilities."""

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


def get_task(name: str) -> TaskConfig:
    if name not in TASK_REGISTRY:
        raise KeyError(f"Unknown task: {name}. Available: {list(TASK_REGISTRY)}")
    return TASK_REGISTRY[name]


def get_tasks(names: list[str] | None = None) -> list[TaskConfig]:
    """Task configurations (all registered ones if ``names`` is None)."""
    if names is None:
        return list(TASK_REGISTRY.values())
    return [get_task(n) for n in names]


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
