"""Host-side evaluation metrics (numpy), copied from
``spine_vision_tpu/metrics/__init__.py``.

- ``LocalizationMetrics``: MED (mean Euclidean distance in normalised units)
  with its std and median, per-coordinate MAE, PCK at thresholds (percent of
  predictions within a distance) and the per-level MED. The localization
  trainer's best-model gating reads ``med``.
- ``ClassificationMetrics`` (one multiclass task: accuracy, per-class
  precision, recall and F1, balanced accuracy, macro F1) and
  ``ClassifierMetrics`` (every task, with the rank ROC-AUC, one-vs-rest for
  multiclass, and the aggregates ``overall_accuracy``, ``f1`` or
  ``macro_f1`` and ``macro_auc``). The classification trainer's gating
  reads ``f1`` or ``macro_f1``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from spine_vision_torch.core.registry import register_metrics
from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, TaskConfig, get_task

LEVEL_NAMES_DEFAULT = ["L1/L2", "L2/L3", "L3/L4", "L4/L5", "L5/S1"]


def _stable_sigmoid(x: np.ndarray) -> np.ndarray:
    """Sigmoid without overflow (``np.exp(-x)`` overflows below -709)."""
    out = np.empty_like(x, dtype=np.float64)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _softmax(x: np.ndarray) -> np.ndarray:
    """Row-wise stable softmax in float64."""
    x = x.astype(np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    ex = np.exp(x)
    return ex / ex.sum(axis=-1, keepdims=True)


def roc_auc(scores: Any, labels: Any) -> float:
    """Binary ROC-AUC by the rank statistic (Mann-Whitney U) with average
    ranks, so tied scores count 0.5; NaN when only one class is present."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(int)
    n_pos = int(np.sum(labels == 1))
    n_neg = int(np.sum(labels == 0))
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    _, inverse, counts = np.unique(scores, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    ranks = (cum - (counts - 1) / 2.0)[inverse]
    u = float(np.sum(ranks[labels == 1])) - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def macro_ovr_auc(probabilities: Any, targets: Any) -> float:
    """Macro one-vs-rest ROC-AUC of ``[N, C]`` probabilities; classes absent
    from (or filling all of) ``targets`` are skipped, NaN when none is left."""
    probs = np.asarray(probabilities, dtype=np.float64)
    targets = np.asarray(targets).ravel().astype(int)
    aucs = []
    for class_idx in range(probs.shape[1]):
        ovr = (targets == class_idx).astype(int)
        if ovr.min() == ovr.max():
            continue
        aucs.append(roc_auc(probs[:, class_idx], ovr))
    return float(np.mean(aucs)) if aucs else float("nan")


def _precision_recall_f1(tp: int, fp: int, fn: int) -> tuple[float, float, float]:
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0.0
    return float(precision), float(recall), float(f1)


@register_metrics("localization")
class LocalizationMetrics:
    """MED / MAE / PCK over ``[N, 2]`` predictions and targets."""

    def __init__(
        self,
        pck_thresholds: list[float] | None = None,
        level_names: list[str] | None = None,
    ) -> None:
        # `is None`: an explicit [] means no PCK columns / no per-level rows.
        self.pck_thresholds = pck_thresholds if pck_thresholds is not None else [0.02, 0.05, 0.10]
        self.level_names = level_names if level_names is not None else list(LEVEL_NAMES_DEFAULT)

    def compute(self, predictions: Any, targets: Any, levels: Any | None = None) -> dict[str, float]:
        """All metrics of ``[N, 2]`` predictions and targets (and levels ``[N]``)."""
        predictions = np.asarray(predictions).astype(np.float64)
        targets = np.asarray(targets).astype(np.float64)
        if len(predictions) == 0:
            # Nothing valid: {} (a NaN would freeze best-model tracking).
            return {}
        if levels is not None:
            levels = np.asarray(levels)
            if len(levels) != len(predictions):
                levels = None

        metrics: dict[str, float] = {}
        distances = np.sqrt(np.sum((predictions - targets) ** 2, axis=1))
        metrics["med"] = float(np.mean(distances))
        metrics["med_std"] = float(np.std(distances))
        metrics["med_median"] = float(np.median(distances))
        mae = np.abs(predictions - targets)
        metrics["mae_x"] = float(np.mean(mae[:, 0]))
        metrics["mae_y"] = float(np.mean(mae[:, 1]))
        metrics["mae"] = float(np.mean(mae))
        for thresh in self.pck_thresholds:
            metrics[f"pck@{thresh:.2f}"] = float(np.mean(distances < thresh) * 100)
        if levels is not None:
            for level_idx, level_name in enumerate(self.level_names):
                mask = levels == level_idx
                if np.sum(mask) > 0:
                    metrics[f"med_{level_name}"] = float(np.mean(distances[mask]))
        return metrics


@register_metrics("classification")
class ClassificationMetrics:
    """One multiclass task: accuracy, per-class P/R/F1, balanced accuracy and
    macro F1 over ``[N]`` class predictions (argmaxed when ``[N, C]``)."""

    def __init__(self, num_classes: int, class_names: list[str] | None = None) -> None:
        self.num_classes = num_classes
        self.class_names = class_names or [f"class_{i}" for i in range(num_classes)]
        self.reset()

    def reset(self) -> None:
        self._predictions: list[np.ndarray] = []
        self._targets: list[np.ndarray] = []

    def update(self, predictions: Any, targets: Any) -> None:
        preds = np.asarray(predictions)
        if preds.ndim > 1:
            preds = preds.argmax(axis=1)
        self._predictions.append(preds)
        self._targets.append(np.asarray(targets))

    def compute(self, predictions: Any | None = None, targets: Any | None = None) -> dict[str, float]:
        """Metrics of the given arrays, else of the accumulated ones ({} if none)."""
        if predictions is None and self._predictions:
            predictions = np.concatenate(self._predictions, axis=0)
            targets = np.concatenate(self._targets, axis=0)
        if predictions is None or targets is None:
            return {}
        predictions = np.asarray(predictions)
        if predictions.ndim > 1:
            predictions = predictions.argmax(axis=1)
        targets = np.asarray(targets)

        metrics: dict[str, float] = {"accuracy": float(np.mean(predictions == targets) * 100)}
        for class_idx, class_name in enumerate(self.class_names):
            pred_mask = predictions == class_idx
            target_mask = targets == class_idx
            precision, recall, f1 = _precision_recall_f1(
                np.sum(pred_mask & target_mask),
                np.sum(pred_mask & ~target_mask),
                np.sum(~pred_mask & target_mask),
            )
            metrics[f"precision_{class_name}"] = precision
            metrics[f"recall_{class_name}"] = recall
            metrics[f"f1_{class_name}"] = f1
        metrics["balanced_accuracy"] = float(
            np.mean([metrics[f"recall_{n}"] for n in self.class_names]) * 100)
        metrics["macro_f1"] = float(np.mean([metrics[f"f1_{n}"] for n in self.class_names]))
        return metrics


@register_metrics("classifier")
class ClassifierMetrics:
    """Every task's metrics and their aggregates, accumulated over batches of
    ``{task: logits}`` and ``{task: targets}``.

    Multiclass tasks: accuracy, balanced accuracy, macro F1 and the macro
    one-vs-rest AUC; binary tasks: accuracy, precision, recall, F1 and AUC.
    An AUC that is undefined (one class only) is left out. Aggregates:
    ``overall_accuracy`` (mean of the accuracies), ``f1`` for a single task
    or else ``macro_f1`` (mean of the tasks' F1s), ``macro_auc`` (mean of
    the defined AUCs). Multilabel, ordinal and regression tasks are not
    tracked, as in the JAX package."""

    def __init__(
        self, tasks: list[TaskConfig] | None = None, target_labels: list[str] | None = None
    ) -> None:
        labels = list(AVAILABLE_TASK_NAMES) if target_labels is None else list(target_labels)
        if tasks is not None:
            known = {t.name: t for t in tasks if t.name in labels}
        else:
            known = {label: get_task(label) for label in labels}
        self._task_types = {name: t.task_type for name, t in known.items()}
        self._multiclass_metrics = {
            name: ClassificationMetrics(t.num_classes, [f"class_{i}" for i in range(t.num_classes)])
            for name, t in known.items() if t.task_type == "multiclass"
        }
        self._binary = [name for name, t in known.items() if t.task_type == "binary"]
        self.reset()

    def reset(self) -> None:
        for m in self._multiclass_metrics.values():
            m.reset()
        self._multiclass_probs: dict[str, list[np.ndarray]] = {k: [] for k in self._multiclass_metrics}
        self._multiclass_targets: dict[str, list[np.ndarray]] = {k: [] for k in self._multiclass_metrics}
        self._binary_probs: dict[str, list[np.ndarray]] = {k: [] for k in self._binary}
        self._binary_targets: dict[str, list[np.ndarray]] = {k: [] for k in self._binary}

    def update(self, predictions: dict[str, Any], targets: dict[str, Any]) -> None:
        """Accumulate a batch: multiclass logits ``[B, C]``, binary ``[B, 1]``."""
        for label, metrics in self._multiclass_metrics.items():
            pred, target = predictions.get(label), targets.get(label)
            if pred is None or target is None:
                continue
            logits = np.asarray(pred)
            metrics.update(logits.argmax(axis=1), np.asarray(target))
            self._multiclass_probs[label].append(_softmax(logits))
            self._multiclass_targets[label].append(np.asarray(target))
        for label in self._binary:
            pred, target = predictions.get(label), targets.get(label)
            if pred is None or target is None:
                continue
            self._binary_probs[label].append(_stable_sigmoid(np.asarray(pred).astype(np.float64)))
            self._binary_targets[label].append(np.asarray(target))

    @property
    def is_single_task(self) -> bool:
        return len(self._task_types) == 1

    def compute(self) -> dict[str, float]:
        """Per-task metrics and the aggregates of what was accumulated."""
        metrics: dict[str, float] = {}
        f1_scores: list[float] = []
        auc_scores: list[float] = []

        for label, task_metrics in self._multiclass_metrics.items():
            computed = task_metrics.compute()
            if computed:
                metrics[f"{label}_accuracy"] = computed["accuracy"]
                metrics[f"{label}_balanced_acc"] = computed["balanced_accuracy"]
                f1_scores.append(computed["macro_f1"])
            if self._multiclass_probs[label]:
                auc = macro_ovr_auc(np.concatenate(self._multiclass_probs[label], axis=0),
                                    np.concatenate(self._multiclass_targets[label], axis=0))
                if not np.isnan(auc):
                    metrics[f"{label}_auc"] = auc
                    auc_scores.append(auc)

        for label, probs_list in self._binary_probs.items():
            if not probs_list:
                continue
            probs = np.concatenate(probs_list, axis=0).flatten()
            t_binary = np.concatenate(self._binary_targets[label], axis=0).flatten().astype(int)
            pred_binary = (probs > 0.5).astype(int)
            metrics[f"{label}_accuracy"] = float(np.mean(pred_binary == t_binary) * 100)
            precision, recall, f1 = _precision_recall_f1(
                np.sum((pred_binary == 1) & (t_binary == 1)),
                np.sum((pred_binary == 1) & (t_binary == 0)),
                np.sum((pred_binary == 0) & (t_binary == 1)),
            )
            metrics[f"{label}_precision"] = precision
            metrics[f"{label}_recall"] = recall
            metrics[f"{label}_f1"] = f1
            f1_scores.append(f1)
            auc = roc_auc(probs, t_binary)
            if not np.isnan(auc):
                metrics[f"{label}_auc"] = auc
                auc_scores.append(auc)

        accs = [v for k, v in metrics.items() if k.endswith("_accuracy")]
        metrics["overall_accuracy"] = float(np.mean(accs)) if accs else 0.0
        if f1_scores:
            key = "f1" if self.is_single_task else "macro_f1"
            metrics[key] = float(f1_scores[0] if self.is_single_task else np.mean(f1_scores))
        if auc_scores:
            metrics["macro_auc"] = float(np.mean(auc_scores))
        return metrics
