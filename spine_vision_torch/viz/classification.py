"""Classification plots: metrics bars, confusion matrices (with samples),
confusion summaries, label distributions.

Counterpart of ``spine_vision_tpu/viz/classification.py``: the same
matplotlib calls in the same order, so a figure renders to the same pixels.
"""

from __future__ import annotations

from typing import Any, Sequence

import matplotlib.pyplot as plt
import numpy as np

from spine_vision_torch.core.tasks import get_task, get_task_color, get_task_display_name
from spine_vision_torch.viz.base import (
    CONFUSION_COLORS,
    SPLIT_COLORS,
    extract_prediction_value,
    to_display_image,
)


def _class_names(label: str) -> list[str]:
    task = get_task(label)
    if task.is_multiclass and task.class_names:
        return list(task.class_names)
    if task.is_binary:
        return ["Negative", "Positive"]
    return [f"Class {i}" for i in range(max(task.num_classes, 2))]


def _decode(preds: np.ndarray) -> np.ndarray:
    """Probability arrays -> class indices per sample."""
    return np.asarray([extract_prediction_value(p) for p in np.asarray(preds)])


def _confusion_matrix(
    pred_classes: np.ndarray, target_classes: np.ndarray, n_classes: int
) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    for t, p in zip(target_classes.astype(int), pred_classes.astype(int)):
        if 0 <= t < n_classes and 0 <= p < n_classes:
            cm[t, p] += 1
    return cm


def plot_classification_predictions(
    images: Sequence[np.ndarray],
    predictions: dict[str, np.ndarray],
    targets: dict[str, np.ndarray],
    metadata: Sequence[dict[str, Any]] | None = None,
    num_samples: int = 16,
) -> "plt.Figure":
    """Sample grid with per-task predicted (true) annotations; border green
    when every task is correct."""
    n = min(len(images), num_samples)
    cols = min(4, max(n, 1))
    rows = max((n + cols - 1) // cols, 1)
    fig, axes = plt.subplots(rows, cols, figsize=(3.5 * cols, 3.5 * rows))
    axes = np.atleast_1d(axes).ravel()
    labels = list(predictions.keys())

    for i in range(n):
        ax = axes[i]
        ax.imshow(to_display_image(np.asarray(images[i])), cmap="gray")
        annotations = []
        all_correct = True
        for label in labels:
            pred = extract_prediction_value(predictions[label][i])
            true = extract_prediction_value(targets[label][i])
            correct = pred == true
            all_correct = all_correct and correct
            status = "✓" if correct else "✗"
            annotations.append(
                f"{get_task_display_name(label)}: {pred} ({true}) {status}"
            )
        border = CONFUSION_COLORS["TP"] if all_correct else CONFUSION_COLORS["FP"]
        for spine in ax.spines.values():
            spine.set_edgecolor(border)
            spine.set_linewidth(3)
        subtitle = " | ".join(annotations[:3])
        if len(annotations) > 3:
            subtitle += f" +{len(annotations) - 3}"
        title = (
            str(metadata[i].get("level", f"Sample {i + 1}"))
            if metadata and i < len(metadata)
            else f"Sample {i + 1}"
        )
        ax.set_title(f"{title}\n{subtitle}", fontsize=8)
        ax.set_xticks([])
        ax.set_yticks([])
    for j in range(n, len(axes)):
        axes[j].axis("off")
    fig.suptitle(
        "Classification Predictions (green=all correct, red=any wrong)",
        fontweight="bold",
    )
    fig.tight_layout()
    return fig


def plot_classification_metrics(
    metrics: dict[str, float],
    target_labels: list[str],
) -> "plt.Figure":
    """Per-task metric bar charts (accuracy + F1-family)."""
    acc = [metrics.get(f"{label}_accuracy", 0.0) for label in target_labels]
    f1 = [
        metrics.get(f"{label}_f1", metrics.get(f"{label}_balanced_acc", 0.0) / 100)
        for label in target_labels
    ]
    display = [get_task_display_name(label) for label in target_labels]
    colors = [get_task_color(label) for label in target_labels]

    fig, axes = plt.subplots(1, 2, figsize=(max(10, 1.4 * len(target_labels)), 4))
    axes[0].bar(display, acc, color=colors, alpha=0.85)
    axes[0].set_ylabel("Accuracy (%)")
    axes[0].set_ylim(0, 100)
    axes[0].tick_params(axis="x", rotation=45)
    axes[0].grid(axis="y", alpha=0.3)
    axes[1].bar(display, f1, color=colors, alpha=0.85)
    axes[1].set_ylabel("F1 (binary) / balanced acc (multiclass)")
    axes[1].tick_params(axis="x", rotation=45)
    axes[1].grid(axis="y", alpha=0.3)
    fig.suptitle("Test metrics by task")
    fig.tight_layout()
    return fig


def plot_confusion_matrix_with_samples(
    label: str,
    images: Sequence[np.ndarray],
    predictions: np.ndarray,
    targets: np.ndarray,
    metadata: Sequence[dict[str, Any]] | None = None,
    max_samples_per_cell: int = 4,
) -> "plt.Figure":
    """Confusion matrix whose cells contain sample crops."""
    names = _class_names(label)
    n = len(names)
    pred_classes = _decode(predictions)
    # Targets arrive already 0-indexed (pfirrmann included) upstream.
    target_classes = np.asarray(targets).reshape(-1).astype(int)
    cm = _confusion_matrix(pred_classes, target_classes, n)

    cell = 2.2
    fig, axes = plt.subplots(n, n, figsize=(n * cell + 1.5, n * cell + 1.5))
    axes = np.atleast_2d(axes)
    grid = max_samples_per_cell
    sub = int(np.ceil(np.sqrt(grid)))

    for t in range(n):
        for p in range(n):
            ax = axes[t, p]
            ax.set_xticks([])
            ax.set_yticks([])
            count = cm[t, p]
            correct = t == p
            for spine in ax.spines.values():
                spine.set_color(
                    CONFUSION_COLORS["TP"] if correct else CONFUSION_COLORS["FP"]
                )
                spine.set_linewidth(2)
            idxs = np.where((target_classes == t) & (pred_classes == p))[0][:grid]
            if idxs.size and len(images):
                # Compose a sub-grid mosaic of sample crops.
                sample = to_display_image(images[idxs[0]])
                hh, ww = sample.shape[:2]
                mosaic = np.zeros((sub * hh, sub * ww), dtype=np.uint8)
                for j, idx in enumerate(idxs):
                    img = to_display_image(images[idx])
                    if img.ndim == 3:
                        img = img.mean(axis=-1).astype(np.uint8)
                    r, c = divmod(j, sub)
                    mosaic[r * hh : (r + 1) * hh, c * ww : (c + 1) * ww] = img
                ax.imshow(mosaic, cmap="gray")
            ax.set_title(f"n={count}", fontsize=8)
            if t == n - 1:
                ax.set_xlabel(f"pred {names[p]}", fontsize=8)
            if p == 0:
                ax.set_ylabel(f"true {names[t]}", fontsize=8)

    fig.suptitle(f"{get_task_display_name(label)} — confusion with samples")
    fig.tight_layout()
    return fig


def plot_test_samples_with_labels(
    images: Sequence[np.ndarray],
    predictions: dict[str, np.ndarray],
    targets: dict[str, np.ndarray],
    target_labels: list[str],
    metadata: Sequence[dict[str, Any]] | None = None,
    max_samples: int = 16,
) -> "plt.Figure":
    """Sample grid with per-task pred/target annotations."""
    n = min(max_samples, len(images))
    cols = 4
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 3.2, rows * 3.6))
    axes = np.atleast_1d(axes).reshape(-1)
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i >= n:
            continue
        ax.imshow(to_display_image(images[i]), cmap="gray")
        lines = []
        for label in target_labels[:4]:
            if label in predictions and i < len(predictions[label]):
                p = extract_prediction_value(predictions[label][i])
                t = int(np.asarray(targets[label][i]).reshape(-1)[0])
                mark = "✓" if p == t else "✗"
                lines.append(f"{label}: {p}/{t} {mark}")
        ax.set_title("\n".join(lines), fontsize=7)
    fig.tight_layout()
    return fig


def plot_confusion_examples(
    label: str,
    images: Sequence[np.ndarray],
    predictions: np.ndarray,
    targets: np.ndarray,
    samples_per_category: int = 4,
) -> "plt.Figure":
    """TP/TN/FP/FN example panels for a binary task."""
    pred_classes = _decode(predictions)
    target_classes = np.asarray(targets).reshape(-1).astype(int)
    categories = {
        "TP": (pred_classes == 1) & (target_classes == 1),
        "TN": (pred_classes == 0) & (target_classes == 0),
        "FP": (pred_classes == 1) & (target_classes == 0),
        "FN": (pred_classes == 0) & (target_classes == 1),
    }
    fig, axes = plt.subplots(
        4, samples_per_category, figsize=(samples_per_category * 2.4, 10)
    )
    for row, (cat, mask) in enumerate(categories.items()):
        idxs = np.where(mask)[0][:samples_per_category]
        for col in range(samples_per_category):
            ax = axes[row, col]
            ax.axis("off")
            if col < idxs.size:
                ax.imshow(to_display_image(images[idxs[col]]), cmap="gray")
            if col == 0:
                ax.set_title(cat, color=CONFUSION_COLORS[cat], loc="left")
    fig.suptitle(f"{get_task_display_name(label)} — confusion examples")
    fig.tight_layout()
    return fig


def plot_confusion_summary(
    predictions: dict[str, np.ndarray],
    targets: dict[str, np.ndarray],
    target_labels: list[str],
) -> "plt.Figure":
    """All tasks' confusion matrices on one figure."""
    labels = [lab for lab in target_labels if lab in predictions]
    n_tasks = max(len(labels), 1)
    cols = min(4, n_tasks)
    rows = (n_tasks + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 3.4, rows * 3.2))
    axes = np.atleast_1d(axes).reshape(-1)
    for i, ax in enumerate(axes):
        if i >= len(labels):
            ax.axis("off")
            continue
        label = labels[i]
        names = _class_names(label)
        n = len(names)
        pred_classes = _decode(predictions[label])
        target_classes = np.asarray(targets[label]).reshape(-1).astype(int)
        cm = _confusion_matrix(pred_classes, target_classes, n)
        im = ax.imshow(cm, cmap="Blues")
        for t in range(n):
            for p in range(n):
                ax.text(
                    p, t, str(cm[t, p]), ha="center", va="center",
                    fontsize=8,
                    color="white" if cm[t, p] > cm.max() / 2 else "black",
                )
        ax.set_xticks(range(n))
        ax.set_yticks(range(n))
        ax.set_xticklabels(names, fontsize=6, rotation=45)
        ax.set_yticklabels(names, fontsize=6)
        ax.set_title(get_task_display_name(label), fontsize=9)
        ax.set_xlabel("Predicted", fontsize=7)
        ax.set_ylabel("True", fontsize=7)
    fig.tight_layout()
    return fig


def plot_label_distribution(
    distributions: dict[str, dict[str, dict[Any, int]]],
    target_labels: list[str],
) -> "plt.Figure":
    """Label distributions across splits."""
    n_tasks = len(target_labels)
    cols = min(4, max(n_tasks, 1))
    rows = (n_tasks + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 3.6, rows * 3.0))
    axes = np.atleast_1d(axes).reshape(-1)
    splits = list(distributions.keys())
    width = 0.8 / max(len(splits), 1)

    for i, ax in enumerate(axes):
        if i >= n_tasks:
            ax.axis("off")
            continue
        label = target_labels[i]
        all_values = sorted(
            {
                v
                for split in splits
                for v in distributions[split].get(label, {})
            }
        )
        x = np.arange(len(all_values))
        for j, split in enumerate(splits):
            counts = [
                distributions[split].get(label, {}).get(v, 0) for v in all_values
            ]
            ax.bar(
                x + j * width,
                counts,
                width,
                label=split,
                color=SPLIT_COLORS.get(split),
                alpha=0.85,
            )
        ax.set_xticks(x + width * (len(splits) - 1) / 2)
        ax.set_xticklabels([str(v) for v in all_values], fontsize=7)
        ax.set_title(get_task_display_name(label), fontsize=9)
        if i == 0:
            ax.legend(fontsize=7)
    fig.suptitle("Label distribution by split")
    fig.tight_layout()
    return fig
