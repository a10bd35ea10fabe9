"""Localization plots: prediction overlays, error distributions, per-level MED.

Counterpart of ``spine_vision_tpu/viz/localization.py``: the same matplotlib
calls in the same order, so a figure renders to the same pixels. Coordinates
are normalized [0,1] (x, y); overlays denormalize per image.
"""

from __future__ import annotations

from typing import Any, Sequence

import matplotlib.pyplot as plt
import numpy as np

from spine_vision_torch.viz.base import to_display_image


def plot_localization_predictions(
    images: Sequence[np.ndarray],
    predictions: np.ndarray,
    targets: np.ndarray,
    metadata: Sequence[dict[str, Any]] | None = None,
    max_samples: int = 16,
    cols: int = 4,
) -> "plt.Figure":
    """GT-vs-prediction overlay grid: green = target, red = prediction."""
    n = min(len(images), len(predictions), max_samples)
    if n == 0:
        fig, ax = plt.subplots(figsize=(4, 3))
        ax.axis("off")
        ax.set_title("No samples")
        return fig
    cols = max(1, min(cols, n))
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 3, rows * 3))
    axes = np.atleast_1d(axes).reshape(-1)

    for i, ax in enumerate(axes):
        ax.axis("off")
        if i >= n:
            continue
        img = to_display_image(images[i])
        h, w = img.shape[:2]
        ax.imshow(img, cmap="gray")
        tx, ty = targets[i][0] * w, targets[i][1] * h
        px, py = predictions[i][0] * w, predictions[i][1] * h
        ax.scatter([tx], [ty], c="#2ca02c", marker="o", s=40, label="target")
        ax.scatter([px], [py], c="#d62728", marker="x", s=40, label="pred")
        ax.plot([tx, px], [ty, py], c="#ffdd57", lw=1, alpha=0.8)
        title = ""
        if metadata is not None and i < len(metadata):
            title = str(metadata[i].get("level", ""))
        err = float(np.hypot(predictions[i][0] - targets[i][0],
                             predictions[i][1] - targets[i][1]))
        ax.set_title(f"{title} err={err:.3f}", fontsize=8)
    handles, labels = axes[0].get_legend_handles_labels()
    if handles:
        fig.legend(handles[:2], labels[:2], loc="lower center", ncol=2)
    fig.tight_layout()
    return fig


def plot_error_distribution(
    predictions: np.ndarray,
    targets: np.ndarray,
    levels: np.ndarray | None = None,
    level_names: list[str] | None = None,
) -> "plt.Figure":
    """Histogram of Euclidean errors, overall and per level."""
    distances = np.sqrt(np.sum((predictions - targets) ** 2, axis=1))
    n_panels = 2 if levels is not None else 1
    fig, axes = plt.subplots(1, n_panels, figsize=(6 * n_panels, 4))
    axes = np.atleast_1d(axes)

    axes[0].hist(distances, bins=40, color="#1f77b4", alpha=0.8)
    axes[0].axvline(
        float(np.mean(distances)), color="#d62728", ls="--",
        label=f"mean={np.mean(distances):.4f}",
    )
    axes[0].axvline(
        float(np.median(distances)), color="#2ca02c", ls="--",
        label=f"median={np.median(distances):.4f}",
    )
    axes[0].set_xlabel("Normalized Euclidean error")
    axes[0].set_ylabel("Count")
    axes[0].legend()
    axes[0].set_title("Error distribution")

    if levels is not None:
        # Pair labels with the actual level VALUES present — indexing by
        # range(len(names)) mislabels boxes when values are non-contiguous.
        if level_names is not None:
            unique_values = list(range(len(level_names)))
            names = level_names
        else:
            unique_values = [int(v) for v in np.unique(levels)]
            names = [str(v) for v in unique_values]
        data = [distances[levels == v] for v in unique_values]
        data = [d if d.size else np.array([0.0]) for d in data]
        axes[1].boxplot(data, tick_labels=names)
        axes[1].set_ylabel("Error")
        axes[1].set_title("Error by level")
        axes[1].tick_params(axis="x", rotation=45)

    fig.tight_layout()
    return fig


def plot_per_level_metrics(
    metrics: dict[str, float],
    level_names: list[str],
    metric_prefix: str = "med_",
) -> "plt.Figure":
    """Bar chart of a per-level metric (default MED)."""
    values = [metrics.get(f"{metric_prefix}{name}", 0.0) for name in level_names]
    fig, ax = plt.subplots(figsize=(7, 4))
    bars = ax.bar(level_names, values, color="#1f77b4", alpha=0.85)
    for bar, value in zip(bars, values):
        ax.text(
            bar.get_x() + bar.get_width() / 2,
            bar.get_height(),
            f"{value:.4f}",
            ha="center",
            va="bottom",
            fontsize=8,
        )
    ax.set_ylabel(metric_prefix.rstrip("_").upper())
    ax.set_title(f"Per-level {metric_prefix.rstrip('_').upper()}")
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    return fig


def visualize_sample(
    image: np.ndarray,
    coords: np.ndarray,
    mask: np.ndarray | None = None,
    level_names: list[str] | None = None,
) -> "plt.Figure":
    """Single-image annotation overlay."""
    img = to_display_image(image)
    h, w = img.shape[:2]
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.imshow(img, cmap="gray")
    ax.axis("off")
    for i, (x, y) in enumerate(np.asarray(coords)):
        if mask is not None and mask[i] <= 0:
            continue
        ax.scatter([x * w], [y * h], s=40)
        name = level_names[i] if level_names and i < len(level_names) else str(i)
        ax.annotate(name, (x * w + 4, y * h), color="yellow", fontsize=8)
    return fig
