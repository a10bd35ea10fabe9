"""Dataset statistics plots.

Counterpart of ``spine_vision_tpu/viz/dataset.py``: the same matplotlib
calls in the same order, so a figure renders to the same pixels.
"""

from __future__ import annotations

from typing import Any

import matplotlib.pyplot as plt
import numpy as np

from spine_vision_torch.core.tasks import get_task_color, get_task_display_name


def plot_dataset_statistics(stats: dict[str, Any]) -> "plt.Figure":
    """Overview panel: counts by level / source / series type."""
    panels = [
        ("levels", "Samples per IVD level"),
        ("sources", "Samples per source"),
        ("series_types", "Samples per series type"),
    ]
    present = [
        (key, title) for key, title in panels if isinstance(stats.get(key), dict)
    ]
    n = max(len(present), 1)
    fig, axes = plt.subplots(1, n, figsize=(n * 4, 3.5))
    axes = np.atleast_1d(axes)
    for ax, (key, title) in zip(axes, present):
        data = stats[key]
        names = [str(k) for k in data]
        ax.bar(names, list(data.values()), color="#1f77b4", alpha=0.85)
        ax.set_title(title, fontsize=9)
        ax.tick_params(axis="x", rotation=45)
        ax.grid(axis="y", alpha=0.3)
    fig.suptitle(
        f"Dataset: {stats.get('num_samples', stats.get('num_images', 0))} samples"
    )
    fig.tight_layout()
    return fig


def plot_binary_label_distributions(
    distribution: dict[str, dict[Any, int]],
    binary_labels: list[str] | None = None,
) -> "plt.Figure":
    """Positive/negative counts per binary label."""
    labels = binary_labels or [
        lab
        for lab, counts in distribution.items()
        if set(map(int, counts)) <= {0, 1}
    ]
    pos = [distribution.get(lab, {}).get(1, 0) for lab in labels]
    neg = [distribution.get(lab, {}).get(0, 0) for lab in labels]
    x = np.arange(len(labels))
    fig, ax = plt.subplots(figsize=(max(7, 1.2 * len(labels)), 4))
    ax.bar(x - 0.2, neg, 0.4, label="negative", color="#1f77b4", alpha=0.85)
    ax.bar(x + 0.2, pos, 0.4, label="positive", color="#d62728", alpha=0.85)
    ax.set_xticks(x)
    ax.set_xticklabels(
        [get_task_display_name(lab) for lab in labels], rotation=45, fontsize=8
    )
    ax.legend()
    ax.grid(axis="y", alpha=0.3)
    ax.set_title("Binary label distributions")
    fig.tight_layout()
    return fig


def plot_label_cooccurrence(
    records: list[dict[str, Any]],
    binary_keys: list[str],
) -> "plt.Figure":
    """Heatmap of pairwise co-occurrence rates between binary conditions."""
    n = len(binary_keys)
    matrix = np.zeros((n, n))
    if records:
        values = np.asarray(
            [[int(r.get(k, 0) > 0) for k in binary_keys] for r in records]
        )
        matrix = (values.T @ values) / max(len(records), 1)
    fig, ax = plt.subplots(figsize=(1.0 * n + 2, 1.0 * n + 2))
    im = ax.imshow(matrix, cmap="YlOrRd", vmin=0)
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(binary_keys, rotation=45, fontsize=7)
    ax.set_yticklabels(binary_keys, fontsize=7)
    for i in range(n):
        for j in range(n):
            ax.text(j, i, f"{matrix[i, j]:.2f}", ha="center", va="center", fontsize=6)
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title("Label co-occurrence rate")
    fig.tight_layout()
    return fig


def plot_pfirrmann_by_level(
    records: list[dict[str, Any]],
) -> "plt.Figure":
    """Stacked bars: Pfirrmann grade distribution per IVD level."""
    from spine_vision_torch.data.levels import IDX_TO_LEVEL

    levels = sorted({r.get("level_idx", 0) for r in records})
    grades = list(range(1, 6))
    counts = {
        lvl: [
            sum(
                1
                for r in records
                if r.get("level_idx") == lvl and r.get("pfirrmann") == g
            )
            for g in grades
        ]
        for lvl in levels
    }
    fig, ax = plt.subplots(figsize=(8, 4))
    bottom = np.zeros(len(levels))
    cmap = plt.get_cmap("viridis")
    for gi, g in enumerate(grades):
        values = np.asarray([counts[lvl][gi] for lvl in levels], dtype=float)
        ax.bar(
            [IDX_TO_LEVEL.get(lvl, str(lvl)) for lvl in levels],
            values,
            bottom=bottom,
            label=f"Grade {g}",
            color=cmap(gi / 4),
        )
        bottom += values
    ax.legend(fontsize=7)
    ax.set_title("Pfirrmann grades by IVD level")
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    return fig


def plot_samples_per_class(
    distribution: dict[str, dict[Any, int]],
    target_labels: list[str],
) -> "plt.Figure":
    """Bar panels of per-class sample counts for each task."""
    n = len(target_labels)
    cols = min(4, max(n, 1))
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 3.4, rows * 2.8))
    axes = np.atleast_1d(axes).reshape(-1)
    for i, ax in enumerate(axes):
        if i >= n:
            ax.axis("off")
            continue
        label = target_labels[i]
        counts = distribution.get(label, {})
        keys = sorted(counts)
        ax.bar(
            [str(k) for k in keys],
            [counts[k] for k in keys],
            color=get_task_color(label),
            alpha=0.85,
        )
        ax.set_title(get_task_display_name(label), fontsize=9)
        ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    return fig
