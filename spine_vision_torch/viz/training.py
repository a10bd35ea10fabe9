"""Training-curve plots.

Counterpart of ``spine_vision_tpu/viz/training.py``.
"""

from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np


def plot_training_curves(history: dict[str, list[float]]) -> "plt.Figure":
    """Stacked subplots: loss (train/val), validation metrics, learning rate."""
    metric_keys = [
        k
        for k in history
        if k not in ("train_loss", "val_loss", "lr") and history[k]
    ]
    n_panels = 2 + (1 if metric_keys else 0)
    fig, axes = plt.subplots(n_panels, 1, figsize=(10, 4 * n_panels), sharex=True)
    axes = np.atleast_1d(axes)

    ax = axes[0]
    if history.get("train_loss"):
        ax.plot(history["train_loss"], label="train", color="#1f77b4")
    if history.get("val_loss"):
        ax.plot(history["val_loss"], label="val", color="#ff7f0e")
    ax.set_ylabel("Loss")
    ax.legend()
    ax.grid(alpha=0.3)
    ax.set_title("Training curves")

    panel = 1
    if metric_keys:
        ax = axes[panel]
        for key in metric_keys[:8]:
            ax.plot(history[key], label=key)
        ax.set_ylabel("Metrics")
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
        panel += 1

    ax = axes[panel]
    if history.get("lr"):
        ax.plot(history["lr"], color="#2ca02c")
    ax.set_ylabel("Learning rate")
    ax.set_xlabel("Epoch")
    ax.set_yscale("log")
    ax.grid(alpha=0.3)

    fig.tight_layout()
    return fig
