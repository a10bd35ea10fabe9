"""Host-side localization metrics (numpy), copied from
``spine_vision_tpu/metrics/__init__.py::LocalizationMetrics``.

MED (mean Euclidean distance in normalised units) with its std and median,
per-coordinate MAE, PCK at thresholds (percent of predictions within a
distance) and the per-level MED. The trainer's best-model gating reads
``med``. The classification metrics wait for the classification trainer
(ROADMAP.md, Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any

import numpy as np

LEVEL_NAMES_DEFAULT = ["L1/L2", "L2/L3", "L3/L4", "L4/L5", "L5/S1"]


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
