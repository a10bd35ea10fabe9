"""Visualizer classes: save plumbing + tracker mirroring.

Counterpart of ``spine_vision_tpu/viz/visualizer.py``: ``TrainingVisualizer``
wraps every plot function, saves through ``save_figure`` (its three output
modes) and mirrors figures to the experiment tracker;
``DatasetVisualizer.generate_all`` renders the dataset-statistics suite.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import numpy as np

from spine_vision_torch.viz import classification as C
from spine_vision_torch.viz import dataset as D
from spine_vision_torch.viz import localization as L
from spine_vision_torch.viz import training as T
from spine_vision_torch.viz.base import save_figure
from spine_vision_torch.viz.tracker import ExperimentTracker


class BaseVisualizer:
    """Common save plumbing."""

    def __init__(
        self,
        output_path: Path,
        output_mode: str = "image",
        tracker: ExperimentTracker | None = None,
    ) -> None:
        self.output_path = Path(output_path)
        self.output_mode = output_mode
        self.tracker = tracker

    def _save(self, fig: Any, filename: str) -> Path:
        path = save_figure(fig, self.output_path, filename, self.output_mode)
        if self.tracker is not None:
            self.tracker.log_figure(path)
        return path


class TrainingVisualizer(BaseVisualizer):
    """All training-time figures, mirrored to the tracker when enabled."""

    def plot_training_curves(
        self, history: dict[str, list[float]], filename: str = "training_curves"
    ) -> Path:
        return self._save(T.plot_training_curves(history), filename)

    def plot_localization_predictions(
        self,
        images: Sequence[np.ndarray],
        predictions: np.ndarray,
        targets: np.ndarray,
        metadata: Sequence[dict[str, Any]] | None = None,
        filename: str = "predictions",
    ) -> Path:
        return self._save(
            L.plot_localization_predictions(images, predictions, targets, metadata),
            filename,
        )

    def plot_error_distribution(
        self,
        predictions: np.ndarray,
        targets: np.ndarray,
        levels: np.ndarray | None = None,
        level_names: list[str] | None = None,
        filename: str = "error_distribution",
    ) -> Path:
        return self._save(
            L.plot_error_distribution(predictions, targets, levels, level_names),
            filename,
        )

    def plot_per_level_metrics(
        self,
        metrics: dict[str, float],
        level_names: list[str],
        metric_prefix: str = "med_",
        filename: str = "per_level_metrics",
    ) -> Path:
        return self._save(
            L.plot_per_level_metrics(metrics, level_names, metric_prefix), filename
        )

    def plot_classification_metrics(
        self,
        metrics: dict[str, float],
        target_labels: list[str],
        filename: str = "test_metrics",
    ) -> Path:
        return self._save(
            C.plot_classification_metrics(metrics, target_labels), filename
        )

    def plot_classification_predictions(
        self,
        images,
        predictions,
        targets,
        metadata=None,
        num_samples: int = 16,
        filename: str = "classification_predictions",
    ) -> Path:
        return self._save(
            C.plot_classification_predictions(
                images, predictions, targets, metadata, num_samples
            ),
            filename,
        )

    def plot_confusion_matrices_with_samples(
        self,
        images: Sequence[np.ndarray],
        predictions: dict[str, np.ndarray],
        targets: dict[str, np.ndarray],
        target_labels: list[str],
        metadata: Sequence[dict[str, Any]] | None = None,
        max_samples_per_cell: int = 4,
        filename_prefix: str = "confusion_matrix_samples",
    ) -> list[Path]:
        paths = []
        for label in target_labels:
            if label not in predictions or label not in targets:
                continue
            fig = C.plot_confusion_matrix_with_samples(
                label,
                images,
                predictions[label],
                targets[label],
                metadata,
                max_samples_per_cell,
            )
            paths.append(self._save(fig, f"{filename_prefix}_{label}"))
        return paths

    def plot_confusion_examples(
        self,
        label: str,
        images: Sequence[np.ndarray],
        predictions: np.ndarray,
        targets: np.ndarray,
        filename: str | None = None,
    ) -> Path:
        return self._save(
            C.plot_confusion_examples(label, images, predictions, targets),
            filename or f"confusion_examples_{label}",
        )

    def plot_confusion_summary(
        self,
        predictions: dict[str, np.ndarray],
        targets: dict[str, np.ndarray],
        target_labels: list[str],
        filename: str = "confusion_summary",
    ) -> Path:
        return self._save(
            C.plot_confusion_summary(predictions, targets, target_labels), filename
        )

    def plot_test_samples_with_labels(
        self,
        images: Sequence[np.ndarray],
        predictions: dict[str, np.ndarray],
        targets: dict[str, np.ndarray],
        target_labels: list[str],
        metadata: Sequence[dict[str, Any]] | None = None,
        filename: str = "test_samples",
    ) -> Path:
        return self._save(
            C.plot_test_samples_with_labels(
                images, predictions, targets, target_labels, metadata
            ),
            filename,
        )

    def plot_label_distribution(
        self,
        distributions: dict[str, dict[str, dict[Any, int]]],
        target_labels: list[str],
        filename: str = "label_distribution",
    ) -> Path:
        return self._save(
            C.plot_label_distribution(distributions, target_labels), filename
        )


class DatasetVisualizer(BaseVisualizer):
    """Dataset-statistics figure suite."""

    def generate_all(self, dataset: Any, prefix: str = "dataset") -> list[Path]:
        """Render the full statistics suite for a ClassificationDataset-like
        object (get_stats / get_label_distribution / records)."""
        paths: list[Path] = []
        stats = dataset.get_stats()
        paths.append(self._save(D.plot_dataset_statistics(stats), f"{prefix}_stats"))

        if hasattr(dataset, "get_label_distribution"):
            dist = dataset.get_label_distribution()
            paths.append(
                self._save(
                    D.plot_samples_per_class(dist, list(dist.keys())),
                    f"{prefix}_samples_per_class",
                )
            )
            binary = [
                lab
                for lab, counts in dist.items()
                if set(int(k) for k in counts) <= {0, 1}
            ]
            if binary:
                paths.append(
                    self._save(
                        D.plot_binary_label_distributions(dist, binary),
                        f"{prefix}_binary_labels",
                    )
                )
        records = getattr(dataset, "records", None)
        if records:
            binary_keys = [
                "herniation",
                "bulging",
                "upper_endplate",
                "lower_endplate",
                "spondylolisthesis",
                "narrowing",
            ]
            paths.append(
                self._save(
                    D.plot_label_cooccurrence(records, binary_keys),
                    f"{prefix}_cooccurrence",
                )
            )
            if any("pfirrmann" in r for r in records[:1]):
                paths.append(
                    self._save(
                        D.plot_pfirrmann_by_level(records),
                        f"{prefix}_pfirrmann_by_level",
                    )
                )
        return paths
