"""Visualization: plot inventory + visualizer classes + experiment tracker.

Counterpart of ``spine_vision_tpu/viz/__init__.py``, with the same public
names. Only the tracker is imported with the package: the plotting names
load their modules (and matplotlib, on the Agg backend) at first access, so
``ExperimentTracker`` works on a host without matplotlib.
"""

from spine_vision_torch.viz.tracker import ExperimentTracker

_LAZY = {
    "spine_vision_torch.viz.base": (
        "CONFUSION_COLORS", "SPLIT_COLORS", "extract_prediction_value",
        "load_classification_original_images", "make_image_grid", "save_figure",
    ),
    "spine_vision_torch.viz.classification": (
        "plot_classification_metrics", "plot_classification_predictions",
        "plot_confusion_examples", "plot_confusion_matrix_with_samples",
        "plot_confusion_summary", "plot_label_distribution", "plot_test_samples_with_labels",
    ),
    "spine_vision_torch.viz.dataset": (
        "plot_binary_label_distributions", "plot_dataset_statistics", "plot_label_cooccurrence",
        "plot_pfirrmann_by_level", "plot_samples_per_class",
    ),
    "spine_vision_torch.viz.localization": (
        "plot_error_distribution", "plot_localization_predictions", "plot_per_level_metrics",
        "visualize_sample",
    ),
    "spine_vision_torch.viz.training": ("plot_training_curves",),
    "spine_vision_torch.viz.visualizer": (
        "BaseVisualizer", "DatasetVisualizer", "TrainingVisualizer",
    ),
}
_MODULE_OF = {name: module for module, names in _LAZY.items() for name in names}

__all__ = sorted(["ExperimentTracker", *_MODULE_OF], key=lambda n: (not n.isupper(), n))


def __getattr__(name: str):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
