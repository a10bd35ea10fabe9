"""Host input of the port: level constants, datasets, the seeded loader, the
image store and cache, and the dataset builders (``builders``, ``rsna``,
``phenikaa``).

The builders' names below are loaded when first used, so that importing a
light module of this package (``data.png``, say) does not import the
inference pipeline the builders run on.
"""

from importlib import import_module

_LAZY = {
    "AnnotationRecord": "builders",
    "ClassificationDatasetConfig": "builders",
    "ClassificationRecord": "builders",
    "LocalizationDatasetConfig": "builders",
    "ProcessingResult": "builders",
    "create_classification_dataset": "builders",
    "create_localization_dataset": "builders",
    "parse_image_filename": "builders",
    "process_lumbar_coords_pretrain": "builders",
    "process_rsna_improved": "builders",
    "scan_existing_images": "builders",
    "get_series_type": "rsna",
    "load_series_mapping": "rsna",
    "PreprocessConfig": "phenikaa",
    "preprocess_phenikaa": "phenikaa",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)
