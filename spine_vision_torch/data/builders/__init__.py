"""Dataset builders: localization ingest and the classification crop set."""

from spine_vision_torch.data.builders.base import ProcessingResult
from spine_vision_torch.data.builders.classification import (
    ClassificationDatasetConfig,
    ClassificationRecord,
    create_classification_dataset,
    parse_image_filename,
    scan_existing_images,
)
from spine_vision_torch.data.builders.localization import (
    AnnotationRecord,
    LocalizationDatasetConfig,
    create_localization_dataset,
    process_lumbar_coords_pretrain,
    process_rsna_improved,
)

__all__ = [
    "AnnotationRecord",
    "ClassificationDatasetConfig",
    "ClassificationRecord",
    "LocalizationDatasetConfig",
    "ProcessingResult",
    "create_classification_dataset",
    "create_localization_dataset",
    "parse_image_filename",
    "process_lumbar_coords_pretrain",
    "process_rsna_improved",
    "scan_existing_images",
]
