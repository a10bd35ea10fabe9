"""Fused study inference and the directory server."""

from spine_vision_torch.infer.pipeline import (
    DEFAULT_IVD_CENTERS_XY,
    SeriesCropPipeline,
    StudyInferencePipeline,
    StudyInput,
    StudyPipelineConfig,
    StudyResult,
    loc_and_crop,
    study_input_from_paths,
)
from spine_vision_torch.infer.serve import ServeStats, serve_directory

__all__ = [
    "DEFAULT_IVD_CENTERS_XY",
    "SeriesCropPipeline",
    "ServeStats",
    "StudyInferencePipeline",
    "StudyInput",
    "StudyPipelineConfig",
    "StudyResult",
    "loc_and_crop",
    "serve_directory",
    "study_input_from_paths",
]
