"""Configuration, logging, registries and the task registry
(``core/tasks.py``, imported from there)."""

from spine_vision_torch.core.config import BaseConfig
from spine_vision_torch.core.logging import add_file_log, logger, setup_logger
from spine_vision_torch.core.registry import (
    METRICS_REGISTRY,
    MODEL_REGISTRY,
    TRAINER_REGISTRY,
    Registry,
    create_trainer_from_config,
    get_trainer_config_class,
    register_metrics,
    register_model,
    register_trainer,
)

__all__ = [
    "BaseConfig",
    "METRICS_REGISTRY",
    "MODEL_REGISTRY",
    "Registry",
    "TRAINER_REGISTRY",
    "add_file_log",
    "create_trainer_from_config",
    "get_trainer_config_class",
    "logger",
    "register_metrics",
    "register_model",
    "register_trainer",
    "setup_logger",
]
