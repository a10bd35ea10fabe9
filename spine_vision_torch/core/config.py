"""Base configuration shared by the CLI-facing configs.

Counterpart of ``spine_vision_tpu/core/config.py``, whose ``BaseConfig`` is a
pydantic model; here it is a dataclass with the same fields and
``cli_aliases``, as ``train/trainer.py::TrainingConfig`` is.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import ClassVar


@dataclass
class BaseConfig:
    """Common fields: ``verbose`` (DEBUG-level logging, CLI alias ``-v``),
    ``enable_file_log`` (also log to a rotating file) and ``log_path`` (its
    directory)."""

    verbose: bool = False
    enable_file_log: bool = False
    log_path: Path = field(default_factory=lambda: Path.cwd() / "logs")

    cli_aliases: ClassVar[dict[str, list[str]]] = {"verbose": ["-v"]}
