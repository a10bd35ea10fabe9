"""Shared builder result container.

Counterpart of ``spine_vision_tpu/data/builders/base.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path


@dataclass
class ProcessingResult:
    """Statistics and metadata of a dataset-build run."""

    num_samples: int
    output_path: Path
    summary: str = ""
