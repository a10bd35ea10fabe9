"""RSNA lumbar-spine series lookups for the localization builder.

Counterpart of ``spine_vision_tpu/data/rsna.py``: ``train_series_descriptions.csv``
maps to ``study_id -> {series_id -> series_description}``. Keyed by
``series_id`` as the JAX package keys it (unique in a study), so two series
of one study with the same description both resolve.
"""

from __future__ import annotations

import csv
from pathlib import Path


def load_series_mapping(series_desc_path: Path) -> dict[int, dict[int, str]]:
    """study_id -> {series_id -> series_description} from the RSNA CSV."""
    mapping: dict[int, dict[int, str]] = {}
    with open(series_desc_path, newline="") as f:
        for row in csv.DictReader(f):
            study_id = int(row["study_id"])
            mapping.setdefault(study_id, {})[int(row["series_id"])] = row["series_description"]
    return mapping


def get_series_type(
    series_id: int, study_id: int, series_mapping: dict[int, dict[int, str]]
) -> str | None:
    """Series description of a series_id within a study (None if absent)."""
    study = series_mapping.get(study_id)
    if study is None:
        return None
    return study.get(series_id)
