"""Lightweight experiment tracker (JSONL + figure mirror).

Counterpart of ``spine_vision_tpu/viz/tracker.py``, pure standard library:
metrics are appended to ``metrics.jsonl`` in the run's logs dir, config
snapshots to ``tracker_config.json``, and figures logged through the
visualizer are copied under ``media/``. The interface is what the trainers
need (log_config / log_metrics / log_figure / finish), so a real tracking
backend can be dropped in by subclassing. It imports no plotting library:
``from spine_vision_torch.viz.tracker import ExperimentTracker`` works on a
host without matplotlib.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any


class ExperimentTracker:
    """Append-only JSONL experiment tracker."""

    def __init__(
        self,
        project: str,
        run_name: str,
        output_path: Path,
    ) -> None:
        self.project = project
        self.run_name = run_name
        self.output_path = Path(output_path)
        self.output_path.mkdir(parents=True, exist_ok=True)
        self._metrics_file = self.output_path / "metrics.jsonl"
        self._media_dir = self.output_path / "media"
        self._start = time.time()

    def log_config(self, config: dict[str, Any]) -> None:
        """Snapshot run configuration."""
        payload = {
            "project": self.project,
            "run_name": self.run_name,
            "config": {k: _jsonable(v) for k, v in config.items()},
        }
        (self.output_path / "tracker_config.json").write_text(
            json.dumps(payload, indent=2)
        )

    def log_metrics(self, metrics: dict[str, float], step: int | None = None) -> None:
        """Append a metrics record."""
        record = {
            "time": time.time() - self._start,
            "step": step,
            **{k: _jsonable(v) for k, v in metrics.items()},
        }
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_figure(self, figure_path: Path, name: str | None = None) -> None:
        """Mirror a saved figure into the run's media directory."""
        figure_path = Path(figure_path)
        if not figure_path.exists():
            return
        self._media_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(figure_path, self._media_dir / (name or figure_path.name))

    def finish(self) -> None:
        """Close out the run."""
        self.log_metrics({"_finished": 1.0})


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return str(v)
