"""Profiling: a ``torch.profiler`` trace of a region, and step wall times.

Counterpart of ``spine_vision_tpu/utils/profiling.py``. ``trace_profile``
records the host's and, where there is a card, the device's activity over
the enclosed region and writes a Chrome trace (``trace.json``, viewable in
Perfetto or ``chrome://tracing``) under the given directory; a profiler
that cannot start or stop degrades to a warning, as the JAX package's does.
``StepTimer`` accumulates step wall times and reports their p50, p95 and
mean; the trainer's ``profile_steps`` records its steps with it.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

logger = logging.getLogger("spine_vision_torch")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_profile(log_dir: Path | str) -> Iterator[None]:
    """Trace the enclosed region into ``log_dir/trace.json``.

    Usage::

        with trace_profile("logs/profile"):
            train_step(state, batch)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as exc:  # a backend that refuses tracing
        logger.warning("Profiler trace unavailable: %s", exc)
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            log_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(log_dir / TRACE_FILE))
            logger.info("Profiler trace written to %s", log_dir / TRACE_FILE)
        except Exception as exc:
            logger.warning("Profiler stop failed: %s", exc)


class StepTimer:
    """Accumulates step wall times and summarises percentiles."""

    def __init__(self) -> None:
        self._times: list[float] = []
        self._start: float | None = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        if self._start is not None:
            self._times.append(time.perf_counter() - self._start)
            self._start = None

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def times(self) -> list[float]:
        """The recorded wall times in seconds, in order (a copy)."""
        return list(self._times)

    def __len__(self) -> int:
        return len(self._times)

    def summary(self, skip_first: int = 1) -> dict[str, float]:
        """p50, p95 and mean seconds, skipping the first ``skip_first``
        (warm-up) steps unless nothing else is left."""
        times = np.asarray(self._times[skip_first:] or self._times)
        if times.size == 0:
            return {}
        return {
            "steps": float(times.size),
            "mean_s": float(times.mean()),
            "p50_s": float(np.percentile(times, 50)),
            "p95_s": float(np.percentile(times, 95)),
        }
