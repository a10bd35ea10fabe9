"""Directory-watching batch server over the study pipeline.

Counterpart of ``spine_vision_tpu/infer/serve.py``. Requests are JSON files
``{"study_id": str, "t1": path, "t2": path}`` dropped into a watch
directory; the server drains the backlog in batches through one
:class:`StudyInferencePipeline` (its power-of-two bucketing keeps the batch
shapes few), writes ``<study_id>.json`` results, and moves each processed
request file to ``done/``, or to ``failed/`` with a ``<stem>.error.txt``
beside it when a request is malformed or its volumes cannot be read.

Host I/O overlaps the card: decoding a study's two series takes tens of ms,
more than the graph, so a prefetch thread claims and decodes the next batch
while the card runs the current one. Batches are claimed by renaming
request files into a per-server ``inflight/<host>-<pid>-<proc>-<call>/``
directory, so a concurrent server can never pick the same file. ``<proc>``
is a token drawn once per process when this module is imported, ``<call>``
one drawn per :func:`serve_directory` call; together they tell a starting
server a live sibling's claims from a crashed server's:

- an owner on another host: left alone (its liveness cannot be checked;
  scale-out across hosts should use per-host watch directories);
- our pid with another ``<proc>``: a dead predecessor whose pid was
  recycled, re-queued;
- our pid and our ``<proc>``: a live sibling server in this process, left
  alone;
- another pid on this host: re-queued once ``os.kill(pid, 0)`` finds it dead;
- loose request files at the inflight root and the JAX package's
  ``<host>-<pid>`` directories: handled as the JAX package handles them
  (the first always re-queued, the second by its pid, ours counting as a
  dead predecessor's).

The JAX package names the claim directory ``<host>-<pid>``, so a second
server in the same process takes the first one's live claims for a dead
predecessor's and re-queues them.
"""

from __future__ import annotations

import json
import os
import re
import secrets
import shutil
import socket
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from spine_vision_torch.core.logging import logger
from spine_vision_torch.infer.pipeline import (
    StudyInferencePipeline,
    StudyInput,
    StudyResult,
    study_input_from_paths,
)

# Drawn once per process: a claim directory carrying our pid and this token
# belongs to a live server in this process.
PROCESS_TOKEN = secrets.token_hex(6)
_TOKEN = re.compile(r"[0-9a-f]{12}")


@dataclass
class ServeStats:
    """Counters returned by :func:`serve_directory`."""

    processed: int = 0
    failed: int = 0
    batches: int = 0
    study_ids: list[str] = field(default_factory=list)


def _result_payload(result: StudyResult) -> dict:
    return {
        "study_id": result.study_id,
        "coords": result.coords.tolist(),
        "predictions": {k: v.tolist() for k, v in result.predictions.items()},
        "probabilities": {k: v.tolist() for k, v in result.probabilities.items()},
    }


def _load_request(path: Path, device: Any) -> StudyInput:
    spec = json.loads(path.read_text())
    if not isinstance(spec, dict) or "t1" not in spec or "t2" not in spec:
        raise ValueError(f"request {path.name} must carry 't1' and 't2' paths")
    return study_input_from_paths(
        Path(spec["t1"]), Path(spec["t2"]), study_id=str(spec.get("study_id") or path.stem),
        device=device,
    )


@dataclass
class _Batch:
    """One claimed and decoded request batch (made by the prefetch thread)."""

    studies: list[StudyInput] = field(default_factory=list)
    paths: list[Path] = field(default_factory=list)  # inflight paths, 1:1
    failures: list[tuple[Path, str]] = field(default_factory=list)

    def __bool__(self) -> bool:
        return bool(self.studies or self.failures)


def _claim_and_load(watch_dir: Path, claim_dir: Path, max_batch: int, device: Any) -> _Batch:
    """Claim up to ``max_batch`` requests by renaming them into ``claim_dir``
    (a concurrent claim of the same file fails its rename) and decode their
    volumes. Runs on the prefetch thread."""

    def _mtime(p: Path) -> float:
        # A concurrent server can rename the file away between glob() and
        # stat(); the rename below arbitrates, so sort a vanished entry last.
        try:
            return p.stat().st_mtime
        except OSError:
            return float("inf")

    requests = sorted(watch_dir.glob("*.json"), key=_mtime)[:max_batch]
    batch = _Batch()
    for path in requests:
        staged = claim_dir / path.name
        try:
            path.rename(staged)
        except OSError:
            continue  # claimed elsewhere or vanished
        try:
            batch.studies.append(_load_request(staged, device))
            batch.paths.append(staged)
        except Exception as exc:  # noqa: BLE001 -- a bad request fails alone
            batch.failures.append((staged, str(exc)))
    return batch


def _owner(name: str, host: str) -> tuple[str, int | None, str | None]:
    """(host, pid, process token) of a claim directory's name, parsed from
    the right (a host name may hold ``-``); the JAX package's
    ``<host>-<pid>`` layout gives a None token, an unparseable pid None."""
    parts = name.rsplit("-", 3)
    if (len(parts) == 4 and parts[0] == host and parts[1].isdigit()
            and _TOKEN.fullmatch(parts[2]) and _TOKEN.fullmatch(parts[3])):
        return parts[0], int(parts[1]), parts[2]
    owner_host, _, pid = name.rpartition("-")
    return owner_host, int(pid) if pid.isdigit() else None, None


def _owner_is_dead(name: str, host: str) -> bool:
    """Whether the server that owns claim directory ``name`` is gone."""
    owner_host, pid, token = _owner(name, host)
    if owner_host != host:
        return False  # cannot check a foreign host's liveness
    if pid is None:
        return True  # unparseable owner: recover
    if pid == os.getpid():
        # A live sibling in this process carries our token; anything else
        # with our pid is a dead predecessor's (a recycled pid).
        return token != PROCESS_TOKEN
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, OverflowError):
        return True  # no such process (or a pid past the C int)
    except PermissionError:
        return False  # alive under another uid
    return False


def _recover(watch_dir: Path, inflight_dir: Path, claim_dir: Path) -> None:
    """Re-queue the claims of dead servers (the startup recovery). Every
    rename tolerates FileNotFoundError: two servers started together race to
    recover the same orphans, and the loser finding the file gone is the
    success case."""

    def _requeue(orphan: Path, what: str) -> None:
        try:
            orphan.rename(watch_dir / orphan.name)
        except FileNotFoundError:
            return  # a sibling server recovered it first
        logger.warning("Re-queueing %s %s", what, orphan.name)

    for orphan in inflight_dir.glob("*.json"):
        _requeue(orphan, "orphaned inflight request")
    host = socket.gethostname()
    for owner_dir in (d for d in inflight_dir.iterdir() if d.is_dir()):
        if owner_dir == claim_dir or not _owner_is_dead(owner_dir.name, host):
            continue
        for orphan in owner_dir.glob("*.json"):
            _requeue(orphan, f"inflight request (dead server {owner_dir.name})")
        try:
            owner_dir.rmdir()
        except OSError:
            pass  # non-empty (non-json debris) or concurrently recovered


def serve_directory(
    pipeline: StudyInferencePipeline,
    watch_dir: Path,
    output_dir: Path,
    poll_interval: float = 0.5,
    max_batch: int = 16,
    once: bool = False,
    stop_event: Any = None,
) -> ServeStats:
    """Drain ``watch_dir/*.json`` requests through the pipeline.

    Args:
        pipeline: A constructed :class:`StudyInferencePipeline`; the
            requests' series decode on its device.
        watch_dir: Directory receiving request JSON files.
        output_dir: Directory receiving ``<study_id>.json`` results.
        poll_interval: Sleep between empty polls (seconds).
        max_batch: Maximum studies per pipeline call.
        once: Drain the current backlog, then return.
        stop_event: Optional ``threading.Event``-like; set to stop the loop.

    Returns:
        ServeStats with processed/failed counts.
    """
    watch_dir = Path(watch_dir)
    output_dir = Path(output_dir)
    done_dir = watch_dir / "done"
    failed_dir = watch_dir / "failed"
    inflight_dir = watch_dir / "inflight"
    for d in (watch_dir, output_dir, done_dir, failed_dir, inflight_dir):
        d.mkdir(parents=True, exist_ok=True)

    claim_dir = inflight_dir / (
        f"{socket.gethostname()}-{os.getpid()}-{PROCESS_TOKEN}-{secrets.token_hex(6)}")
    claim_dir.mkdir()
    _recover(watch_dir, inflight_dir, claim_dir)

    stats = ServeStats()
    try:
        return _serve_loop(
            pipeline, watch_dir, output_dir, done_dir, failed_dir, claim_dir,
            poll_interval, max_batch, once, stop_event, stats,
        )
    finally:
        try:
            claim_dir.rmdir()  # leave no empty owner directory behind
        except OSError:
            pass


def _serve_loop(
    pipeline: StudyInferencePipeline,
    watch_dir: Path,
    output_dir: Path,
    done_dir: Path,
    failed_dir: Path,
    claim_dir: Path,
    poll_interval: float,
    max_batch: int,
    once: bool,
    stop_event: Any,
    stats: ServeStats,
) -> ServeStats:
    device = pipeline.device
    with ThreadPoolExecutor(max_workers=1) as pool:
        def claim():
            return _claim_and_load(watch_dir, claim_dir, max_batch, device)

        pending = pool.submit(claim)
        while True:
            batch = pending.result()
            if not batch:
                if once or (stop_event is not None and stop_event.is_set()):
                    return stats
                time.sleep(poll_interval)
                pending = pool.submit(claim)
                continue

            # Prefetch the next batch while the card runs this one.
            pending = pool.submit(claim)

            for path, err in batch.failures:
                stats.failed += 1
                (failed_dir / f"{path.stem}.error.txt").write_text(err)
                shutil.move(str(path), failed_dir / path.name)
                logger.warning("Rejected request %s: %s", path.name, err)

            if batch.studies:
                start = time.perf_counter()
                # The payload carries coords and grades only: the crops, the
                # largest output, stay on the card.
                results = pipeline.run(batch.studies, fetch_crops=False)
                elapsed = time.perf_counter() - start
                stats.batches += 1
                for path, result in zip(batch.paths, results):
                    out_path = output_dir / f"{result.study_id}.json"
                    out_path.write_text(json.dumps(_result_payload(result), indent=2))
                    shutil.move(str(path), done_dir / path.name)
                    stats.processed += 1
                    stats.study_ids.append(result.study_id)
                logger.info(
                    "Served batch of %d studies in %.1f ms (%.1f ms/study)",
                    len(batch.studies), elapsed * 1000.0,
                    elapsed * 1000.0 / len(batch.studies),
                )

            if stop_event is not None and stop_event.is_set():
                # Clean shutdown: return the prefetched claim to the queue.
                leftover = pending.result()
                for path in leftover.paths + [p for p, _ in leftover.failures]:
                    path.rename(watch_dir / path.name)
                return stats
