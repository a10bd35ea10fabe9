"""Host input pipeline: seeded shuffling, weighted sampling, threaded prefetch.

Counterpart of ``spine_vision_tpu/data/loader.py``:

- epoch ``e`` draws its index stream from ``np.random.RandomState(seed + e)``:
  with ``sample_weights``, ``n`` indices drawn with replacement in
  proportion to the weights (``rng.choice``), else a permutation when
  shuffling; so the port and the JAX package visit the same samples in the
  same order;
- ``drop_last`` defaults to ``shuffle``;
- a thread pool loads a batch's samples concurrently and batches are
  prefetched a queue-depth ahead; a dataset with ``get_batch`` (the packed
  sample cache, ``data/cache.py``) assembles a whole batch in one gather
  per field instead, where the collate function is ``default_collate``;
- batches are dicts of stacked numpy arrays; non-array entries (metadata)
  are collected into lists;
- in a multi-process run (``process_count`` ranks, by default the process
  group's) every rank draws the same global index stream and takes the same
  contiguous, equal slice of every global batch. A trailing partial batch is
  first padded to a ``process_count`` multiple by repeating its last index;
  such a batch carries ``_n_valid_global`` (its real global size, the same on
  every rank) and, on a rank holding repeated rows, ``_n_valid`` (its real
  local rows). ``len`` is the same on every rank.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Protocol, Sequence

import numpy as np

from spine_vision_torch.core.tasks import get_task
from spine_vision_torch.parallel import mesh


class MapDataset(Protocol):
    """Indexable dataset protocol."""

    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> dict[str, Any]: ...


def _stack_or_list(values: list[Any]) -> Any:
    first = values[0]
    if isinstance(first, np.ndarray):
        return np.stack(values)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(values)
    return values


def default_collate(samples: Sequence[dict[str, Any]]) -> dict[str, Any]:
    """Stack array-like fields; collect metadata and other non-arrays as lists."""
    batch: dict[str, Any] = {}
    for key in samples[0]:
        values = [s[key] for s in samples]
        if isinstance(values[0], dict):
            batch[key] = {k: _stack_or_list([v[k] for v in values]) for k in values[0]}
        else:
            batch[key] = _stack_or_list(values)
    return batch


def collate_localization(samples: Sequence[dict[str, Any]]) -> dict[str, Any]:
    """Batch localization samples (``image`` uint8 ``[H, W, 3]``, ``coords``
    ``[L, 2]``, ``mask`` ``[L]``, ``series_type_idx``, ``metadata``)."""
    return {
        "image": np.stack([s["image"] for s in samples]),
        "coords": np.stack([s["coords"] for s in samples]),
        "mask": np.stack([s["mask"] for s in samples]),
        "series_type_idx": np.asarray([s["series_type_idx"] for s in samples], np.int32),
        "metadata": [s["metadata"] for s in samples],
    }


def collate_classification(samples: Sequence[dict[str, Any]]) -> dict[str, Any]:
    """Batch classification samples (``image`` uint8 ``[H, W, 3]``,
    ``targets`` ``{task: label}``, ``level_idx``, ``metadata``): multiclass
    targets as int32, the others as float32."""
    targets = {
        label: np.asarray([s["targets"][label] for s in samples],
                          dtype=np.int32 if get_task(label).is_multiclass else np.float32)
        for label in samples[0]["targets"]
    }
    return {
        "image": np.stack([s["image"] for s in samples]),
        "targets": targets,
        "level_idx": np.asarray([s["level_idx"] for s in samples], np.int32),
        "metadata": [s["metadata"] for s in samples],
    }


def compute_inverse_frequency_weights(labels: Sequence[Any]) -> np.ndarray:
    """Per-sample weights ``1 / count of the sample's class``."""
    _, inverse, counts = np.unique(np.asarray(labels), return_inverse=True, return_counts=True)
    return (1.0 / counts)[inverse].astype(np.float64)


class DataLoader:
    """Seeded, prefetching batch loader; ``batch_size`` is the global batch,
    of which this process loads its ``batch_size / process_count`` slice."""

    def __init__(
        self,
        dataset: MapDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool | None = None,
        seed: int = 42,
        sample_weights: np.ndarray | None = None,
        collate_fn: Callable[[Sequence[dict[str, Any]]], dict[str, Any]] | None = None,
        num_workers: int = 8,
        prefetch: int = 2,
        process_index: int | None = None,
        process_count: int | None = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = seed
        self.sample_weights = sample_weights
        self.collate_fn = collate_fn or default_collate
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0
        self.process_index = mesh.rank() if process_index is None else process_index
        self.process_count = mesh.world_size() if process_count is None else process_count
        if self.batch_size % self.process_count != 0:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"process_count={self.process_count}")

    def set_epoch(self, epoch: int) -> None:
        """Set the epoch for deterministic reshuffling."""
        self.epoch = epoch

    def epoch_indices(self) -> np.ndarray:
        """This epoch's index stream (``shuffle`` does not apply with
        ``sample_weights``)."""
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.sample_weights is not None:
            probs = self.sample_weights / self.sample_weights.sum()
            return rng.choice(n, size=n, replace=True, p=probs)
        if self.shuffle:
            return rng.permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _process_slice(self, batch: np.ndarray) -> tuple[np.ndarray, int]:
        """This rank's contiguous equal share of a global batch (padded by
        repeating its last index) and its count of real rows."""
        n = len(batch)
        pad = (-n) % self.process_count
        if pad:
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad)])
        share = len(batch) // self.process_count
        start = self.process_index * share
        return batch[start: start + share], int(np.clip(n - start, 0, share))

    def __iter__(self) -> Iterator[dict[str, Any]]:
        n_batches = len(self)
        if n_batches == 0:
            return
        indices = self.epoch_indices()
        batch_indices = [
            indices[i * self.batch_size: (i + 1) * self.batch_size] for i in range(n_batches)
        ]
        n_global = [len(b) for b in batch_indices]
        n_real = list(n_global)
        if self.process_count > 1:
            sliced = [self._process_slice(b) for b in batch_indices]
            batch_indices = [b for b, _ in sliced]
            n_real = [v for _, v in sliced]
        out_queue: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # get_batch builds default_collate's structure; a custom collate_fn
        # expects per-sample dicts.
        fast_batch = (getattr(self.dataset, "get_batch", None)
                      if self.collate_fn is default_collate else None)

        def producer() -> None:
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for bidx, valid, global_valid in zip(batch_indices, n_real, n_global):
                        if stop.is_set():
                            return
                        batch = fast_batch(bidx) if fast_batch else None
                        if batch is None:  # get_batch returns None for deep layouts
                            batch = self.collate_fn(list(pool.map(self.dataset.__getitem__,
                                                                  bidx)))
                        if global_valid % self.process_count:  # a padded global batch
                            batch["_n_valid_global"] = global_valid
                            if valid < len(bidx):
                                batch["_n_valid"] = valid
                        out_queue.put(batch)
                out_queue.put(None)
            except BaseException as exc:  # handed to the consumer, which raises it
                out_queue.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit, then wait for it.
            while thread.is_alive():
                try:
                    out_queue.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
