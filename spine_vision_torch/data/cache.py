"""Decode-once packed sample cache for the host input pipeline.

Counterpart of ``spine_vision_tpu/data/cache.py``, with the same on-disk
format, so a cache that either package built is reused by the other.

The host cost of training from a data directory is each sample's PNG decode
and resize in ``Dataset.__getitem__`` (``data/png.py``), every epoch. The
samples are deterministic (augmentation runs on the device,
``ops/augment.py``), so they are decoded once into a packed, memory-mapped
column store and later epochs read them back from the page cache.

Layout (one directory per cache):
    index.json          {n, fields: {path: {shape, dtype}}, fingerprint}
    <field>.npy         [N, *shape] memmap per array field ('/' in nested
                        paths is encoded as '__' in filenames)
    metadata.json       list of the non-array remainder of each sample

Consistency: a rebuild writes fresh ``*.tmp`` files and ``os.replace``s them
over the old ones (index.json last), so a reader that mapped the previous
generation keeps valid data and none sees a half-written cache. An advisory
``flock`` on ``.lock`` serialises check, build and open across processes
sharing the directory. A cache is stale when its fingerprint differs: the
sample count, every field's shape and dtype, a caller token, and content
hashes of the first, the last and six seeded interior samples (their arrays
and their metadata as JSON with sorted keys). Pass another
``fingerprint_token`` (or delete the directory) to force a rebuild.

Type normalisations against the uncached dataset: scalar int, float and
bool fields come back as 0-d numpy arrays, and the non-array remainder is
JSON-normalised at build time (tuples become lists). The collate functions
take both.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterator

import numpy as np

logger = logging.getLogger("spine_vision_torch")

_INDEX = "index.json"
_META = "metadata.json"
_LOCK = ".lock"


def _flatten_arrays(
    sample: dict[str, Any], prefix: str = ""
) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    """Split a sample dict into (flat array fields, non-array remainder)."""
    arrays: dict[str, np.ndarray] = {}
    rest: dict[str, Any] = {}
    for key, value in sample.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            sub_arrays, sub_rest = _flatten_arrays(value, path)
            arrays.update(sub_arrays)
            if sub_rest:
                rest[key] = sub_rest
        elif isinstance(value, (np.ndarray, np.generic, int, float, bool)):
            arrays[path] = np.asarray(value)
        else:
            rest[key] = value
    return arrays, rest


def _unflatten(flat: dict[str, Any]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _merge_into(dst: dict[str, Any], src: dict[str, Any]) -> None:
    """Deep-merge ``src`` into ``dst`` (array members of mixed subtrees must
    survive the metadata merge — overwriting the whole subtree would drop
    them)."""
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _merge_into(dst[key], value)
        else:
            dst[key] = value


def _field_file(cache_dir: Path, field: str) -> Path:
    return cache_dir / (field.replace("/", "__") + ".npy")


def _specs(sample: dict[str, Any]) -> dict[str, dict]:
    """field -> {shape, dtype} from one sample (the cache schema)."""
    arrays, _ = _flatten_arrays(sample)
    return {
        field: {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        for field, arr in arrays.items()
    }


def _content_hash(sample: dict[str, Any]) -> str:
    """Order-independent digest of one sample's arrays + metadata."""
    arrays, rest = _flatten_arrays(sample)
    digest = hashlib.sha256()
    for field in sorted(arrays):
        digest.update(field.encode())
        digest.update(np.ascontiguousarray(arrays[field]).tobytes())
    digest.update(json.dumps(rest, sort_keys=True, default=str).encode())
    return digest.hexdigest()[:16]


def _fingerprint(
    dataset: Any, first: dict[str, Any], specs: dict[str, dict], token: str
) -> str:
    n = len(dataset)
    parts = [str(n), token]
    for field in sorted(specs):
        spec = specs[field]
        parts.append(f"{field}:{spec['dtype']}:{tuple(spec['shape'])}")
    # Content probes: first, last, and a small deterministic interior
    # sample (seeded by n, so the same dataset always probes the same
    # rows). Catches in-place label edits / regenerated images that keep
    # count and shapes — including interior-only edits the first/last
    # probe missed. ``first`` is passed in so the caller's already-decoded
    # sample 0 isn't decoded twice.
    parts.append(_content_hash(first))
    if n > 1:
        parts.append(_content_hash(dataset[n - 1]))
    if n > 2:
        rng = np.random.default_rng(n)
        interior = rng.choice(n - 2, size=min(6, n - 2), replace=False) + 1
        for idx in sorted(int(i) for i in interior):
            parts.append(f"{idx}:{_content_hash(dataset[idx])}")
    return "|".join(parts)


@contextmanager
def _dir_lock(cache_dir: Path) -> Iterator[None]:
    """Advisory exclusive lock serializing check/build/open across
    processes sharing the cache directory."""
    cache_dir.mkdir(parents=True, exist_ok=True)
    lock_path = cache_dir / _LOCK
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
    try:
        try:
            import fcntl

            fcntl.flock(fd, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX: proceed unlocked
            pass
        yield
    finally:
        os.close(fd)


class PackedDataset:
    """MapDataset over a built cache directory (mmap-backed, zero decode).

    ``source`` (optional) is the dataset the cache was built from; attribute
    lookups that the packed view doesn't own (``get_stats``,
    ``compute_class_weights``, trainer hooks' introspection, ...) delegate to
    it, so a PackedDataset is a drop-in wherever the source dataset goes.
    """

    def __init__(self, cache_dir: Path, source: Any | None = None) -> None:
        self.source = source
        self.cache_dir = Path(cache_dir)
        with open(self.cache_dir / _INDEX) as f:
            self.index = json.load(f)
        self.n = int(self.index["n"])
        self.fields = {
            field: np.load(_field_file(self.cache_dir, field), mmap_mode="r")
            for field in self.index["fields"]
        }
        with open(self.cache_dir / _META) as f:
            self.metadata = json.load(f)
        # get_batch can mirror default_collate only while arrays sit at most
        # one dict level deep (collate stacks exactly that far; deeper dicts
        # collate as lists-of-dicts, which a field-wise gather can't produce).
        self._batchable = all(f.count("/") <= 1 for f in self.fields)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> dict[str, Any]:
        flat: dict[str, Any] = {
            # Copy the row out of the memmap: downstream stacking would do
            # the same read anyway, and a materialized array never dangles
            # if the cache object is dropped.
            field: np.array(arr[idx])
            for field, arr in self.fields.items()
        }
        sample = _unflatten(flat)
        # Deep-merge a COPY of the stored remainder: consumers may mutate
        # their sample dict, and the stored metadata must stay pristine
        # across epochs.
        _merge_into(sample, copy.deepcopy(self.metadata[idx]))
        return sample

    def get_batch(self, indices: Any) -> dict[str, Any] | None:
        """Vectorized batch assembly: one fancy-index gather per field.

        Returns the exact structure ``default_collate([self[i] for i in
        indices])`` would build (arrays stacked along a new leading axis,
        metadata values as per-sample lists), or ``None`` when the field
        layout cannot mirror collate (arrays nested deeper than one dict
        level) so the caller falls back to per-sample loading.

        Why: the per-sample path pays B Python ``__getitem__`` calls plus a
        ``np.stack`` copy per batch, all serialised by the interpreter lock;
        a per-field ``arr[indices]`` is one C-level gather from the page
        cache.
        """
        if not self._batchable:
            return None
        idx = np.asarray(indices, dtype=np.int64)
        batch: dict[str, Any] = {}
        for field, arr in self.fields.items():
            value = np.asarray(arr[idx])
            head, _, sub = field.partition("/")
            if sub:
                batch.setdefault(head, {})[sub] = value
            else:
                batch[head] = value
        rows = [self.metadata[int(i)] for i in idx]
        if rows and rows[0]:
            # Mirror collate's one-level descent; deepcopy keeps the stored
            # metadata pristine when consumers mutate their batch (the same
            # contract __getitem__ honors).
            for key, first in rows[0].items():
                if isinstance(first, dict):
                    dst = batch.setdefault(key, {})
                    for sub in first:
                        dst[sub] = [copy.deepcopy(r[key][sub]) for r in rows]
                else:
                    batch[key] = [copy.deepcopy(r[key]) for r in rows]
        return batch

    def __getattr__(self, name: str) -> Any:
        # Only called when normal lookup fails: delegate to the source
        # dataset so trainer hooks (get_stats, compute_class_weights, ...)
        # keep working through the packed view.
        source = self.__dict__.get("source")
        if source is not None:
            return getattr(source, name)
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}' "
            "(no source dataset attached)"
        )


def build_packed_cache(
    dataset: Any,
    cache_dir: Path,
    num_workers: int = 8,
    fingerprint_token: str = "",
) -> Path:
    """Materialize ``dataset`` into ``cache_dir``.

    Every sample's array fields must match sample 0's field set and
    shapes/dtypes (true for this package's datasets: fixed output_size,
    fixed targets). Writes go to ``*.tmp`` files that are atomically
    swapped in (index.json last), so concurrent readers of the previous
    generation are never corrupted.
    """
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    n = len(dataset)
    if n == 0:
        raise ValueError("Cannot cache an empty dataset")
    first = dataset[0]
    specs = _specs(first)

    filenames = {field: _field_file(cache_dir, field) for field in specs}
    if len(set(filenames.values())) != len(filenames):
        raise ValueError(
            "Field names collide after '/'->'__' filename encoding: "
            f"{sorted(specs)}"
        )

    tmp_suffix = f".tmp{os.getpid()}"
    mms = {
        field: np.lib.format.open_memmap(
            str(filenames[field]) + tmp_suffix,
            mode="w+",
            dtype=np.dtype(spec["dtype"]),
            shape=(n, *spec["shape"]),
        )
        for field, spec in specs.items()
    }
    metadata: list[dict[str, Any] | None] = [None] * n

    def write_row(idx: int) -> None:
        arrays, rest = _flatten_arrays(dataset[idx])
        extra = sorted(set(arrays) - set(mms))
        missing = sorted(set(mms) - set(arrays))
        if extra or missing:
            raise ValueError(
                f"Sample {idx} array fields differ from sample 0's: "
                f"extra={extra} missing={missing}"
            )
        for field, mm in mms.items():
            value = arrays[field]
            if value.shape != mm.shape[1:] or value.dtype != mm.dtype:
                raise ValueError(
                    f"Sample {idx} field '{field}' is "
                    f"{value.dtype}{value.shape}, cache expects "
                    f"{mm.dtype}{mm.shape[1:]}"
                )
            mm[idx] = value
        try:
            # Normalize + validate NOW: a non-JSON-serializable remainder
            # should name the sample, not fail after the full build.
            metadata[idx] = json.loads(json.dumps(rest))
        except TypeError as exc:
            raise ValueError(
                f"Sample {idx} metadata is not JSON-serializable: {exc}"
            ) from exc

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        # list() propagates the first worker exception.
        list(pool.map(write_row, range(n)))
    for mm in mms.values():
        mm.flush()

    meta_tmp = cache_dir / (_META + tmp_suffix)
    with open(meta_tmp, "w") as f:
        json.dump(metadata, f)
    index = {
        "n": n,
        "fields": specs,
        "fingerprint": _fingerprint(dataset, first, specs, fingerprint_token),
    }
    index_tmp = cache_dir / (_INDEX + tmp_suffix)
    with open(index_tmp, "w") as f:
        json.dump(index, f, indent=1)

    # Atomic swap: data files first, index last — a reader (under the dir
    # lock) either sees the complete new generation or the complete old one.
    for field in specs:
        os.replace(str(filenames[field]) + tmp_suffix, filenames[field])
    os.replace(meta_tmp, cache_dir / _META)
    os.replace(index_tmp, cache_dir / _INDEX)
    logger.info(
        "Packed %d samples (%d fields) into %s", n, len(specs), cache_dir
    )
    return cache_dir


def packed_view(
    dataset: Any,
    cache_dir: Path,
    num_workers: int = 8,
    fingerprint_token: str = "",
) -> PackedDataset:
    """Return a PackedDataset for ``dataset``, building the cache if the
    directory is missing or its fingerprint (sample count + field specs +
    first/last sample content + caller token) no longer matches."""
    cache_dir = Path(cache_dir)
    index_path = cache_dir / _INDEX
    # Dataset probing happens OUTSIDE the corrupt-cache guard: an error
    # here (missing image, bad annotations) is the dataset's, not the
    # cache's, and must surface as such.
    first = dataset[0]
    want = _fingerprint(dataset, first, _specs(first), fingerprint_token)
    with _dir_lock(cache_dir):
        if index_path.exists():
            try:
                with open(index_path) as f:
                    index = json.load(f)
                stored = index.get("fingerprint")
            except (OSError, ValueError) as exc:  # corrupt cache -> rebuild
                stored = None
                logger.warning(
                    "Packed cache %s unreadable (%s); rebuilding", cache_dir, exc
                )
            if stored == want:
                logger.info("Reusing packed sample cache: %s", cache_dir)
                return PackedDataset(cache_dir, source=dataset)
            if stored is not None:
                logger.info(
                    "Packed cache %s is stale (fingerprint mismatch); rebuilding",
                    cache_dir,
                )
        build_packed_cache(
            dataset, cache_dir, num_workers=num_workers,
            fingerprint_token=fingerprint_token,
        )
        return PackedDataset(cache_dir, source=dataset)
