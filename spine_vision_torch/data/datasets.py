"""Training datasets: localization (coordinates) and classification (crops).

Counterpart of ``spine_vision_tpu/data/datasets.py``. The annotations come
from ``annotations.csv`` (the standard ``csv`` module); the images come from
an *image store*: a mapping from the CSV's ``image_path`` to the decoded
uint8 array (RGB ``[H, W, 3]`` for localization, a gray ``[H, W]`` plane for
classification). The default store, :class:`PngStore`, decodes the PNG and
JPEG images (baseline or progressive) of the data directory on each access
(``data/png.py``, ``io/jpeg.py``: the reads of ``cv2.imread``); an in-memory
mapping stands in for it where a caller holds the arrays already. Everything after the read is the JAX code's: the host
bilinear resize, the grouping and T1/T2 pairing, the ``[T2, T1, T2]``
channels, the targets and the splits:

- localization: a seeded permutation by unique image;
- classification: a patient-level stratified split
  (``data/stratification.py``).

Samples are the dicts ``data/loader.py``'s ``collate_localization`` and
``collate_classification`` take.
"""

from __future__ import annotations

import csv
import logging
from collections import Counter, defaultdict
from pathlib import Path
from typing import Any, Iterator, Literal, Mapping

import numpy as np

from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES
from spine_vision_torch.data.png import decode_png
from spine_vision_torch.data.levels import (
    IDX_TO_LEVEL,
    LEVEL_TO_IDX,
    NUM_LEVELS,
    SERIES_TYPE_TO_IDX,
)
from spine_vision_torch.data.stratification import _LABEL_TO_RECORD_KEY, split_patients
from spine_vision_torch.io import jpeg
from spine_vision_torch.native import resize_bilinear_u8

logger = logging.getLogger("spine_vision_torch")

ImageStore = Mapping[str, np.ndarray]

LABEL_TO_RECORD_KEY = _LABEL_TO_RECORD_KEY


def read_image(path: Path, mode: Literal["color", "gray"]) -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR)`` as RGB (``mode="color"``) or
    ``cv2.imread(path, IMREAD_GRAYSCALE)`` of a PNG or baseline JPEG file,
    told apart by content as cv2 does: PNG by ``data/png.py``, JPEG by
    ``io/jpeg.py`` (libjpeg's RGB, or its grayscale output: the Y plane).
    cv2's EXIF rotation is not applied. Other JPEG processes raise
    ``NotImplementedError`` naming ROADMAP Queue 1 item 13, other formats
    ``ValueError``."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except (FileNotFoundError, IsADirectoryError):
        raise FileNotFoundError(f"Could not read image: {path}") from None
    if not jpeg.is_jpeg(data):
        return decode_png(data, mode, name=str(path))
    if mode == "gray":
        return jpeg.decode_jpeg(data, luma=True)
    return jpeg.to_mode(jpeg.decode_jpeg(data), "RGB")


class PngStore(Mapping[str, np.ndarray]):
    """The images of a data directory: ``annotations.csv``'s ``image_path``
    -> the image at ``data_path / image_path`` (PNG or JPEG,
    :func:`read_image`), decoded on each access as ``cv2.imread`` reads it
    in ``mode`` ``"color"`` (RGB ``[H, W, 3]``) or ``"gray"`` (``[H, W]``).
    A file that is missing or cannot be decoded raises."""

    def __init__(self, data_path: Path, mode: Literal["color", "gray"]) -> None:
        self.data_path = Path(data_path)
        self.mode = mode
        with open(self.data_path / "annotations.csv", newline="") as f:
            self._keys = dict.fromkeys(row["image_path"] for row in csv.DictReader(f))

    def __getitem__(self, key: str) -> np.ndarray:
        if key not in self._keys:
            raise KeyError(key)
        return read_image(self.data_path / key, self.mode)

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def _resize_rgb(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize HWC uint8 (channels as the batch)."""
    if img.shape[:2] == (h, w):
        return img
    planes = np.ascontiguousarray(img.transpose(2, 0, 1))
    return resize_bilinear_u8(planes, h, w).transpose(1, 2, 0)


def _resize_gray(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize an HW uint8 plane."""
    if img.shape == (h, w):
        return img
    return resize_bilinear_u8(np.ascontiguousarray(img[None]), h, w)[0]


def _read(store: ImageStore, key: str) -> np.ndarray:
    try:
        return np.asarray(store[key], dtype=np.uint8)
    except KeyError:
        raise FileNotFoundError(f"Could not read image: {key} (not in the image store)") from None


class LocalizationDataset:
    """Coordinate localization dataset: one sample = image + ``[5, 2]`` coords.

    Annotations CSV columns:
        image_path, level, relative_x, relative_y, series_type, source

    Sample dict:
        image: uint8 ``[H, W, 3]``
        coords: float32 ``[5, 2]``; mask: float32 ``[5]`` (1 = valid)
        series_type_idx: int
        metadata: {image_path, source, series_type}
    """

    def __init__(
        self,
        data_path: Path,
        split: Literal["train", "val", "test", "all"] = "all",
        val_ratio: float = 0.15,
        test_ratio: float = 0.05,
        series_types: list[str] | None = None,
        sources: list[str] | None = None,
        image_size: tuple[int, int] = (512, 512),
        augment: bool = True,
        seed: int = 42,
        image_store: ImageStore | None = None,
    ) -> None:
        self.data_path = Path(data_path)
        self.split = split
        self.image_size = image_size
        self.augment = augment and split == "train"

        annotations_path = self.data_path / "annotations.csv"
        if not annotations_path.exists():
            raise FileNotFoundError(f"Annotations not found: {annotations_path}")
        self.image_store = PngStore(self.data_path, "color") if image_store is None else image_store

        raw_records = self._load_annotations(annotations_path)
        # A filter naming nothing the data holds would empty the dataset.
        for key, wanted in (("series_type", series_types), ("source", sources)):
            if wanted:
                present = {r[key] for r in raw_records}
                unknown = set(wanted) - present
                if unknown:
                    raise ValueError(
                        f"{key}s {sorted(unknown)} not present in {annotations_path} "
                        f"(has {sorted(present)})"
                    )
                raw_records = [r for r in raw_records if r[key] in wanted]

        self.image_records = self._group_by_image(raw_records)

        unique_images = list(self.image_records.keys())
        train_set, val_set, test_set = self._split_images(
            unique_images, val_ratio, test_ratio, seed
        )
        keep = {"train": train_set, "val": val_set, "test": test_set}.get(split)
        self.image_list = (
            unique_images if keep is None else [i for i in unique_images if i in keep]
        )

    @staticmethod
    def _load_annotations(path: Path) -> list[dict[str, Any]]:
        with open(path, newline="") as f:
            return [
                {
                    "image_path": row["image_path"],
                    "level": row["level"],
                    "relative_x": float(row["relative_x"]),
                    "relative_y": float(row["relative_y"]),
                    "series_type": row["series_type"],
                    "source": row["source"],
                }
                for row in csv.DictReader(f)
            ]

    @staticmethod
    def _group_by_image(records: list[dict[str, Any]]) -> dict[str, dict[str, Any]]:
        grouped: dict[str, dict[str, Any]] = defaultdict(
            lambda: {"coords": {}, "series_type": "", "source": ""}
        )
        for record in records:
            level_idx = LEVEL_TO_IDX.get(record["level"])
            if level_idx is None:
                continue
            entry = grouped[record["image_path"]]
            entry["coords"][level_idx] = (record["relative_x"], record["relative_y"])
            entry["series_type"] = record["series_type"]
            entry["source"] = record["source"]
        return dict(grouped)

    @staticmethod
    def _split_images(
        images: list[str], val_ratio: float, test_ratio: float, seed: int
    ) -> tuple[set[str], set[str], set[str]]:
        indices = np.random.RandomState(seed).permutation(len(images))
        n_test = int(len(images) * test_ratio)
        n_val = int(len(images) * val_ratio)
        return (
            {images[i] for i in indices[n_test + n_val:]},
            {images[i] for i in indices[n_test: n_test + n_val]},
            {images[i] for i in indices[:n_test]},
        )

    def __len__(self) -> int:
        return len(self.image_list)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        image_path = self.image_list[idx]
        record = self.image_records[image_path]
        image = _resize_rgb(_read(self.image_store, image_path), *self.image_size)

        coords = np.zeros((NUM_LEVELS, 2), dtype=np.float32)
        mask = np.zeros((NUM_LEVELS,), dtype=np.float32)
        for level_idx, (x, y) in record["coords"].items():
            coords[level_idx] = (x, y)
            mask[level_idx] = 1.0

        return {
            "image": image,
            "coords": coords,
            "mask": mask,
            "series_type_idx": SERIES_TYPE_TO_IDX.get(record["series_type"], 0),
            "metadata": {
                "image_path": image_path,
                "source": record["source"],
                "series_type": record["series_type"],
            },
        }

    def get_stats(self) -> dict[str, Any]:
        """Dataset statistics."""
        series_types: list[str] = []
        sources: list[str] = []
        level_counts: dict[int, int] = defaultdict(int)
        total = 0
        for image_path in self.image_list:
            record = self.image_records[image_path]
            series_types.append(record["series_type"])
            sources.append(record["source"])
            for level_idx in record["coords"]:
                level_counts[level_idx] += 1
                total += 1
        return {
            "num_images": len(self.image_list),
            "num_annotations": total,
            "levels": {IDX_TO_LEVEL[i]: c for i, c in sorted(level_counts.items())},
            "series_types": dict(Counter(series_types)),
            "sources": dict(Counter(sources)),
            "split": self.split,
        }


def construct_3channel(t2_crop: np.ndarray | None, t1_crop: np.ndarray | None) -> np.ndarray:
    """``[T2, T1, T2]`` channel stacking (one series alone fills all three)."""
    if t2_crop is not None and t1_crop is not None:
        return np.stack([t2_crop, t1_crop, t2_crop], axis=-1)
    if t2_crop is not None:
        return np.stack([t2_crop, t2_crop, t2_crop], axis=-1)
    if t1_crop is not None:
        return np.stack([t1_crop, t1_crop, t1_crop], axis=-1)
    raise ValueError("At least one of t2_crop or t1_crop must be provided")


class ClassificationDataset:
    """Multi-task IVD crop dataset with T1/T2 pairing.

    Annotations CSV columns:
        image_path, patient_id, ivd_level, series_type, source,
        pfirrmann_grade, disc_herniation, disc_narrowing, disc_bulging,
        spondylolisthesis, modic, up_endplate, low_endplate

    A record's ``t1_path`` and ``t2_path`` are the CSV's ``image_path``, the
    store's keys.

    Sample dict:
        image: uint8 ``[H, W, 3]`` (``[T2, T1, T2]`` channels)
        targets: {task: scalar or [1] float}
        level_idx: int
        metadata: {source, patient_id, level, ivd}
    """

    def __init__(
        self,
        data_path: Path,
        split: Literal["train", "val", "test", "all"] = "all",
        val_ratio: float = 0.10,
        test_ratio: float = 0.10,
        levels: list[str] | None = None,
        series_types: list[str] | None = None,
        target_labels: list[str] | None = None,
        output_size: tuple[int, int] = (256, 256),
        augment: bool = True,
        seed: int = 42,
        image_store: ImageStore | None = None,
    ) -> None:
        self.data_path = Path(data_path)
        self.split = split
        self.output_size = output_size
        self.augment = augment and split == "train"

        valid_series = {"sag_t1", "sag_t2"}
        if series_types is not None:
            invalid = set(series_types) - valid_series
            if invalid:
                raise ValueError(f"Invalid series types: {invalid}. Valid: {valid_series}")
            self.series_types = set(series_types)
        else:
            self.series_types = valid_series

        if target_labels is not None:
            if not target_labels:
                raise ValueError("target_labels must not be empty")
            invalid = set(target_labels) - set(AVAILABLE_TASK_NAMES)
            if invalid:
                raise ValueError(
                    f"Invalid target labels: {invalid}. Available: {AVAILABLE_TASK_NAMES}"
                )
            self.target_labels = list(target_labels)
        else:
            self.target_labels = list(AVAILABLE_TASK_NAMES)

        self.records = self._load_and_pair_annotations()
        self.image_store = PngStore(self.data_path, "gray") if image_store is None else image_store

        if levels:
            valid_levels = set(IDX_TO_LEVEL.values())
            invalid = set(levels) - valid_levels
            if invalid:
                raise ValueError(f"Invalid levels: {invalid}. Valid: {sorted(valid_levels)}")
            level_set = set(levels)
            self.records = [
                r for r in self.records if IDX_TO_LEVEL.get(r["level_idx"]) in level_set
            ]

        if split != "all":
            train_p, val_p, test_p = split_patients(
                self._get_unique_patients(), self.records, self.target_labels,
                val_ratio, test_ratio, seed,
            )
            keep = {"train": train_p, "val": val_p, "test": test_p}[split]
            self.records = [r for r in self.records if r["patient_key"] in keep]

    def _load_and_pair_annotations(self) -> list[dict[str, Any]]:
        csv_path = self.data_path / "annotations.csv"
        if not csv_path.exists():
            raise FileNotFoundError(f"Annotations not found: {csv_path}")

        groups: dict[tuple[str, str, int], dict[str, Any]] = {}
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                source = row["source"]
                patient_id = row["patient_id"]
                ivd_level = int(row["ivd_level"])
                key = (source, patient_id, ivd_level)
                pfirrmann = int(row["pfirrmann_grade"])
                modic = int(row["modic"])
                if not 1 <= pfirrmann <= 5 or not 0 <= modic <= 3:
                    raise ValueError(
                        f"Out-of-range label for {key}: pfirrmann_grade="
                        f"{pfirrmann} (1-5), modic={modic} (0-3)"
                    )
                labels = {
                    "pfirrmann": pfirrmann,
                    "modic": modic,
                    "herniation": int(row["disc_herniation"]),
                    "bulging": int(row["disc_bulging"]),
                    "upper_endplate": int(row["up_endplate"]),
                    "lower_endplate": int(row["low_endplate"]),
                    "spondylolisthesis": int(row["spondylolisthesis"]),
                    "narrowing": int(row["disc_narrowing"]),
                }
                if key not in groups:
                    groups[key] = {
                        "source": source,
                        "patient_id": patient_id,
                        "patient_key": f"{source}_{patient_id}",
                        "ivd_level": ivd_level,
                        "level_idx": ivd_level - 1,
                        **labels,
                        "t1_path": None,
                        "t2_path": None,
                    }
                else:
                    conflicts = {
                        k: (groups[key][k], v) for k, v in labels.items() if groups[key][k] != v
                    }
                    if conflicts:
                        # T1/T2 rows of one IVD that disagree: the first row wins.
                        logger.warning("Conflicting labels for %s: %s (keeping first)",
                                       key, conflicts)
                if row["series_type"] == "sag_t1":
                    groups[key]["t1_path"] = row["image_path"]
                elif row["series_type"] == "sag_t2":
                    groups[key]["t2_path"] = row["image_path"]

        require_t1 = "sag_t1" in self.series_types
        require_t2 = "sag_t2" in self.series_types
        records = []
        for group in groups.values():
            has_t1 = group["t1_path"] is not None
            has_t2 = group["t2_path"] is not None
            if require_t1 and require_t2:
                if has_t1 and has_t2:
                    records.append(group)
            elif (require_t1 and has_t1) or (require_t2 and has_t2):
                records.append(group)
        return records

    def _get_unique_patients(self) -> list[str]:
        # Sorted: split_patients is order-sensitive.
        return sorted({r["patient_key"] for r in self.records})

    def __len__(self) -> int:
        return len(self.records)

    def _plane(self, record: dict[str, Any], series: str) -> np.ndarray | None:
        key = record["t1_path" if series == "sag_t1" else "t2_path"]
        if key is None or series not in self.series_types:
            return None
        return _resize_gray(_read(self.image_store, key), *self.output_size)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        record = self.records[idx]
        # Only the requested series: a T2-only set gives [T2, T2, T2].
        rgb = construct_3channel(self._plane(record, "sag_t2"), self._plane(record, "sag_t1"))

        all_targets: dict[str, Any] = {
            "pfirrmann": np.int32(record["pfirrmann"] - 1),
            "modic": np.int32(record["modic"]),
            "herniation": np.asarray([record["herniation"]], np.float32),
            "bulging": np.asarray([record["bulging"]], np.float32),
            "upper_endplate": np.asarray([record["upper_endplate"]], np.float32),
            "lower_endplate": np.asarray([record["lower_endplate"]], np.float32),
            "spondy": np.asarray([record["spondylolisthesis"]], np.float32),
            "narrowing": np.asarray([record["narrowing"]], np.float32),
        }
        return {
            "image": rgb,
            "targets": {k: v for k, v in all_targets.items() if k in self.target_labels},
            "level_idx": record["level_idx"],
            "metadata": {
                "source": record["source"],
                "patient_id": record["patient_id"],
                "level": IDX_TO_LEVEL.get(record["level_idx"], ""),
                "ivd": record["ivd_level"],
            },
        }

    def get_stats(self) -> dict[str, Any]:
        """Dataset statistics."""
        return {
            "num_samples": len(self.records),
            "num_patients": len(self._get_unique_patients()),
            "levels": dict(Counter(IDX_TO_LEVEL.get(r["level_idx"], "") for r in self.records)),
            "pfirrmann": dict(Counter(r["pfirrmann"] for r in self.records)),
            "modic": dict(Counter(r["modic"] for r in self.records)),
            "sources": dict(Counter(r["source"] for r in self.records)),
            "series_types": list(self.series_types),
            "target_labels": self.target_labels,
            "split": self.split,
        }

    def get_label_distribution(self) -> dict[str, dict[Any, int]]:
        """Distribution of each target label."""
        return {
            label: dict(Counter(r[LABEL_TO_RECORD_KEY.get(label, label)] for r in self.records))
            for label in self.target_labels
        }

    def compute_class_weights(self) -> dict[str, np.ndarray]:
        """Class weights for imbalanced tasks."""
        n = len(self.records)
        weights: dict[str, np.ndarray] = {}
        if "pfirrmann" in self.target_labels:
            counts = Counter(r["pfirrmann"] - 1 for r in self.records)
            weights["pfirrmann"] = np.asarray(
                [n / (5 * counts.get(i, 1)) for i in range(5)], np.float32
            )
        if "modic" in self.target_labels:
            counts = Counter(r["modic"] for r in self.records)
            weights["modic"] = np.asarray(
                [n / (4 * counts.get(i, 1)) for i in range(4)], np.float32
            )
        for label in ("herniation", "bulging", "upper_endplate", "lower_endplate", "spondy",
                      "narrowing"):
            if label in self.target_labels:
                n_pos = sum(r[LABEL_TO_RECORD_KEY[label]] for r in self.records)
                weights[label] = np.asarray([(n - n_pos) / max(n_pos, 1)], np.float32)
        return weights

    def sample_label_values(self, target_label: str) -> list[int]:
        """Per-sample label values for weighted sampling (pfirrmann 0-indexed)."""
        key = LABEL_TO_RECORD_KEY.get(target_label)
        if key is None:
            raise ValueError(
                f"Invalid target_label: {target_label}. Valid: {list(LABEL_TO_RECORD_KEY)}"
            )
        if target_label == "pfirrmann":
            return [r[key] - 1 for r in self.records]
        return [r[key] for r in self.records]
