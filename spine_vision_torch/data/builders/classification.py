"""Classification dataset builder: IVD crops in mm from SPIDER and Phenikaa.

Counterpart of ``spine_vision_tpu/data/builders/classification.py``. Each
series decodes to its isotropic middle sagittal slice
(``io/series.py::prepare_series_slice``); the slices queue and flush in
batches through :class:`SeriesCropPipeline` on the builder's device (the
card by default): normalise, localization forward (ConvNeXt through kernels
#1 and #2 on the card), rotation angles, mm-to-pixel deltas and the fused
crop, for the whole batch in one call. One writer thread encodes the crops
(``data/png.py::write_png``) while the next batch runs, and keeps the
records in queue order. A build resumes from the crops already on disk.
"""

from __future__ import annotations

import csv
import re
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from spine_vision_torch.core.config import BaseConfig
from spine_vision_torch.core.logging import logger
from spine_vision_torch.data.builders.base import ProcessingResult
from spine_vision_torch.data.png import write_png
from spine_vision_torch.device import resolve_device
from spine_vision_torch.infer.pipeline import SeriesCropPipeline, StudyPipelineConfig
from spine_vision_torch.io.series import prepare_series_slice
from spine_vision_torch.io.tabular import write_records_csv
from spine_vision_torch.parallel import data_parallel_mesh


@dataclass
class ClassificationDatasetConfig(BaseConfig):
    """Configuration of the classification dataset build."""

    base_path: Path = field(default_factory=lambda: Path("data"))
    output_name: str = "classification"

    localization_model_path: Path | None = None
    """The localization trainer's checkpoint directory (``best_model``).
    None: crop around the fallback centres."""
    localization_backbone: str = "convnext_base"

    crop_size: tuple[int, int] = (256, 256)
    crop_delta_mm: tuple[float, float, float, float] = (55.0, 15.0, 17.5, 20.0)
    crop_mode: str = "horizontal"
    last_disc_angle_boost: float = 1.0
    image_size: tuple[int, int] = (512, 512)

    include_phenikaa: bool = True
    include_spider: bool = True
    append_to_existing: bool = True

    device_batch_size: int = 8
    """Series slices cropped per pipeline call."""
    data_parallel: bool = False
    """Shard each crop batch over every local device
    (``parallel/mesh.py::data_parallel_mesh``)."""
    padded_hw: tuple[int, int] = (1536, 1536)
    """Static slice buffer; isotropic 0.3 mm slices of lumbar MRI fit."""

    def __post_init__(self) -> None:
        self.base_path = Path(self.base_path)
        if self.localization_model_path is not None:
            self.localization_model_path = Path(self.localization_model_path)

    @property
    def phenikaa_path(self) -> Path:
        return self.base_path / "interim" / "Phenikaa"

    @property
    def spider_path(self) -> Path:
        return self.base_path / "raw" / "SPIDER"

    @property
    def output_path(self) -> Path:
        return self.base_path / "processed" / self.output_name


@dataclass
class ClassificationRecord:
    """One IVD crop with its 8 grading labels."""

    image_path: str
    patient_id: str
    ivd_level: int
    series_type: str
    source: str
    pfirrmann_grade: int
    disc_herniation: int
    disc_narrowing: int
    disc_bulging: int
    spondylolisthesis: int
    modic: int
    up_endplate: int
    low_endplate: int


@dataclass
class ParsedImageInfo:
    """Metadata parsed from a crop file name."""

    source: str
    patient_id: str
    series_type: str
    ivd_level: int
    filename: str


_FILENAME_RE = re.compile(r"^(phenikaa|spider)_(.+)_(sag_t[12])_L(\d)\.png$")


def parse_image_filename(filename: str) -> ParsedImageInfo | None:
    """Parse ``{source}_{patient}_{series}_L{level}.png``."""
    match = _FILENAME_RE.match(filename)
    if not match:
        return None
    return ParsedImageInfo(
        source=match.group(1),
        patient_id=match.group(2),
        series_type=match.group(3),
        ivd_level=int(match.group(4)),
        filename=filename,
    )


def scan_existing_images(images_path: Path) -> list[ParsedImageInfo]:
    """The crops already on disk, for resuming a build."""
    if not images_path.exists():
        return []
    return [
        info
        for f in sorted(images_path.glob("*.png"))
        if (info := parse_image_filename(f.name)) is not None
    ]


def convert_spider_to_phenikaa_level(spider_level: int) -> int:
    """SPIDER counts discs bottom-up (1 = L5/S1); Phenikaa top-down (1 = L1/L2)."""
    return 6 - spider_level


# ---------------------------------------------------------------------------
# Label loading
# ---------------------------------------------------------------------------


def _load_phenikaa_labels(labels_path: Path) -> dict[str, dict[int, dict]]:
    """patient -> level -> row."""
    patient_labels: dict[str, dict[int, dict]] = {}
    with open(labels_path, newline="") as f:
        for row in csv.DictReader(f):
            patient_labels.setdefault(row["Patient ID"], {})[int(row["IVD label"])] = row
    return patient_labels


def _load_spider_labels(labels_path: Path) -> dict[int, dict[int, dict]]:
    """patient -> Phenikaa level -> row."""
    patient_labels: dict[int, dict[int, dict]] = {}
    with open(labels_path, newline="") as f:
        for row in csv.DictReader(f):
            patient_id = int(row["Patient"])
            level = convert_spider_to_phenikaa_level(int(row["IVD label"]))
            patient_labels.setdefault(patient_id, {})[level] = row
    return patient_labels


def _record_from_row(
    filename: str,
    patient_id: str,
    ivd_level: int,
    series_type: str,
    label_row: dict,
    source: str,
) -> ClassificationRecord:
    """A record; Phenikaa's one-hot Modic columns collapse to an ordinal
    (SPIDER rows carry ``Modic``)."""
    if "Modic" in label_row:
        modic = int(label_row.get("Modic", 0))
    else:
        modic = 0
        for i in range(4):
            if str(label_row.get(f"Modic_{i}", "0")) == "1":
                modic = i
                break
    return ClassificationRecord(
        image_path=f"images/{filename}",
        patient_id=str(patient_id),
        ivd_level=ivd_level,
        series_type=series_type,
        source=source,
        pfirrmann_grade=int(label_row.get("Pfirrman grade", 0)),
        disc_herniation=int(label_row.get("Disc herniation", 0)),
        disc_narrowing=int(label_row.get("Disc narrowing", 0)),
        disc_bulging=int(label_row.get("Disc bulging", 0)),
        spondylolisthesis=int(label_row.get("Spondylolisthesis", 0)),
        modic=modic,
        up_endplate=int(label_row.get("UP endplate", 0)),
        low_endplate=int(label_row.get("LOW endplate", 0)),
    )


# ---------------------------------------------------------------------------
# Annotation recovery (resumed builds)
# ---------------------------------------------------------------------------


def recover_phenikaa_annotations(
    existing_images: list[ParsedImageInfo], labels_path: Path
) -> list[ClassificationRecord]:
    """Records of the Phenikaa crops on disk, from the source labels."""
    if not labels_path.exists():
        logger.warning("Cannot recover Phenikaa annotations: %s missing", labels_path)
        return []
    patient_labels = _load_phenikaa_labels(labels_path)
    records = []
    for info in existing_images:
        if info.source != "phenikaa":
            continue
        row = patient_labels.get(info.patient_id, {}).get(info.ivd_level)
        if row is None:
            logger.debug("No labels for %s L%d", info.patient_id, info.ivd_level)
            continue
        records.append(
            _record_from_row(
                info.filename, info.patient_id, info.ivd_level, info.series_type, row,
                "phenikaa",
            )
        )
    return records


def recover_spider_annotations(
    existing_images: list[ParsedImageInfo], labels_path: Path
) -> list[ClassificationRecord]:
    """Records of the SPIDER crops on disk (levels converted)."""
    if not labels_path.exists():
        logger.warning("Cannot recover SPIDER annotations: %s missing", labels_path)
        return []
    patient_labels = _load_spider_labels(labels_path)
    records = []
    for info in existing_images:
        if info.source != "spider":
            continue
        try:
            patient_id = int(info.patient_id)
        except ValueError:
            logger.debug("Invalid SPIDER patient ID: %s", info.patient_id)
            continue
        row = patient_labels.get(patient_id, {}).get(info.ivd_level)
        if row is None:
            continue
        records.append(
            _record_from_row(
                info.filename, str(patient_id), info.ivd_level, info.series_type, row, "spider",
            )
        )
    return records


# ---------------------------------------------------------------------------
# Batched crop extraction
# ---------------------------------------------------------------------------


@dataclass
class _SeriesWork:
    """One series slice queued for a crop batch."""

    source: str
    patient_id: str
    series_type: str
    slice_2d: np.ndarray
    spacing: tuple[float, float]
    levels: dict[int, dict]  # Phenikaa level -> label row


class _CropBatcher:
    """Queues series and flushes them through the crop pipeline; one writer
    thread encodes batch n's crops while batch n+1 runs."""

    def __init__(
        self, pipeline: SeriesCropPipeline, output_images_path: Path, batch_size: int
    ) -> None:
        self.pipeline = pipeline
        self.output_images_path = output_images_path
        self.batch_size = batch_size
        self.queue: list[_SeriesWork] = []
        # Appended by the writer thread only; read after finish().
        self.records: list[ClassificationRecord] = []
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._writes: list[Future] = []

    def add(self, work: _SeriesWork) -> None:
        self.queue.append(work)
        if len(self.queue) >= self.batch_size:
            self.flush()

    def flush(self) -> None:
        if not self.queue:
            return
        # A writer failure surfaces now, not after hours more of decoding
        # and cropping: a done future re-raises its exception here.
        for future in self._writes:
            if future.done():
                future.result()
        self._writes = [f for f in self._writes if not f.done()]
        batch = self.queue
        self.queue = []
        _, _, crops = self.pipeline.run([w.slice_2d for w in batch], [w.spacing for w in batch])
        self._writes.append(self._writer.submit(self._write_batch, batch, crops))

    def _write_batch(self, batch: list[_SeriesWork], crops: np.ndarray) -> None:
        for work, series_crops in zip(batch, crops):
            for ivd_level, label_row in work.levels.items():
                filename = f"{work.source}_{work.patient_id}_{work.series_type}_L{ivd_level}.png"
                write_png(self.output_images_path / filename, series_crops[ivd_level - 1])
                self.records.append(
                    _record_from_row(
                        filename, work.patient_id, ivd_level, work.series_type, label_row,
                        work.source,
                    )
                )

    def finish(self) -> None:
        """Flush the queue and wait for every pending write."""
        try:
            self.flush()
            for future in self._writes:
                future.result()  # surface writer exceptions
            self._writes = []
        finally:
            self._writer.shutdown(wait=True)


def _todo(levels: dict[int, dict], prefix: str, existing_image_paths: set[str]) -> dict:
    """The levels 1-5 of a series whose crop is not on disk yet."""
    return {
        lvl: row for lvl, row in levels.items()
        if 1 <= lvl <= 5 and f"images/{prefix}_L{lvl}.png" not in existing_image_paths
    }


def process_spider(
    config: ClassificationDatasetConfig,
    batcher: _CropBatcher,
    existing_image_paths: set[str],
) -> int:
    """Queue the SPIDER series (an ``.mha`` per patient and series)."""
    labels_path = config.spider_path / "radiological_gradings.csv"
    images_path = config.spider_path / "images"
    if not labels_path.exists():
        logger.warning("SPIDER labels not found: %s", labels_path)
        return 0

    patient_labels = _load_spider_labels(labels_path)
    device = batcher.pipeline.device
    queued = 0
    for patient_id, levels in patient_labels.items():
        for series_suffix, series_type in (("t1", "sag_t1"), ("t2", "sag_t2")):
            image_file = images_path / f"{patient_id}_{series_suffix}.mha"
            if not image_file.exists():
                continue
            todo = _todo(levels, f"spider_{patient_id}_{series_type}", existing_image_paths)
            if not todo:
                continue
            try:
                slice_2d, spacing = prepare_series_slice(image_file, device=device)
            except Exception as exc:  # noqa: BLE001 -- an unreadable series is skipped
                logger.debug("Error processing %s: %s", image_file, exc)
                continue
            batcher.add(_SeriesWork("spider", str(patient_id), series_type, slice_2d, spacing,
                                    todo))
            queued += 1
    return queued


def _find_series_directory(patient_dir: Path, series_pattern: str) -> Path | None:
    """Series directory by name, ignoring case and spaces."""
    normalized = series_pattern.lower().replace(" ", "")
    for subdir in patient_dir.iterdir():
        if subdir.is_dir() and subdir.name.lower().replace(" ", "") == normalized:
            return subdir
    return None


def process_phenikaa(
    config: ClassificationDatasetConfig,
    batcher: _CropBatcher,
    existing_image_paths: set[str],
) -> int:
    """Queue the Phenikaa series (DICOM directories)."""
    labels_path = config.phenikaa_path / "radiological_labels.csv"
    images_path = config.phenikaa_path / "images"
    if not labels_path.exists():
        logger.warning("Phenikaa labels not found: %s", labels_path)
        return 0

    patient_labels = _load_phenikaa_labels(labels_path)
    device = batcher.pipeline.device
    queued = 0
    for patient_id, levels in patient_labels.items():
        patient_dir = images_path / patient_id
        if not patient_dir.exists():
            logger.debug("Patient directory not found: %s", patient_dir)
            continue
        for series_pattern, series_type in (("sag t1", "sag_t1"), ("sag t2", "sag_t2")):
            series_dir = _find_series_directory(patient_dir, series_pattern)
            if series_dir is None:
                continue
            todo = _todo(levels, f"phenikaa_{patient_id}_{series_type}", existing_image_paths)
            if not todo:
                continue
            try:
                slice_2d, spacing = prepare_series_slice(series_dir, device=device)
            except Exception as exc:  # noqa: BLE001 -- an unreadable series is skipped
                logger.debug("Error reading %s: %s", series_dir, exc)
                continue
            batcher.add(_SeriesWork("phenikaa", patient_id, series_type, slice_2d, spacing,
                                    todo))
            queued += 1
    return queued


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def _build_pipeline(
    config: ClassificationDatasetConfig, device: str | torch.device = "cuda"
) -> SeriesCropPipeline:
    """The crop pipeline: the localization trainer's checkpoint in a bf16
    ``CoordinateRegressor`` (f32 parameters; the kernels on the card, as
    ``StudyInferencePipeline.from_checkpoints`` builds it), or the fallback
    centres without one."""
    dev = resolve_device(device)
    pipe_config = StudyPipelineConfig(
        loc_image_size=config.image_size,
        crop_size=config.crop_size,
        crop_delta_mm=config.crop_delta_mm,
        crop_mode=config.crop_mode,
        last_disc_angle_boost=config.last_disc_angle_boost,
        padded_hw=config.padded_hw,
    )
    # data_parallel: every local device of the kind asked for (the CPU is one).
    mesh = None
    if config.data_parallel:
        mesh = data_parallel_mesh() if dev.type == "cuda" else data_parallel_mesh([dev])
    if config.localization_model_path is None:
        logger.info("No localization model; using center fallback locations")
        return SeriesCropPipeline(None, config=pipe_config, device=dev, mesh=mesh)

    from spine_vision_torch.models.classifier import CoordinateRegressor
    from spine_vision_torch.train.checkpoint import load_model_state

    logger.info("Loading localization model: %s", config.localization_model_path)
    model = CoordinateRegressor(
        config.localization_backbone, dtype=torch.bfloat16, device=dev,
        use_pallas=dev.type == "cuda", param_dtype=torch.float32,
    )
    load_model_state(config.localization_model_path, model)
    return SeriesCropPipeline(model, config=pipe_config, device=dev, mesh=mesh)


def log_dataset_summary(records: Iterable[ClassificationRecord]) -> None:
    """Counts by source, series and level."""
    records = list(records)
    by: dict[str, dict[Any, int]] = {"source": {}, "series": {}, "level": {}}
    for r in records:
        by["source"][r.source] = by["source"].get(r.source, 0) + 1
        by["series"][r.series_type] = by["series"].get(r.series_type, 0) + 1
        by["level"][r.ivd_level] = by["level"].get(r.ivd_level, 0) + 1
    logger.info("Classification dataset: %d records", len(records))
    for key, counts in by.items():
        logger.info("  by %s: %s", key, dict(sorted(counts.items())))


def create_classification_dataset(
    config: ClassificationDatasetConfig, device: str | torch.device = "cuda"
) -> ProcessingResult:
    """Build (or resume) the two-source crop dataset: ``images/`` and
    ``annotations.csv`` under ``config.output_path``."""
    dev = resolve_device(device)
    csv_path = config.output_path / "annotations.csv"
    output_images_path = config.output_path / "images"
    output_images_path.mkdir(parents=True, exist_ok=True)

    existing_images = scan_existing_images(output_images_path)
    existing_image_paths: set[str] = set()
    recovered: list[ClassificationRecord] = []
    if existing_images and config.append_to_existing:
        logger.info("Found %d existing images on disk", len(existing_images))
        existing_image_paths = {f"images/{i.filename}" for i in existing_images}
        recovered = recover_phenikaa_annotations(
            existing_images, config.phenikaa_path / "radiological_labels.csv"
        ) + recover_spider_annotations(
            existing_images, config.spider_path / "radiological_gradings.csv"
        )
        logger.info("Recovered annotations for %d existing images", len(recovered))
        orphans = len(existing_images) - len(recovered)
        if orphans > 0:
            logger.warning("%d existing images have no matching labels", orphans)

    pipeline = _build_pipeline(config, dev)
    batcher = _CropBatcher(pipeline, output_images_path, batch_size=config.device_batch_size)

    queued = 0
    if config.include_phenikaa:
        queued += process_phenikaa(config, batcher, existing_image_paths)
    if config.include_spider:
        queued += process_spider(config, batcher, existing_image_paths)
    batcher.finish()

    all_records = recovered + batcher.records
    if all_records:
        write_records_csv(all_records, csv_path)
    log_dataset_summary(all_records)
    logger.info(
        "Processed %d new series (%d new records, %d recovered)",
        queued, len(batcher.records), len(recovered),
    )

    return ProcessingResult(
        num_samples=len(all_records),
        output_path=config.output_path,
        summary=(
            f"Classification dataset: {len(all_records)} records "
            f"({len(batcher.records)} new, {len(recovered)} recovered)"
        ),
    )
