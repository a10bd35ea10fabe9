"""Localization dataset builder: the lumbar-coords pretrain set and RSNA.

Counterpart of ``spine_vision_tpu/data/builders/localization.py``. DICOM
decodes through ``io/dicom.py``; intensities are min-max normalised to uint8
by ``ops/image.py::normalize_to_uint8`` on the builder's device (the card by
default) and written by ``data/png.py::write_png``. Sources that are already
JPGs are copied byte for byte. A ``.npy`` source listed under a ``.jpg``
name keeps that name, as in the JAX package, but holds PNG bytes: the port
has no JPEG encoder, and a reader that goes by the content (cv2, the port's
PNG reader) gets the normalised pixels without JPEG's loss.
"""

from __future__ import annotations

import csv
import shutil
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from spine_vision_torch.core.config import BaseConfig
from spine_vision_torch.core.logging import logger
from spine_vision_torch.data.builders.base import ProcessingResult
from spine_vision_torch.data.png import write_png
from spine_vision_torch.data.rsna import get_series_type, load_series_mapping
from spine_vision_torch.device import resolve_device
from spine_vision_torch.io.dicom import read_dicom_file
from spine_vision_torch.io.tabular import write_records_csv
from spine_vision_torch.ops.image import normalize_to_uint8

# Source layout of the "Lumbar Coords" pretrain collection.
_SOURCE_TO_FOLDER = {
    "spider": "processed_spider_jpgs",
    "lsd": "processed_lsd_jpgs",
    "osf": "processed_osf_jpgs",
    "tseg": "processed_tseg_jpgs",
}
_SOURCE_TO_NPY_FOLDER = {
    "spider": None,
    "lsd": "processed_lsd",
    "osf": "processed_osf",
    "tseg": "processed_tseg",
}
_SOURCE_TO_SERIES_TYPE = {
    "spider": "sag_t2",
    "lsd": "sag_t2",
    "osf": "sag_t1",
    "tseg": "ct",
}


@dataclass
class LocalizationDatasetConfig(BaseConfig):
    """Configuration of the localization dataset build."""

    base_path: Path = field(default_factory=lambda: Path("data"))
    output_name: str = "localization"

    include_neural_foraminal: bool = True
    include_spinal_canal: bool = True
    skip_invalid_instances: bool = True

    def __post_init__(self) -> None:
        self.base_path = Path(self.base_path)

    @property
    def lumbar_coords_path(self) -> Path:
        return self.base_path / "raw" / "Lumbar Coords"

    @property
    def rsna_path(self) -> Path:
        return self.base_path / "raw" / "RSNA"

    @property
    def output_path(self) -> Path:
        return self.base_path / "processed" / self.output_name


@dataclass
class AnnotationRecord:
    """One IVD coordinate annotation."""

    image_path: str
    level: str
    relative_x: float
    relative_y: float
    series_type: str
    source: str


def _save_normalized_png(arr: np.ndarray, output_path: Path, device: torch.device) -> None:
    """Min-max normalise ``arr`` on ``device`` and write a uint8 PNG."""
    f32 = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    write_png(output_path, normalize_to_uint8(f32.to(device)).cpu().numpy())


def process_lumbar_coords_pretrain(
    coords_csv_path: Path,
    data_path: Path,
    output_images_path: Path,
    device: str | torch.device = "cuda",
) -> list[AnnotationRecord]:
    """Ingest the four-source pretrain collection (spider/lsd/osf/tseg).

    JPG sources are copied; ``.npy`` sources are normalised to uint8 PNG on
    ``device``.
    """
    dev = resolve_device(device)
    records: list[AnnotationRecord] = []
    processed: set[str] = set()

    with open(coords_csv_path, newline="") as f:
        for row in csv.DictReader(f):
            filename = row["filename"]
            source = row["source"]
            folder = _SOURCE_TO_FOLDER.get(source)
            if folder is None:
                logger.warning("Unknown source: %s", source)
                continue

            output_filename = f"pretrain_{source}_{filename}"
            if not output_filename.endswith((".jpg", ".png")):
                output_filename = output_filename.replace(".npy", ".png")
            output_path = output_images_path / output_filename

            if output_filename not in processed:
                src_img = data_path / folder / filename
                if src_img.exists():
                    shutil.copy(src_img, output_path)
                    processed.add(output_filename)
                else:
                    npy_folder = _SOURCE_TO_NPY_FOLDER.get(source)
                    npy_path = (
                        data_path / npy_folder / filename.replace(".jpg", ".npy")
                        if npy_folder
                        else None
                    )
                    if npy_path is not None and npy_path.exists():
                        _save_normalized_png(np.load(npy_path), output_path, dev)
                        processed.add(output_filename)
                    else:
                        logger.warning("File not found: %s", src_img)
                        continue

            records.append(
                AnnotationRecord(
                    image_path=f"images/{output_filename}",
                    level=row["level"],
                    relative_x=float(row["relative_x"]),
                    relative_y=float(row["relative_y"]),
                    series_type=_SOURCE_TO_SERIES_TYPE[source],
                    source=f"pretrain_{source}",
                )
            )
    return records


def process_rsna_improved(
    coords_csv_path: Path,
    series_desc_path: Path,
    rsna_images_path: Path,
    output_images_path: Path,
    config: LocalizationDatasetConfig,
    device: str | torch.device = "cuda",
) -> list[AnnotationRecord]:
    """Ingest the RSNA improved coordinates.

    Keeps the spinal-canal (sagittal T2) and neural-foraminal (sagittal T1)
    conditions and drops the subarticular (axial) ones; each instance
    decodes once through ``io/dicom.py`` and is normalised on ``device``.
    """
    dev = resolve_device(device)
    records: list[AnnotationRecord] = []
    series_mapping = load_series_mapping(series_desc_path)
    processed: set[str] = set()

    with open(coords_csv_path, newline="") as f:
        rows = list(csv.DictReader(f))

    for row in rows:
        condition = row["condition"]
        if "Subarticular" in condition:
            continue
        if "Spinal Canal" in condition and not config.include_spinal_canal:
            continue
        if "Neural Foraminal" in condition and not config.include_neural_foraminal:
            continue

        instance_number = int(row["instance_number"])
        if config.skip_invalid_instances and instance_number < 0:
            continue

        study_id = int(row["study_id"])
        series_id = int(row["series_id"])
        desc = get_series_type(series_id, study_id, series_mapping)
        if desc is None:
            logger.debug("Series %d not found for study %d", series_id, study_id)
            continue
        if "Sagittal T1" in desc:
            series_type = "sag_t1"
        elif "Sagittal T2" in desc:
            series_type = "sag_t2"
        else:
            continue

        dcm_path = rsna_images_path / str(study_id) / str(series_id) / f"{instance_number}.dcm"
        if not dcm_path.exists():
            logger.debug("DICOM not found: %s", dcm_path)
            continue

        output_filename = f"rsna_{study_id}_{series_id}_{instance_number}.png"
        if output_filename not in processed:
            try:
                arr = read_dicom_file(dcm_path).array
                if arr.ndim == 3:
                    arr = arr[0]
                _save_normalized_png(arr, output_images_path / output_filename, dev)
                processed.add(output_filename)
            except Exception as exc:  # noqa: BLE001 -- one bad file skips its rows
                logger.error("Error processing %s: %s", dcm_path, exc)
                continue

        records.append(
            AnnotationRecord(
                image_path=f"images/{output_filename}",
                level=row["level"],
                relative_x=float(row["relative_x"]),
                relative_y=float(row["relative_y"]),
                series_type=series_type,
                source="rsna",
            )
        )
    return records


def log_dataset_summary(records: list[AnnotationRecord]) -> None:
    """Counts by source, level and series type."""
    by_source: dict[str, int] = {}
    by_level: dict[str, int] = {}
    by_series: dict[str, int] = {}
    for r in records:
        by_source[r.source] = by_source.get(r.source, 0) + 1
        by_level[r.level] = by_level.get(r.level, 0) + 1
        by_series[r.series_type] = by_series.get(r.series_type, 0) + 1
    unique_images = len({r.image_path for r in records})
    logger.info("Dataset summary: %d annotations, %d images", len(records), unique_images)
    logger.info("  by source: %s", by_source)
    logger.info("  by level: %s", dict(sorted(by_level.items())))
    logger.info("  by series: %s", by_series)


def create_localization_dataset(
    config: LocalizationDatasetConfig, device: str | torch.device = "cuda"
) -> ProcessingResult:
    """Build the combined localization dataset: ``images/`` and
    ``annotations.csv`` under ``config.output_path``."""
    dev = resolve_device(device)
    output_images_path = config.output_path / "images"
    output_images_path.mkdir(parents=True, exist_ok=True)

    all_records: list[AnnotationRecord] = []

    pretrain_csv = config.lumbar_coords_path / "coords_pretrain.csv"
    if pretrain_csv.exists():
        logger.info("Processing Lumbar Coords pretrain data...")
        pretrain = process_lumbar_coords_pretrain(
            coords_csv_path=pretrain_csv,
            data_path=config.lumbar_coords_path / "data",
            output_images_path=output_images_path,
            device=dev,
        )
        all_records.extend(pretrain)
        logger.info("Processed %d pretrain annotation records", len(pretrain))
    else:
        logger.warning("Pretrain coords not found: %s", pretrain_csv)

    rsna_csv = config.lumbar_coords_path / "coords_rsna_improved.csv"
    if rsna_csv.exists():
        logger.info("Processing RSNA improved coordinates...")
        rsna = process_rsna_improved(
            coords_csv_path=rsna_csv,
            series_desc_path=config.rsna_path / "train_series_descriptions.csv",
            rsna_images_path=config.rsna_path / "train_images",
            output_images_path=output_images_path,
            config=config,
            device=dev,
        )
        all_records.extend(rsna)
        logger.info("Processed %d RSNA annotation records", len(rsna))
    else:
        logger.warning("RSNA coords not found: %s", rsna_csv)

    csv_path = config.output_path / "annotations.csv"
    if all_records:
        write_records_csv(all_records, csv_path)
    log_dataset_summary(all_records)
    logger.info("Dataset saved to: %s", config.output_path)

    return ProcessingResult(
        num_samples=len(all_records),
        output_path=config.output_path,
        summary=f"Created {len(all_records)} IVD coordinate annotations",
    )
