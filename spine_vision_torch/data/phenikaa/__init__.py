"""Phenikaa report preprocessing: OCR extraction and fuzzy patient matching.

Counterpart of ``spine_vision_tpu/data/phenikaa/__init__.py``. Vietnamese
report fields are fuzzy-located in OCR text lines (``matching.py``); each
patient is matched to an image study folder by the folded name's similarity
with a birth-year tiebreak; matched studies are copied and the label table
is filtered to them. The OCR engine is ``ocr.py``'s
:class:`DocumentExtractor` (on the card by default); the processors accept
any engine with the same interface, so the pipeline is testable with fakes.

``preprocess_phenikaa`` does on the rows of ``io/tabular.py::load_tabular_data``
what the JAX package does on its DataFrame (``astype(int)``, ``isin``) and
writes the table as ``DataFrame.to_csv(index=False)`` writes it
(``io/tabular.py::write_table_csv``). OCR weights given as checkpoints are
``.npz`` variable files (the shipped format); an Orbax checkpoint directory
raises.
"""

from __future__ import annotations

import re
import shutil
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from pathlib import Path

import torch

from spine_vision_torch.core.config import BaseConfig
from spine_vision_torch.core.logging import logger
from spine_vision_torch.data.builders.base import ProcessingResult
from spine_vision_torch.data.phenikaa.matching import PatientMatcher, fuzzy_value_extract_spatial
from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor
from spine_vision_torch.device import resolve_device

# Vietnamese OCR field patterns.
NAME_FIELD_PATTERN = "Ho ten nguoi benh"
BIRTHDAY_FIELD_PATTERN = "Ngay sinh"
ID_FIELD_PATTERN = "So phieu"
ONE_HOT_COL = "Modic"

SUPPORTED_EXTENSIONS = (".pdf", ".png", ".jpg", ".jpeg")

# Report file name shapes.
PATIENT_NAMED_REPORT_REGEX = re.compile(
    r"^[a-zA-ZÀ-ỹ]+(?:[\s_][a-zA-ZÀ-ỹ]+)*(?:[\s_]\d{8})?$"
)
ID_NAMED_REPORT_REGEX = re.compile(r"^\d+$")

# Pixel crop (x1, y1, x2, y2) at 200 DPI where the report ID usually sits.
DEFAULT_PDF_ID_CROP_REGION: tuple[int, int, int, int] = (1100, 200, 1500, 400)


def _id_from_text(text: str) -> int | None:
    """Patient ID from an OCR line: the first contiguous run of at least 6
    digits, so a date on the same line cannot join it. Failing that, the
    same after removing whitespace (OCR sometimes splits an ID: "2500 99999")."""
    match = re.search(r"\d{6,}", text)
    if match is None:
        match = re.search(r"\d{6,}", re.sub(r"\s", "", text))
    return int(match.group()) if match else None


@dataclass
class ReportInfo:
    """Fields extracted from one medical report."""

    patient_id: int | None
    patient_name: str | None
    patient_birthday: str | None
    source_path: Path


class ReportProcessor(ABC):
    """Strategy for one report file name convention."""

    @abstractmethod
    def can_process(self, report_path: Path) -> bool: ...

    @abstractmethod
    def process(
        self, report_path: Path, extractor: DocumentExtractor, fuzzy_threshold: float
    ) -> ReportInfo | None: ...


class IdNamedReportProcessor(ReportProcessor):
    """Reports named by numeric patient ID; name and birthday from OCR."""

    def can_process(self, report_path: Path) -> bool:
        return ID_NAMED_REPORT_REGEX.match(report_path.stem) is not None

    def process(
        self, report_path: Path, extractor: DocumentExtractor, fuzzy_threshold: float
    ) -> ReportInfo | None:
        try:
            patient_id = int(report_path.stem)
        except ValueError:
            logger.warning("Could not parse ID from filename: %s", report_path.name)
            return None

        lines = extractor.extract_lines(report_path)
        if not lines:
            logger.warning("No text extracted from report: %s", report_path)
            return None

        # The same-line key/value split first, then the layout fallback
        # (the value beside or below its label).
        patient_name = fuzzy_value_extract_spatial(
            lines, NAME_FIELD_PATTERN, fuzzy_threshold, window_length=3
        )
        if not patient_name:
            logger.warning("Could not extract name for ID %d", patient_id)
            return None

        patient_birthday = fuzzy_value_extract_spatial(
            lines, BIRTHDAY_FIELD_PATTERN, fuzzy_threshold, window_length=2
        )
        if not patient_birthday:
            logger.warning("Could not extract birthday for ID %d", patient_id)
            return None

        return ReportInfo(
            patient_id=patient_id,
            patient_name=patient_name,
            patient_birthday=patient_birthday,
            source_path=report_path,
        )


class PatientNamedReportProcessor(ReportProcessor):
    """Reports named by patient name; the ID from OCR, first from a PDF's
    crop region where the ID usually sits."""

    def __init__(
        self, pdf_id_crop_region: tuple[int, int, int, int] = DEFAULT_PDF_ID_CROP_REGION
    ) -> None:
        self.pdf_id_crop_region = pdf_id_crop_region

    def can_process(self, report_path: Path) -> bool:
        return PATIENT_NAMED_REPORT_REGEX.match(report_path.stem) is not None

    @staticmethod
    def _parse_filename(stem: str) -> tuple[str, str | None]:
        """(name, 8-digit date or None), split on spaces and underscores
        (the two separators the report regex admits)."""
        parts = [p for p in re.split(r"[\s_]+", stem) if p]
        if len(parts) >= 2 and re.match(r"^\d{8}$", parts[-1]):
            return "".join(parts[:-1]), parts[-1]
        return "".join(parts), None

    def _extract_id_from_pdf_crop(
        self, report_path: Path, extractor: DocumentExtractor
    ) -> int | None:
        try:
            text_lines = extractor.extract_from_pdf_crop(report_path, self.pdf_id_crop_region)
        except Exception as exc:  # noqa: BLE001 -- the full page is the fallback
            logger.debug("Failed to extract from PDF crop: %s", exc)
            return None
        for line in text_lines:
            patient_id = _id_from_text(line)
            if patient_id is not None:
                return patient_id
        return None

    def process(
        self, report_path: Path, extractor: DocumentExtractor, fuzzy_threshold: float
    ) -> ReportInfo | None:
        patient_name, _ = self._parse_filename(report_path.stem)

        patient_id: int | None = None
        if report_path.suffix.lower() == ".pdf":
            patient_id = self._extract_id_from_pdf_crop(report_path, extractor)
            if patient_id:
                logger.debug("Extracted ID %d from PDF crop region", patient_id)

        lines: list | None = None
        if patient_id is None:
            lines = extractor.extract_lines(report_path)
            if not lines:
                logger.warning("No text extracted from report: %s", report_path)
                return None
            id_str = fuzzy_value_extract_spatial(
                lines, ID_FIELD_PATTERN, fuzzy_threshold, window_length=2
            )
            patient_id = _id_from_text(id_str or "")
            if patient_id is None:
                logger.warning("Could not extract ID for patient: %s", patient_name)
                return None

        if lines is None:
            lines = extractor.extract_lines(report_path)
        patient_birthday = (
            fuzzy_value_extract_spatial(
                lines, BIRTHDAY_FIELD_PATTERN, fuzzy_threshold, window_length=2
            )
            if lines
            else None
        )

        return ReportInfo(
            patient_id=patient_id,
            patient_name=patient_name,
            patient_birthday=patient_birthday,
            source_path=report_path,
        )


class ReportProcessorRegistry:
    """The first registered processor that accepts a report handles it."""

    def __init__(self) -> None:
        self._processors: list[ReportProcessor] = []

    def register(self, processor: ReportProcessor) -> None:
        self._processors.append(processor)

    def process(
        self, report_path: Path, extractor: DocumentExtractor, fuzzy_threshold: float
    ) -> ReportInfo | None:
        for processor in self._processors:
            if processor.can_process(report_path):
                return processor.process(report_path, extractor, fuzzy_threshold)
        logger.debug("No processor matched: %s", report_path.name)
        return None


def build_report_processor_registry(
    pdf_id_crop_region: tuple[int, int, int, int] = DEFAULT_PDF_ID_CROP_REGION,
) -> ReportProcessorRegistry:
    registry = ReportProcessorRegistry()
    registry.register(IdNamedReportProcessor())
    registry.register(PatientNamedReportProcessor(pdf_id_crop_region))
    return registry


def collect_report_files(report_path: Path) -> list[Path]:
    """Every supported report file under a directory (extensions matched
    without regard to case: scanners write .PDF and .JPG too)."""
    extensions = {ext.lower() for ext in SUPPORTED_EXTENSIONS}
    report_files = sorted(
        p for p in Path(report_path).rglob("*") if p.is_file() and p.suffix.lower() in extensions
    )
    logger.info("Found %d report files", len(report_files))
    return report_files


@dataclass
class PreprocessConfig(BaseConfig):
    """Configuration of the Phenikaa preprocessing."""

    data_path: Path = field(default_factory=lambda: Path("data/raw/Phenikaa"))
    exclude_files: list[str] = field(default_factory=list)
    id_col: str = "Patient ID"
    corrupted_ids: list[int] = field(
        default_factory=lambda: [25001, 250027783, 250026093, 250026925, 250026665, 250010269]
    )
    output_table: str = "radiological_labels.csv"
    detection_checkpoint: Path | None = None
    recognition_checkpoint: Path | None = None
    report_fuzzy_threshold: float = 80
    image_fuzzy_threshold: float = 85
    pdf_dpi: int = 200
    pdf_id_crop_region: tuple[int, int, int, int] = DEFAULT_PDF_ID_CROP_REGION

    output_path: Path = field(default_factory=lambda: Path("data/interim/Phenikaa"))

    def __post_init__(self) -> None:
        self.data_path = Path(self.data_path)
        self.output_path = Path(self.output_path)

    @property
    def image_path(self) -> Path:
        return self.data_path / "images"

    @property
    def report_path(self) -> Path:
        return self.data_path / "labels" / "reports"

    @property
    def table_path(self) -> Path:
        return self.data_path / "labels" / "tables"

    @property
    def output_table_path(self) -> Path:
        return self.output_path / self.output_table

    @property
    def output_image_path(self) -> Path:
        return self.output_path / "images"


def preprocess_phenikaa(
    config: PreprocessConfig,
    extractor: DocumentExtractor | None = None,
    device: str | torch.device = "cuda",
) -> ProcessingResult:
    """OCR each report, fuzzy-match it to a study folder, copy the matched
    studies and write the label table filtered to them.

    Args:
        config: Pipeline configuration.
        extractor: Optional OCR engine (tests inject fakes here); without
            one, the shipped or configured weights on ``device``.
        device: Where the OCR nets run (the card by default).
    """
    from spine_vision_torch.io.tabular import load_tabular_data, write_table_csv

    label_rows = load_tabular_data(
        table_path=config.table_path,
        exclude_files=config.exclude_files,
        id_col=config.id_col,
        corrupted_ids=config.corrupted_ids,
        one_hot_col=ONE_HOT_COL,
    )
    if not label_rows:
        logger.info("No valid data found at %s", config.table_path)
        return ProcessingResult(
            num_samples=0, output_path=config.output_path, summary="No valid data found"
        )
    columns = list(label_rows[0])
    # DataFrame.astype(int): ints and bools as they are, floats truncated
    # toward zero, strings parsed (a value that is no integer raises).
    label_rows = [{k: int(v) for k, v in row.items()} for row in label_rows]
    ids = [row[config.id_col] for row in label_rows]
    logger.debug("Unique patients: %d", len(set(ids)))

    if extractor is None:
        logger.info("Loading OCR models.")
        extractor = _build_extractor(config, device)

    report_files = collect_report_files(config.report_path)
    registry = build_report_processor_registry(config.pdf_id_crop_region)
    matcher = PatientMatcher(image_path=config.image_path, threshold=config.image_fuzzy_threshold)

    valid_ids = set(ids)
    matched_ids: list[int] = []
    matched_set: set[int] = set()

    for report_path in report_files:
        # An ID-named report shows its ID before any OCR: skip unlabelled
        # ones (and repeats) without a full-page OCR pass.
        if ID_NAMED_REPORT_REGEX.match(report_path.stem):
            stem_id = int(report_path.stem)
            if stem_id not in valid_ids:
                logger.debug("ID %d not in label data, skipping", stem_id)
                continue
            if stem_id in matched_set:
                logger.warning(
                    "Duplicate report for already-matched ID %d: %s (skipped to avoid "
                    "merging two source folders)", stem_id, report_path,
                )
                continue
        info = registry.process(report_path, extractor, config.report_fuzzy_threshold)
        if not info or info.patient_id is None:
            continue
        if info.patient_id not in valid_ids:
            logger.debug("ID %d not in label data, skipping", info.patient_id)
            continue
        if info.patient_id in matched_set:
            logger.warning(
                "Duplicate report for already-matched ID %d: %s (skipped to avoid merging "
                "two source folders)", info.patient_id, report_path,
            )
            continue

        if info.patient_name and info.patient_birthday:
            best_folder = matcher.match(info.patient_name, info.patient_birthday)
        elif info.patient_name:
            best_folder = matcher.match_by_name(info.patient_name)
        else:
            best_folder = None

        if best_folder:
            dest = config.output_image_path / str(info.patient_id)
            shutil.copytree(best_folder, dest, dirs_exist_ok=True)
            logger.info("Copied %s -> %s", best_folder.name, dest)
            matched_ids.append(info.patient_id)
            matched_set.add(info.patient_id)
        else:
            logger.warning(
                "No matching folder for '%s' (ID: %s)", info.patient_name, info.patient_id
            )

    kept = [row for row in label_rows if row[config.id_col] in matched_set]
    config.output_path.mkdir(parents=True, exist_ok=True)
    write_table_csv(kept, config.output_table_path, columns)
    logger.info("Saved table to %s", config.output_table_path)
    logger.info("Matched %d patients of %d", len(matched_ids), len(valid_ids))

    return ProcessingResult(
        num_samples=len(matched_ids),
        output_path=config.output_path,
        summary=f"Matched {len(matched_ids)} of {len(valid_ids)} patients",
    )


def _build_extractor(
    config: PreprocessConfig, device: str | torch.device = "cuda"
) -> DocumentExtractor:
    """The OCR engine on ``device``: the configured checkpoints, else the
    shipped weights."""
    from spine_vision_torch.data.phenikaa.ocr import TextDetector, TextRecognizer

    dev = resolve_device(device)
    det_vars = rec_vars = None
    if config.detection_checkpoint is not None:
        det_vars = _load_ocr_variables(config.detection_checkpoint)
    if config.recognition_checkpoint is not None:
        rec_vars = _load_ocr_variables(config.recognition_checkpoint)
    return DocumentExtractor(
        detector=TextDetector(variables=det_vars, device=dev),
        recognizer=TextRecognizer(variables=rec_vars, device=dev),
        pdf_dpi=config.pdf_dpi,
        device=dev,
    )


def _load_ocr_variables(path: Path) -> dict:
    """A Flax variables tree from a ``.npz`` variable file: the shipped
    weights' format, which both packages' OCR trainers write
    (``train/ocr.py``). The JAX package's loader reads Orbax checkpoint
    directories, which no OCR trainer writes; reading them needs
    tensorstore (ROADMAP.md, Queue 1: reading JAX Orbax checkpoint
    directories), so they raise."""
    path = Path(path)
    if path.is_file() and path.suffix == ".npz":
        from spine_vision_torch.models.convert import load_variables_npz

        return load_variables_npz(path)
    raise NotImplementedError(
        f"{path}: OCR checkpoints are read from .npz variable files (what train_ocr_stack "
        "writes); reading JAX Orbax checkpoint directories is ROADMAP.md Queue 1's "
        "'reading JAX Orbax checkpoint directories'"
    )
