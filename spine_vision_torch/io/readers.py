"""Medical image reading with automatic format detection.

Counterpart of ``spine_vision_tpu/io/readers.py``: a directory is a DICOM
series, and ``.dcm``, ``.nii``/``.nii.gz``, ``.mha``/``.mhd`` and ``.nrrd``
files go to this package's own decoders.
"""

from __future__ import annotations

from enum import Enum, auto
from pathlib import Path

from spine_vision_torch.core.logging import logger
from spine_vision_torch.io.dicom import read_dicom_file, read_dicom_series
from spine_vision_torch.io.metaimage import read_metaimage
from spine_vision_torch.io.nifti import read_nifti
from spine_vision_torch.io.nrrd import read_nrrd
from spine_vision_torch.io.types import MedicalImage


class ImageFormat(Enum):
    """Supported medical image formats."""

    DICOM = auto()
    DICOM_FILE = auto()
    NIFTI = auto()
    MHA = auto()
    MHD = auto()
    NRRD = auto()
    UNKNOWN = auto()


EXTENSION_MAP: dict[str, ImageFormat] = {
    ".nii": ImageFormat.NIFTI,
    ".nii.gz": ImageFormat.NIFTI,
    ".mha": ImageFormat.MHA,
    ".mhd": ImageFormat.MHD,
    ".nrrd": ImageFormat.NRRD,
    ".dcm": ImageFormat.DICOM_FILE,
}


def detect_format(path: Path) -> ImageFormat:
    """Detect medical image format from path (dir => DICOM series)."""
    if path.is_dir():
        return ImageFormat.DICOM
    name = path.name.lower()
    if name.endswith(".nii.gz"):
        return ImageFormat.NIFTI
    return EXTENSION_MAP.get(path.suffix.lower(), ImageFormat.UNKNOWN)


def read_medical_image(path: Path) -> MedicalImage:
    """Read a medical image with automatic format detection.

    Supports DICOM directories/files, NIfTI (.nii/.nii.gz), MHA/MHD, NRRD.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Path does not exist: {path}")

    format_type = detect_format(path)
    logger.debug("Detected format: %s", format_type.name)

    if format_type == ImageFormat.DICOM:
        return read_dicom_series(path)
    if format_type == ImageFormat.DICOM_FILE:
        return read_dicom_file(path)
    if format_type == ImageFormat.NIFTI:
        return read_nifti(path)
    if format_type in (ImageFormat.MHA, ImageFormat.MHD):
        return read_metaimage(path)
    if format_type == ImageFormat.NRRD:
        return read_nrrd(path)
    raise ValueError(f"Unsupported format for path: {path}")
