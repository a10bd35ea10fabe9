"""DICOM series writer (Explicit VR Little Endian).

Counterpart of ``spine_vision_tpu/io/dicom_write.py``: one single-frame MR
file per z slice, with the geometry tags ``read_dicom_series`` reassembles
the volume from (SeriesInstanceUID, ImagePositionPatient along the slice
normal, ImageOrientationPatient, PixelSpacing). ``jpeg_lossless=True``
writes each frame encapsulated as JPEG Lossless SV1 (transfer syntax
1.2.840.10008.1.2.4.70, ``io/jpeg_lossless.py``'s encoder), which the JAX
package's writer does not offer.
"""

from __future__ import annotations

import struct
import uuid
from pathlib import Path

import numpy as np

from spine_vision_torch.io.jpeg_lossless import encode_jpeg_lossless
from spine_vision_torch.io.types import MedicalImage

SOP_CLASS_MR = "1.2.840.10008.5.1.4.1.1.4"  # MR Image Storage
TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
TS_JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"


def _new_uid() -> str:
    """UUID-derived UID under the standard 2.25 OID arc (PS3.5 B.2)."""
    return f"2.25.{uuid.uuid4().int}"


def _even(value: bytes, pad: bytes) -> bytes:
    return value if len(value) % 2 == 0 else value + pad


def _element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    """One Explicit-VR-LE data element."""
    if vr in (b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"):
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def _ui(group: int, elem: int, value: str) -> bytes:
    return _element(group, elem, b"UI", _even(value.encode("ascii"), b"\x00"))


def _str(group: int, elem: int, vr: bytes, value: str) -> bytes:
    return _element(group, elem, vr, _even(value.encode("ascii"), b" "))


def _ds(group: int, elem: int, values) -> bytes:
    text = "\\".join(f"{float(v):.10g}" for v in np.atleast_1d(values))
    return _str(group, elem, b"DS", text)


def _us(group: int, elem: int, value: int) -> bytes:
    return _element(group, elem, b"US", struct.pack("<H", value))


def _file_meta(sop_instance_uid: str, transfer_syntax: str) -> bytes:
    body = (
        _element(0x0002, 0x0001, b"OB", b"\x00\x01")
        + _ui(0x0002, 0x0002, SOP_CLASS_MR)
        + _ui(0x0002, 0x0003, sop_instance_uid)
        + _ui(0x0002, 0x0010, transfer_syntax)
        + _ui(0x0002, 0x0012, "2.25.473824392837420387462")
    )
    group_len = _element(0x0002, 0x0000, b"UL", struct.pack("<I", len(body)))
    return b"\x00" * 128 + b"DICM" + group_len + body


def _pixel_data(pixels: np.ndarray, jpeg_lossless: bool) -> bytes:
    """The PixelData element: native OW, or an encapsulated JPEG Lossless
    SV1 frame (undefined length, an empty offset table, one fragment)."""
    if not jpeg_lossless:
        return _element(0x7FE0, 0x0010, b"OW", pixels.tobytes())
    frame = _even(encode_jpeg_lossless(pixels.view(np.uint16), psv=1), b"\x00")
    items = (
        struct.pack("<HHI", 0xFFFE, 0xE000, 0)
        + struct.pack("<HHI", 0xFFFE, 0xE000, len(frame))
        + frame
        + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    )
    return struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF) + items


def write_dicom_series(
    image: MedicalImage,
    output_dir: Path,
    modality: str = "MR",
    jpeg_lossless: bool = False,
) -> list[Path]:
    """Write one .dcm per z slice; returns the written paths.

    Pixel data is cast to int16 (PixelRepresentation 1) for signed inputs
    and uint16 (0) otherwise; floats are rejected (DICOM MR pixel modules
    are integer — rescale first). With ``jpeg_lossless``, each frame is one
    JPEG Lossless SV1 fragment (16-bit precision, the stored bits as
    unsigned) after an empty Basic Offset Table.
    """
    arr = image.array
    if arr.ndim == 2:
        arr = arr[None]
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"DICOM write requires an integer array, got {arr.dtype}")
    signed = np.issubdtype(arr.dtype, np.signedinteger)
    arr = arr.astype(np.int16 if signed else np.uint16)

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    direction = np.asarray(image.direction, dtype=np.float64).reshape(3, 3)
    row_dir, col_dir, normal = direction[:, 0], direction[:, 1], direction[:, 2]
    sx, sy, sz = (tuple(image.spacing) + (1.0, 1.0, 1.0))[:3]
    origin = np.asarray(
        (tuple(image.origin) + (0.0, 0.0, 0.0))[:3], dtype=np.float64
    )

    study_uid = _new_uid()
    series_uid = _new_uid()
    n, rows, cols = arr.shape
    paths: list[Path] = []
    for k in range(n):
        sop_uid = _new_uid()
        position = origin + k * sz * normal
        pixels = np.ascontiguousarray(arr[k]).astype("<i2" if signed else "<u2")
        body = (
            _ui(0x0008, 0x0016, SOP_CLASS_MR)
            + _ui(0x0008, 0x0018, sop_uid)
            + _str(0x0008, 0x0060, b"CS", modality)
            + _str(0x0018, 0x0050, b"DS", f"{sz:.10g}")
            + _ui(0x0020, 0x000D, study_uid)
            + _ui(0x0020, 0x000E, series_uid)
            + _str(0x0020, 0x0013, b"IS", str(k + 1))
            + _ds(0x0020, 0x0032, position)
            + _ds(0x0020, 0x0037, np.concatenate([row_dir, col_dir]))
            + _us(0x0028, 0x0002, 1)
            + _str(0x0028, 0x0004, b"CS", "MONOCHROME2")
            + _us(0x0028, 0x0010, rows)
            + _us(0x0028, 0x0011, cols)
            + _ds(0x0028, 0x0030, (sy, sx))  # (row, col) spacing
            + _us(0x0028, 0x0100, 16)
            + _us(0x0028, 0x0101, 16)
            + _us(0x0028, 0x0102, 15)
            + _us(0x0028, 0x0103, 1 if signed else 0)
            + _pixel_data(pixels, jpeg_lossless)
        )
        path = output_dir / f"slice_{k + 1:04d}.dcm"
        ts = TS_JPEG_LOSSLESS_SV1 if jpeg_lossless else TS_EXPLICIT_LE
        path.write_bytes(_file_meta(sop_uid, ts) + body)
        paths.append(path)
    return paths
