"""DICOM file and series reader (no pydicom/GDCM).

Counterpart of ``spine_vision_tpu/io/dicom.py``: Part-10 files (with
preamble) and raw datasets; explicit and implicit VR little endian, explicit
VR big endian, deflated explicit VR, undefined-length sequences; native
pixel data, RLE lossless (PackBits), JPEG Lossless Process 14 / SV1
(transfer syntaxes .57/.70, ``io/jpeg_lossless.py``), JPEG baseline and
extended (.50/.51, ``io/jpeg.py``: the frame as Pillow decodes it, then
``convert("L")`` as the JAX package does) and JPEG 2000 (.90/.91,
``io/jpeg2000.py``: the frame as Pillow decodes it, kept in Pillow's mode as
the JAX package keeps it, so a 12-bit frame comes back as ``x << 4`` and a
signed one with ``2**(prec-1)`` added). MONOCHROME1/2, 8/16/32
bits, signed or unsigned, rescale slope and intercept, multiframe with and
without a Basic Offset Table. ``read_dicom_series`` groups files by
SeriesInstanceUID (never the empty UID's group when a real one exists) and
sorts slices along the slice normal.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Any

import numpy as np

from spine_vision_torch.core.logging import logger
from spine_vision_torch.io.jpeg import decode_jpeg, is_jpeg, to_mode
from spine_vision_torch.io.jpeg2000 import Jpeg2000Error, decode_jpeg2000, is_jpeg2000
from spine_vision_torch.io.jpeg_lossless import decode_jpeg_lossless
from spine_vision_torch.io.types import MedicalImage

# Tags we care about: (group, element)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_SOP_INSTANCE = (0x0008, 0x0018)
TAG_MODALITY = (0x0008, 0x0060)
TAG_SERIES_UID = (0x0020, 0x000E)
TAG_INSTANCE_NUMBER = (0x0020, 0x0013)
TAG_IMAGE_POSITION = (0x0020, 0x0032)
TAG_IMAGE_ORIENTATION = (0x0020, 0x0037)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_SPACING_BETWEEN = (0x0018, 0x0088)
TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
TAG_PHOTOMETRIC = (0x0028, 0x0004)
TAG_NUM_FRAMES = (0x0028, 0x0008)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_BITS_STORED = (0x0028, 0x0101)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)

# Transfer syntaxes
TS_IMPLICIT_LE = "1.2.840.10008.1.2"
TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
TS_DEFLATED_LE = "1.2.840.10008.1.2.1.99"
TS_EXPLICIT_BE = "1.2.840.10008.1.2.2"
TS_JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
TS_JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
TS_JPEG_LOSSLESS_14 = "1.2.840.10008.1.2.4.57"
TS_JPEG_LOSSLESS_14SV1 = "1.2.840.10008.1.2.4.70"
TS_JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
TS_JPEG2000 = "1.2.840.10008.1.2.4.91"
TS_RLE = "1.2.840.10008.1.2.5"

_ENCAPSULATED = {
    TS_JPEG_BASELINE,
    TS_JPEG_EXTENDED,
    TS_JPEG_LOSSLESS_14,
    TS_JPEG_LOSSLESS_14SV1,
    TS_JPEG2000_LOSSLESS,
    TS_JPEG2000,
    TS_RLE,
}

# VRs with 4-byte length (explicit VR) preceded by 2 reserved bytes.
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}

# All standard VRs (PS3.5 6.2) — used to sniff explicit VR in raw datasets.
_ALL_VRS = _LONG_VRS | {
    b"AE", b"AS", b"AT", b"CS", b"DA", b"DS", b"DT", b"FL", b"FD", b"IS",
    b"LO", b"LT", b"PN", b"SH", b"SL", b"SS", b"ST", b"SV", b"TM", b"UI",
    b"UL", b"US", b"UV",
}


class DicomError(ValueError):
    """Malformed or unsupported DICOM data."""


class _Reader:
    """Sequential little/big-endian byte reader over a buffer."""

    def __init__(self, data: bytes, little: bool = True) -> None:
        self.data = data
        self.pos = 0
        self.little = little

    @property
    def end(self) -> int:
        return len(self.data)

    def u16(self) -> int:
        fmt = "<H" if self.little else ">H"
        v = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        fmt = "<I" if self.little else ">I"
        v = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += 4
        return v

    def raw(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v

    def skip(self, n: int) -> None:
        self.pos += n


def _parse_elements(
    reader: _Reader,
    explicit: bool,
    stop_at_pixel_data: bool = False,
    wanted: set[tuple[int, int]] | None = None,
) -> dict[tuple[int, int], Any]:
    """Parse a stream of data elements into {tag: raw bytes or marker}."""
    out: dict[tuple[int, int], Any] = {}
    data_len = reader.end

    while reader.pos + 8 <= data_len:
        group = reader.u16()
        element = reader.u16()
        tag = (group, element)

        if explicit:
            vr = reader.raw(2)
            if vr in _LONG_VRS:
                reader.skip(2)
                length = reader.u32()
            else:
                length = reader.u16()
        else:
            vr = b""
            length = reader.u32()

        if tag == TAG_PIXEL_DATA:
            out["_pixel_vr"] = vr
            if length == 0xFFFFFFFF:
                out[tag] = ("encapsulated", reader.pos)
            else:
                out[tag] = reader.data[reader.pos : reader.pos + length]
            return out

        if vr == b"SQ" or length == 0xFFFFFFFF:
            # Undefined-length UN contents are ALWAYS implicit VR
            # (PS3.5 6.2.2), even inside an explicit-VR dataset.
            _skip_sequence(reader, length, explicit and vr != b"UN")
            continue

        if length > data_len - reader.pos:
            raise DicomError(f"Element {tag} length {length} exceeds file size")

        if wanted is None or tag in wanted or group == 0x0002:
            out[tag] = reader.raw(length)
        else:
            reader.skip(length)

    return out


def _skip_sequence(reader: _Reader, length: int, explicit: bool) -> None:
    """Skip a sequence (defined or undefined length)."""
    if length != 0xFFFFFFFF:
        reader.skip(length)
        return
    # Undefined length: walk items until SequenceDelimitationItem.
    while reader.pos + 8 <= reader.end:
        group = reader.u16()
        element = reader.u16()
        item_len = reader.u32()
        if (group, element) == (0xFFFE, 0xE0DD):  # sequence delimiter
            return
        if (group, element) == (0xFFFE, 0xE000):  # item
            if item_len == 0xFFFFFFFF:
                _skip_item_undefined(reader, explicit)
            else:
                reader.skip(item_len)
        else:
            raise DicomError("Malformed sequence")


def _skip_item_undefined(reader: _Reader, explicit: bool) -> None:
    """Skip an undefined-length item by recursive element scanning."""
    while reader.pos + 8 <= reader.end:
        group = reader.u16()
        element = reader.u16()
        if (group, element) == (0xFFFE, 0xE00D):  # item delimiter
            reader.u32()
            return
        if explicit:
            vr = reader.raw(2)
            if vr in _LONG_VRS:
                reader.skip(2)
                length = reader.u32()
            else:
                length = reader.u16()
        else:
            vr = b""
            length = reader.u32()
        if vr == b"SQ" or length == 0xFFFFFFFF:
            # PS3.5 6.2.2: undefined-length UN contents are implicit VR.
            _skip_sequence(reader, length, explicit and vr != b"UN")
        else:
            reader.skip(length)


def _decode_str(raw: bytes) -> str:
    return raw.decode("ascii", errors="replace").strip("\x00 ").strip()


def _decode_floats(raw: bytes) -> list[float]:
    text = _decode_str(raw)
    if not text:
        return []
    return [float(p) for p in text.split("\\") if p.strip()]


def _decode_int(raw: bytes, default: int = 0) -> int:
    """Decode an IS (Integer String) value.

    IS is ASCII text — including 2-byte values like b"1 " or b"15"
    (interpreting those as binary uint16 scrambles InstanceNumber sorting
    and NumberOfFrames). The binary fallback only fires for non-ASCII
    payloads (malformed writers that stored US binary under an IS tag).
    """
    text = _decode_str(raw)
    try:
        return int(float(text))
    except ValueError:
        if len(raw) == 2:
            return struct.unpack("<H", raw)[0]
        return default


def _decode_us(raw: bytes, little: bool) -> int:
    fmt = "<H" if little else ">H"
    return struct.unpack(fmt, raw[:2])[0]


class DicomFile:
    """A parsed DICOM dataset with decoded pixel array + geometry."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        data = self.path.read_bytes()
        self._parse(data)

    def _parse(self, data: bytes) -> None:
        # Part-10: 128-byte preamble + 'DICM'
        offset = 0
        transfer_syntax = TS_IMPLICIT_LE
        if len(data) >= 8 and data[128:132] != b"DICM":
            # Preamble-less raw dataset: sniff the VR field of the first
            # element (bytes 4-6) — two uppercase ASCII letters mean
            # explicit VR LE, otherwise implicit VR LE (the pydicom/GDCM
            # heuristic; without it explicit raw datasets mis-parse their
            # first VR bytes as part of a u32 length).
            if data[4:6] in _ALL_VRS:
                transfer_syntax = TS_EXPLICIT_LE
        if len(data) > 132 and data[128:132] == b"DICM":
            offset = 132
            # File meta group (always explicit VR LE).
            meta_reader = _Reader(data[offset:], little=True)
            # Parse just the meta group: read until group != 0x0002.
            meta: dict[tuple[int, int], Any] = {}
            while meta_reader.pos + 8 <= meta_reader.end:
                start = meta_reader.pos
                group = meta_reader.u16()
                element = meta_reader.u16()
                if group != 0x0002:
                    meta_reader.pos = start
                    break
                vr = meta_reader.raw(2)
                if vr in _LONG_VRS:
                    meta_reader.skip(2)
                    length = meta_reader.u32()
                else:
                    length = meta_reader.u16()
                meta[(group, element)] = meta_reader.raw(length)
            offset += meta_reader.pos
            if TAG_TRANSFER_SYNTAX in meta:
                transfer_syntax = _decode_str(meta[TAG_TRANSFER_SYNTAX])

        self.transfer_syntax = transfer_syntax
        body = data[offset:]
        if transfer_syntax == TS_DEFLATED_LE:
            body = zlib.decompress(body, -15)
            transfer_syntax = TS_EXPLICIT_LE

        little = transfer_syntax != TS_EXPLICIT_BE
        explicit = transfer_syntax != TS_IMPLICIT_LE
        if not explicit:
            # Implicit datasets after Part-10 meta are implicit VR LE.
            little = True

        reader = _Reader(body, little=little)
        self._little = little
        self._body = body
        self.elements = _parse_elements(reader, explicit)

    # -- attribute access ---------------------------------------------------

    def _get(self, tag: tuple[int, int]) -> bytes | None:
        v = self.elements.get(tag)
        return v if isinstance(v, bytes) else None

    @property
    def series_uid(self) -> str:
        raw = self._get(TAG_SERIES_UID)
        return _decode_str(raw) if raw else ""

    @property
    def modality(self) -> str:
        raw = self._get(TAG_MODALITY)
        return _decode_str(raw) if raw else ""

    @property
    def instance_number(self) -> int:
        raw = self._get(TAG_INSTANCE_NUMBER)
        return _decode_int(raw) if raw else 0

    @property
    def rows(self) -> int:
        raw = self._get(TAG_ROWS)
        return _decode_us(raw, self._little) if raw else 0

    @property
    def cols(self) -> int:
        raw = self._get(TAG_COLS)
        return _decode_us(raw, self._little) if raw else 0

    @property
    def bits_allocated(self) -> int:
        raw = self._get(TAG_BITS_ALLOCATED)
        return _decode_us(raw, self._little) if raw else 16

    @property
    def bits_stored(self) -> int:
        raw = self._get(TAG_BITS_STORED)
        return _decode_us(raw, self._little) if raw else self.bits_allocated

    @property
    def pixel_representation(self) -> int:
        raw = self._get(TAG_PIXEL_REPRESENTATION)
        return _decode_us(raw, self._little) if raw else 0

    @property
    def samples_per_pixel(self) -> int:
        raw = self._get(TAG_SAMPLES_PER_PIXEL)
        return _decode_us(raw, self._little) if raw else 1

    @property
    def num_frames(self) -> int:
        raw = self._get(TAG_NUM_FRAMES)
        return max(_decode_int(raw, 1), 1) if raw else 1

    @property
    def photometric(self) -> str:
        raw = self._get(TAG_PHOTOMETRIC)
        return _decode_str(raw) if raw else "MONOCHROME2"

    @property
    def pixel_spacing(self) -> tuple[float, float]:
        """(row_spacing, col_spacing) in mm."""
        raw = self._get(TAG_PIXEL_SPACING)
        vals = _decode_floats(raw) if raw else []
        if len(vals) >= 2:
            return (vals[0], vals[1])
        return (1.0, 1.0)

    @property
    def image_position(self) -> np.ndarray | None:
        raw = self._get(TAG_IMAGE_POSITION)
        vals = _decode_floats(raw) if raw else []
        return np.asarray(vals[:3]) if len(vals) >= 3 else None

    @property
    def image_orientation(self) -> np.ndarray | None:
        raw = self._get(TAG_IMAGE_ORIENTATION)
        vals = _decode_floats(raw) if raw else []
        return np.asarray(vals[:6]) if len(vals) >= 6 else None

    @property
    def slice_spacing_hint(self) -> float:
        for tag in (TAG_SPACING_BETWEEN, TAG_SLICE_THICKNESS):
            raw = self._get(tag)
            if raw:
                vals = _decode_floats(raw)
                if vals and vals[0] > 0:
                    return vals[0]
        return 1.0

    @property
    def rescale(self) -> tuple[float, float]:
        slope_raw = self._get(TAG_RESCALE_SLOPE)
        inter_raw = self._get(TAG_RESCALE_INTERCEPT)
        slope = _decode_floats(slope_raw)[0] if slope_raw else 1.0
        intercept = _decode_floats(inter_raw)[0] if inter_raw else 0.0
        return (slope, intercept)

    # -- pixel decode -------------------------------------------------------

    def pixel_array(self) -> np.ndarray:
        """Decode pixel data to [frames, rows, cols] (or [rows, cols])."""
        payload = self.elements.get(TAG_PIXEL_DATA)
        if payload is None:
            raise DicomError(f"No pixel data: {self.path}")

        rows, cols = self.rows, self.cols
        frames = self.num_frames
        if isinstance(payload, tuple):  # encapsulated
            arr = self._decode_encapsulated(payload[1], rows, cols, frames)
        else:
            arr = self._decode_native(payload, rows, cols, frames)

        if self.photometric == "MONOCHROME1":
            # Invert STORED values against the fixed stored-range maximum:
            # a per-slice data maximum would make identical tissue invert to
            # different values across a series (banding), and inverting
            # after rescale would flip calibrated units. (GDCM/SimpleITK do
            # not invert at all; the fixed-reference inversion keeps
            # "bright = high signal" without the per-slice inconsistency.)
            # Signed stored values (pixel_representation == 1) span
            # [-2^(b-1), 2^(b-1)-1]; invert against the SIGNED maximum so the
            # inverted values stay inside the stored range instead of being
            # pushed up by the unsigned top.
            if self.pixel_representation == 1:
                top = 2 ** (self.bits_stored - 1) - 1
            else:
                top = 2 ** self.bits_stored - 1
            if np.issubdtype(arr.dtype, np.integer):
                arr = top - arr.astype(np.int32)  # avoid int16 wraparound
            else:
                arr = top - arr
        slope, intercept = self.rescale
        if slope != 1.0 or intercept != 0.0:
            arr = arr.astype(np.float32) * slope + intercept
        return arr[0] if frames == 1 and arr.ndim == 3 else arr

    def _decode_native(
        self, payload: bytes, rows: int, cols: int, frames: int
    ) -> np.ndarray:
        bits = self.bits_allocated
        signed = self.pixel_representation == 1
        spp = self.samples_per_pixel
        if bits == 8:
            dtype = np.int8 if signed else np.uint8
        elif bits == 16:
            dtype = np.dtype(np.int16 if signed else np.uint16)
            dtype = dtype.newbyteorder("<" if self._little else ">")
        elif bits == 32:
            dtype = np.dtype(np.int32 if signed else np.uint32)
            dtype = dtype.newbyteorder("<" if self._little else ">")
        else:
            raise DicomError(f"Unsupported BitsAllocated: {bits}")

        count = rows * cols * frames * spp
        needed = count * np.dtype(dtype).itemsize
        if len(payload) < needed:
            raise DicomError(
                f"PixelData truncated: {len(payload)} bytes < {needed} expected"
            )
        arr = np.frombuffer(payload, dtype=dtype, count=count)
        if spp == 1:
            return arr.reshape(frames, rows, cols).astype(arr.dtype.newbyteorder("="))
        # Color: convert to grayscale (medical sagittal series are mono; this
        # is a fallback for secondary captures).
        arr = arr.reshape(frames, rows, cols, spp).astype(np.float32)
        return arr.mean(axis=-1)

    def _decode_encapsulated(
        self, start: int, rows: int, cols: int, frames: int
    ) -> np.ndarray:
        """Decode encapsulated (fragmented) pixel data.

        The first item is ALWAYS the Basic Offset Table (possibly empty);
        a frame may span several fragments, so fragments are grouped into
        per-frame byte streams — by count when 1:1, by concatenation for
        single-frame data, or via the BOT offsets otherwise.
        """
        reader = _Reader(self._body, little=True)
        reader.pos = start
        fragments: list[bytes] = []
        offsets: list[int] = []  # item-header offset of each data fragment
        first_data_pos: int | None = None
        item_index = 0
        while reader.pos + 8 <= reader.end:
            item_pos = reader.pos
            group = reader.u16()
            element = reader.u16()
            length = reader.u32()
            if (group, element) == (0xFFFE, 0xE0DD):
                break
            if (group, element) != (0xFFFE, 0xE000):
                raise DicomError("Malformed encapsulated pixel data")
            payload = reader.raw(length)
            if item_index == 0:
                bot = payload  # Basic Offset Table (possibly empty)
                first_data_pos = reader.pos
            else:
                fragments.append(payload)
                assert first_data_pos is not None
                offsets.append(item_pos - first_data_pos)
            item_index += 1
        if not fragments:
            raise DicomError("No pixel fragments")

        # Group fragments into one byte stream per frame.
        if len(fragments) == frames:
            streams = fragments
        elif frames == 1:
            streams = [b"".join(fragments)]
        elif len(bot) >= 4 * frames:
            frame_starts = [
                struct.unpack_from("<I", bot, 4 * i)[0] for i in range(frames)
            ]
            streams = []
            for fi, frame_start in enumerate(frame_starts):
                stop = (
                    frame_starts[fi + 1]
                    if fi + 1 < frames
                    else offsets[-1] + 1
                )
                parts = [
                    frag
                    for frag, off in zip(fragments, offsets)
                    if frame_start <= off < stop or (fi == frames - 1 and off >= frame_start)
                ]
                streams.append(b"".join(parts))
        else:
            raise DicomError(
                f"Cannot group {len(fragments)} fragments into {frames} frames "
                "(no Basic Offset Table)"
            )

        ts = self.transfer_syntax
        if ts == TS_RLE:
            signed = self.pixel_representation == 1
            slices = [
                _decode_rle_frame(frag, rows, cols, self.bits_allocated, signed)
                for frag in streams
            ]
            return np.stack(slices)

        if ts in (TS_JPEG_LOSSLESS_14, TS_JPEG_LOSSLESS_14SV1):
            signed = self.pixel_representation == 1
            slices = []
            for frag in streams:
                arr = decode_jpeg_lossless(frag)
                if arr.ndim == 3:  # color fallback, matches _decode_native
                    arr = arr.astype(np.float32).mean(axis=-1)
                if signed:
                    # Reinterpret at the STORED width: viewing 8-bit data
                    # as int16 would keep 128..255 positive.
                    if self.bits_allocated == 8:
                        arr = arr.astype(np.uint8).view(np.int8)
                    else:
                        arr = arr.astype(np.uint16).view(np.int16)
                elif self.bits_allocated == 8:
                    arr = arr.astype(np.uint8)
                slices.append(arr)
            return np.stack(slices)

        if ts in (TS_JPEG_BASELINE, TS_JPEG_EXTENDED):
            # Pillow's mode of a baseline frame is L or RGB, and the JAX
            # package converts both to L.
            return np.stack([to_mode(decode_jpeg(frag), "L") for frag in streams])

        if ts in (TS_JPEG2000, TS_JPEG2000_LOSSLESS):
            # Pillow opens each frame by its content and the JAX package keeps
            # its mode: I;16 above 8 bits, L, LA, RGB or RGBA.
            return np.stack([_decode_pil_frame(frag) for frag in streams])

        raise DicomError(f"Unsupported transfer syntax: {ts}")


def _decode_pil_frame(frag: bytes) -> np.ndarray:
    """``np.asarray(Image.open(frag))`` of a JPEG 2000 or JPEG frame."""
    if is_jpeg2000(frag):
        return decode_jpeg2000(frag)
    if is_jpeg(frag):
        return decode_jpeg(frag)
    raise Jpeg2000Error("cannot identify the image in a JPEG 2000 frame")


def _decode_rle_frame(
    data: bytes, rows: int, cols: int, bits: int, signed: bool = False
) -> np.ndarray:
    """Decode one DICOM RLE (PackBits) frame.

    Handles 8-bit mono, 16-bit mono (MSB+LSB segments, signed per
    PixelRepresentation), and multi-sample data (e.g. RGB = 3 segments,
    averaged to grayscale matching _decode_native's color fallback).
    """
    if len(data) < 64:
        raise DicomError(
            f"RLE frame shorter than its 64-byte header ({len(data)} bytes)"
        )
    n_segments = struct.unpack_from("<I", data, 0)[0]
    if not 1 <= n_segments <= 15:
        raise DicomError(f"RLE: invalid segment count {n_segments}")
    offsets = [struct.unpack_from("<I", data, 4 + 4 * i)[0] for i in range(15)]
    segments: list[np.ndarray] = []
    for i in range(n_segments):
        start = offsets[i]
        end = offsets[i + 1] if i + 1 < n_segments and offsets[i + 1] > 0 else len(data)
        segments.append(_packbits(data[start:end], rows * cols))

    if bits == 16:
        if n_segments % 2 != 0:
            raise DicomError(f"RLE: expected MSB/LSB segment pairs, got {n_segments}")
        planes = []
        for s in range(0, n_segments, 2):
            combined = (
                segments[s].astype(np.uint16) << 8
                | segments[s + 1].astype(np.uint16)
            )
            if signed:
                combined = combined.view(np.int16)
            planes.append(combined.reshape(rows, cols))
    else:
        planes = [
            (seg.view(np.int8) if signed else seg).reshape(rows, cols)
            for seg in segments
        ]
    if len(planes) == 1:
        return planes[0]
    return np.stack(planes, axis=-1).astype(np.float32).mean(axis=-1)


def _packbits(data: bytes, expected: int) -> np.ndarray:
    """PackBits decompression."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        header = data[i]
        i += 1
        if header < 128:
            count = header + 1
            out.extend(data[i : i + count])
            i += count
        elif header > 128:
            count = 257 - header
            if i < n:
                out.extend(bytes([data[i]]) * count)
                i += 1
    return np.frombuffer(bytes(out[:expected]), dtype=np.uint8)


# ---------------------------------------------------------------------------
# Series assembly
# ---------------------------------------------------------------------------


def read_dicom_file(path: Path) -> MedicalImage:
    """Read a single DICOM file as a (possibly multiframe) image."""
    dcm = DicomFile(path)
    arr = dcm.pixel_array()
    row_sp, col_sp = dcm.pixel_spacing
    iop = dcm.image_orientation
    direction = np.eye(3)
    if iop is not None:
        row_dir = iop[:3]  # direction along increasing column index (x)
        col_dir = iop[3:]  # direction along increasing row index (y)
        normal = np.cross(row_dir, col_dir)
        direction = np.stack([row_dir, col_dir, normal], axis=1)
    origin = dcm.image_position
    meta = {"modality": dcm.modality, "path": str(path)}
    return MedicalImage(
        array=arr,
        spacing=(col_sp, row_sp, dcm.slice_spacing_hint),
        origin=tuple(origin) if origin is not None else (0.0, 0.0, 0.0),
        direction=direction,
        metadata=meta,
    )


def read_dicom_series(folder: Path) -> MedicalImage:
    """Assemble a 3D volume from a directory of DICOM slices.

    As sitk.ImageSeriesReader with GDCM does it:
    groups by SeriesInstanceUID (first series wins), sorts slices by position
    along the slice normal, derives z spacing from adjacent positions.
    """
    folder = Path(folder)
    files: list[DicomFile] = []
    for path in sorted(folder.iterdir()):
        if not path.is_file():
            continue
        try:
            files.append(DicomFile(path))
        except (DicomError, struct.error, ValueError) as exc:
            logger.debug("Skipping non-DICOM file %s: %s", path, exc)

    if not files:
        raise ValueError(f"No DICOM series found in {folder}")

    # Group by series UID; take the first (parity: GetGDCMSeriesIDs[0]).
    # Files without a SeriesInstanceUID (DICOMDIR, structured reports) group
    # under "" which sorts before every real UID — never let that garbage
    # group shadow a real series.
    series: dict[str, list[DicomFile]] = {}
    for f in files:
        series.setdefault(f.series_uid, []).append(f)
    real_uids = sorted(uid for uid in series if uid)
    first_uid = real_uids[0] if real_uids else sorted(series.keys())[0]
    slices = series[first_uid]

    iop = next((s.image_orientation for s in slices if s.image_orientation is not None), None)
    if iop is not None:
        row_dir = iop[:3]
        col_dir = iop[3:]
        normal = np.cross(row_dir, col_dir)
    else:
        row_dir = np.array([1.0, 0.0, 0.0])
        col_dir = np.array([0.0, 1.0, 0.0])
        normal = np.array([0.0, 0.0, 1.0])

    # Sort in ONE unit system: position projections (mm) only when every
    # slice carries ImagePositionPatient — a lone missing-IPP slice keyed by
    # its InstanceNumber would land at an arbitrary z and corrupt both the
    # order and the median z-spacing.
    all_positioned = all(s.image_position is not None for s in slices)

    def sort_key(s: DicomFile) -> float:
        if all_positioned:
            return float(np.dot(s.image_position, normal))
        return float(s.instance_number)

    slices.sort(key=sort_key)

    # Multiframe files contribute ALL their frames (stacked along z in file
    # order); classic single-frame files contribute one slice each.
    planes: list[np.ndarray] = []
    for s in slices:
        arr = s.pixel_array()
        if arr.ndim == 2:
            planes.append(arr)
        else:
            planes.extend(arr)
    volume = np.stack(planes)

    row_sp, col_sp = slices[0].pixel_spacing
    if len(slices) > 1 and all_positioned:
        zs = [sort_key(s) for s in slices]
        diffs = np.diff(zs)
        z_sp = float(np.median(np.abs(diffs))) if len(diffs) else 1.0
        if z_sp <= 0:
            z_sp = slices[0].slice_spacing_hint
    else:
        z_sp = slices[0].slice_spacing_hint

    origin = slices[0].image_position
    direction = np.stack([row_dir, col_dir, normal], axis=1)

    return MedicalImage(
        array=volume,
        spacing=(col_sp, row_sp, z_sp),
        origin=tuple(origin) if origin is not None else (0.0, 0.0, 0.0),
        direction=direction,
        metadata={
            "modality": slices[0].modality,
            "series_uid": first_uid,
            "num_slices": len(slices),
            "path": str(folder),
        },
    )
