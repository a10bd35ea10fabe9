"""NRRD reader/writer.

Copied from ``spine_vision_tpu/io/nrrd.py``. NRRD: magic ``NRRD000X``, an
ASCII ``key: value`` header, a blank line, then raw, gzip or zlib data.
Geometry from "space directions" (per-axis physical vectors, fastest axis
first, ``none`` for non-spatial axes) and "space origin", in the file's
declared space, converted to LPS.
"""

from __future__ import annotations

import gzip
import re
import zlib
from pathlib import Path

import numpy as np

from spine_vision_torch.io.types import MedicalImage

_NRRD_TYPES = {
    "signed char": np.int8,
    "int8": np.int8,
    "uchar": np.uint8,
    "unsigned char": np.uint8,
    "uint8": np.uint8,
    "short": np.int16,
    "int16": np.int16,
    "ushort": np.uint16,
    "unsigned short": np.uint16,
    "uint16": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
    "uint32": np.uint32,
    "long long": np.int64,
    "int64": np.int64,
    "float": np.float32,
    "double": np.float64,
}

# Space name -> per-axis sign flips to convert into LPS.
_SPACE_TO_LPS_FLIPS = {
    "left-posterior-superior": (1, 1, 1),
    "lps": (1, 1, 1),
    "right-anterior-superior": (-1, -1, 1),
    "ras": (-1, -1, 1),
    "left-anterior-superior": (1, -1, 1),
    "las": (1, -1, 1),
}


def read_nrrd(path: Path) -> MedicalImage:
    """Read a .nrrd file."""
    path = Path(path)
    raw = path.read_bytes()
    if not raw.startswith(b"NRRD"):
        raise ValueError(f"Not a NRRD file: {path}")

    # Header: lines until the first blank line.
    end = raw.find(b"\n\n")
    end_len = 2
    if end < 0:
        end = raw.find(b"\r\n\r\n")
        end_len = 4
    if end < 0:
        raise ValueError(f"Malformed NRRD header: {path}")

    header: dict[str, str] = {}
    for line in raw[:end].decode("ascii", errors="replace").splitlines()[1:]:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if ":=" in line:
            key, value = line.split(":=", 1)
        elif ":" in line:
            key, value = line.split(":", 1)
        else:
            continue
        header[key.strip().lower()] = value.strip()

    sizes = [int(v) for v in header["sizes"].split()]
    dtype_name = header.get("type", "short")
    if dtype_name not in _NRRD_TYPES:
        raise ValueError(f"Unsupported NRRD type: {dtype_name}")
    dtype = np.dtype(_NRRD_TYPES[dtype_name])
    endianness = header.get("endian", "little")
    if dtype.itemsize > 1:
        dtype = dtype.newbyteorder("<" if endianness == "little" else ">")
    encoding = header.get("encoding", "raw")

    payload = raw[end + end_len :]
    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding in ("zlib",):
        payload = zlib.decompress(payload)
    elif encoding not in ("raw",):
        raise ValueError(f"Unsupported NRRD encoding: {encoding}")

    count = int(np.prod(sizes))
    arr = np.frombuffer(payload, dtype=dtype, count=count)
    arr = arr.reshape(sizes[::-1]).astype(dtype.newbyteorder("="))

    ndims = len(sizes)
    space = header.get("space", "left-posterior-superior").lower()
    flips = np.asarray(_SPACE_TO_LPS_FLIPS.get(space, (1, 1, 1)), dtype=np.float64)

    spacing = [1.0] * ndims
    direction = np.eye(3)
    if "space directions" in header:
        # Tokens are either "none" (non-spatial axis, e.g. vector/list axes
        # of segmentations) or "(a,b,c)" — a plain ") "-split breaks when
        # "none" precedes a vector.
        vectors = []
        for token in re.findall(r"none|\([^)]*\)", header["space directions"]):
            if token == "none":
                vectors.append(None)
                continue
            vectors.append(
                np.asarray([float(v) for v in token.strip("()").split(",")])
            )
        spatial = [v for v in vectors if v is not None]
        for axis, vec in enumerate(spatial[:3]):
            vec = vec * flips[: len(vec)]
            norm = float(np.linalg.norm(vec))
            spacing[axis] = norm if norm > 0 else 1.0
            direction[: len(vec), axis] = vec / (norm if norm > 0 else 1.0)
    elif "spacings" in header:
        spacing = [
            float(v) if v != "nan" else 1.0 for v in header["spacings"].split()
        ]

    origin = (0.0, 0.0, 0.0)
    if "space origin" in header:
        token = header["space origin"].strip().strip("()")
        vals = np.asarray([float(v) for v in token.split(",")])
        vals = vals * flips[: len(vals)]
        origin = tuple(float(v) for v in vals[:3])

    if ndims == 2:
        return MedicalImage(
            array=arr,
            spacing=(spacing[0], spacing[1]),
            origin=origin[:2],
            direction=direction,
            metadata={"path": str(path), "format": "nrrd"},
        )
    return MedicalImage(
        array=arr,
        spacing=tuple(spacing[:3]),
        origin=origin,
        direction=direction,
        metadata={"path": str(path), "format": "nrrd"},
    )


def write_nrrd(image: MedicalImage, path: Path, use_compression: bool = True) -> None:
    """Write a .nrrd file (gzip-encoded by default), LPS space."""
    path = Path(path)
    arr = np.ascontiguousarray(image.array)
    type_name = {
        np.dtype(np.int8): "int8",
        np.dtype(np.uint8): "uint8",
        np.dtype(np.int16): "short",
        np.dtype(np.uint16): "ushort",
        np.dtype(np.int32): "int",
        np.dtype(np.uint32): "uint",
        np.dtype(np.float32): "float",
        np.dtype(np.float64): "double",
    }.get(arr.dtype)
    if type_name is None:
        arr = arr.astype(np.float32)
        type_name = "float"

    ndims = arr.ndim
    directions = []
    for axis in range(ndims):
        vec = image.direction[:, axis] * image.spacing[axis]
        directions.append("(" + ",".join(f"{v:g}" for v in vec[:3]) + ")")
    origin = "(" + ",".join(f"{v:g}" for v in image.origin[:3]) + ")"

    lines = [
        "NRRD0004",
        f"type: {type_name}",
        f"dimension: {ndims}",
        "space: left-posterior-superior",
        f"sizes: {' '.join(str(s) for s in arr.shape[::-1])}",
        f"space directions: {' '.join(directions)}",
        "kinds: " + " ".join(["domain"] * ndims),
        "endian: little",
        f"encoding: {'gzip' if use_compression else 'raw'}",
        f"space origin: {origin}",
    ]
    header = ("\n".join(lines) + "\n\n").encode("ascii")
    payload = arr.tobytes()
    if use_compression:
        payload = gzip.compress(payload)
    path.write_bytes(header + payload)
