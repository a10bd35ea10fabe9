"""MetaImage (.mha/.mhd) reader/writer.

Copied from ``spine_vision_tpu/io/metaimage.py``. MetaImage is an ASCII
``key = value`` header, then raw (optionally zlib-compressed) voxel data
either inline (.mha, ``ElementDataFile = LOCAL``) or in a companion file
(.mhd). ``TransformMatrix`` holds index axis k's direction cosines as its
k-th row; ITK's direction columns are the index-axis directions.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from spine_vision_torch.io.types import MedicalImage

_MET_TO_DTYPE = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {np.dtype(v): k for k, v in _MET_TO_DTYPE.items()}


def read_metaimage(path: Path) -> MedicalImage:
    """Read a .mha (inline) or .mhd (+ companion data) file."""
    path = Path(path)
    raw = path.read_bytes()

    # Parse header lines until ElementDataFile.
    header: dict[str, str] = {}
    pos = 0
    while True:
        eol = raw.find(b"\n", pos)
        if eol < 0:
            raise ValueError(f"Malformed MetaImage header: {path}")
        line = raw[pos:eol].decode("ascii", errors="replace").strip()
        pos = eol + 1
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"Malformed MetaImage header line: {line}")
        key, value = (part.strip() for part in line.split("=", 1))
        header[key] = value
        if key == "ElementDataFile":
            break

    ndims = int(header.get("NDims", 3))
    dim_size = [int(v) for v in header["DimSize"].split()]
    spacing = [
        float(v)
        for v in header.get(
            "ElementSpacing", header.get("ElementSize", "1 1 1")
        ).split()
    ]
    offset = [float(v) for v in header.get("Offset", "0 0 0").split()]
    met_type = header.get("ElementType", "MET_SHORT")
    if met_type not in _MET_TO_DTYPE:
        raise ValueError(f"Unsupported ElementType: {met_type}")
    dtype = np.dtype(_MET_TO_DTYPE[met_type])
    byte_order_msb = header.get(
        "ElementByteOrderMSB", header.get("BinaryDataByteOrderMSB", "False")
    )
    if byte_order_msb.lower() == "true":
        dtype = dtype.newbyteorder(">")
    compressed = header.get("CompressedData", "False").lower() == "true"

    matrix_values = header.get("TransformMatrix")
    if matrix_values:
        vals = [float(v) for v in matrix_values.split()]
        # MetaImage stores the direction cosines of index axis k as the k-th
        # ROW; ITK direction columns are index-axis directions.
        direction = np.asarray(vals).reshape(ndims, ndims).T
    else:
        direction = np.eye(ndims)

    data_file = header["ElementDataFile"]
    if data_file == "LOCAL":
        payload = raw[pos:]
    else:
        payload = (path.parent / data_file).read_bytes()
    if compressed:
        payload = zlib.decompress(payload)

    count = int(np.prod(dim_size))
    arr = np.frombuffer(payload, dtype=dtype, count=count)
    arr = arr.reshape(dim_size[::-1]).astype(dtype.newbyteorder("="))

    if ndims == 2:
        direction3 = np.eye(3)
        direction3[:2, :2] = direction
        return MedicalImage(
            array=arr,
            spacing=(spacing[0], spacing[1]),
            origin=(offset[0], offset[1]),
            direction=direction3,
            metadata={"path": str(path), "format": "metaimage"},
        )

    return MedicalImage(
        array=arr,
        spacing=tuple(spacing[:3]),
        origin=tuple(offset[:3]),
        direction=direction,
        metadata={"path": str(path), "format": "metaimage"},
    )


def write_metaimage(
    image: MedicalImage, path: Path, use_compression: bool = True
) -> None:
    """Write a .mha (inline data) or .mhd (+ .raw companion) file."""
    path = Path(path)
    arr = np.ascontiguousarray(image.array)
    met_type = _DTYPE_TO_MET.get(arr.dtype)
    if met_type is None:
        arr = arr.astype(np.float32)
        met_type = "MET_FLOAT"

    dim_size = " ".join(str(s) for s in arr.shape[::-1])
    spacing = " ".join(f"{s:g}" for s in image.spacing)
    offset = " ".join(f"{o:g}" for o in image.origin)
    matrix = " ".join(f"{v:g}" for v in image.direction.T.reshape(-1))

    payload = arr.tobytes()
    if use_compression:
        payload = zlib.compress(payload)

    is_mhd = path.suffix.lower() == ".mhd"
    data_file = path.with_suffix(".raw").name if is_mhd else "LOCAL"

    lines = [
        "ObjectType = Image",
        f"NDims = {arr.ndim}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if use_compression else 'False'}",
    ]
    if use_compression:
        lines.append(f"CompressedDataSize = {len(payload)}")
    lines += [
        f"TransformMatrix = {matrix}",
        f"Offset = {offset}",
        f"ElementSpacing = {spacing}",
        f"DimSize = {dim_size}",
        f"ElementType = {met_type}",
        f"ElementDataFile = {data_file}",
    ]
    header = ("\n".join(lines) + "\n").encode("ascii")

    if is_mhd:
        path.write_bytes(header)
        path.with_suffix(".raw").write_bytes(payload)
    else:
        path.write_bytes(header + payload)
