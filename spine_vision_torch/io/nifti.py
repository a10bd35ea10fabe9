"""NIfTI-1 reader/writer (no nibabel).

Copied from ``spine_vision_tpu/io/nifti.py``; reads ``.nii`` and ``.nii.gz``
as ``sitk.ReadImage`` does. Geometry: the NIfTI affine (srow, else the qform
quaternion, else pixdim) maps voxel indices to RAS+ physical space; ITK works
in LPS, so the first two physical axes are negated. ``scl_slope == 0``
disables scaling (the intercept too), and a NaN slope or intercept counts as
none.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

from spine_vision_torch.io.types import MedicalImage

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}


def _read_bytes(path: Path) -> bytes:
    data = path.read_bytes()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return data


def read_nifti(path: Path) -> MedicalImage:
    """Read a .nii or .nii.gz file."""
    path = Path(path)
    data = _read_bytes(path)
    if len(data) < 352:
        raise ValueError(f"Truncated NIfTI file: {path}")

    sizeof_hdr = struct.unpack_from("<i", data, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack_from(">i", data, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError(f"Not a NIfTI-1 file: {path}")
        endian = ">"

    dim = struct.unpack_from(f"{endian}8h", data, 40)
    ndim = dim[0]
    shape_xyz = [max(d, 1) for d in dim[1 : 1 + max(ndim, 3)]][:3]
    if ndim > 3 and any(d > 1 for d in dim[4 : 1 + ndim]):
        from spine_vision_torch.core.logging import logger

        logger.warning(
            "NIfTI file %s has %d dimensions; reading only the first "
            "3-D volume",
            path,
            ndim,
        )
    datatype = struct.unpack_from(f"{endian}h", data, 70)[0]
    pixdim = struct.unpack_from(f"{endian}8f", data, 76)
    vox_offset = int(struct.unpack_from(f"{endian}f", data, 108)[0])
    scl_slope = struct.unpack_from(f"{endian}f", data, 112)[0]
    scl_inter = struct.unpack_from(f"{endian}f", data, 116)[0]
    qform_code = struct.unpack_from(f"{endian}h", data, 252)[0]
    sform_code = struct.unpack_from(f"{endian}h", data, 254)[0]
    quatern = struct.unpack_from(f"{endian}6f", data, 256)  # b, c, d, qx, qy, qz
    srow = np.array(struct.unpack_from(f"{endian}12f", data, 280)).reshape(3, 4)

    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype: {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    count = int(np.prod(shape_xyz))
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=vox_offset)
    # NIfTI data is Fortran-ordered over (x, y, z): reshape to (z, y, x).
    arr = arr.reshape(shape_xyz[::-1])

    # NaN slope/intercept (seen in real-world headers) means "no scaling"
    # (nibabel convention); without the guard a NaN would poison every voxel.
    if np.isnan(scl_slope):
        scl_slope = 0.0
    if np.isnan(scl_inter):
        scl_inter = 0.0
    # scl_slope == 0 disables scaling entirely per the NIfTI-1 spec — the
    # intercept must be ignored too (ITK's MustRescale and nibabel agree).
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        arr = arr.astype(np.float32) * scl_slope + scl_inter
    else:
        arr = arr.astype(arr.dtype.newbyteorder("="))

    # Affine (voxel -> RAS mm).
    if sform_code > 0:
        affine = srow
    elif qform_code > 0:
        affine = _qform_affine(quatern, pixdim)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3]])
        affine = np.hstack([affine, np.zeros((3, 1))])

    # RAS -> LPS: negate the first two rows.
    lps = affine.copy()
    lps[0, :] *= -1
    lps[1, :] *= -1

    rotation = lps[:, :3]
    spacing = np.linalg.norm(rotation, axis=0)
    spacing = np.where(spacing > 0, spacing, 1.0)
    direction = rotation / spacing
    origin = lps[:, 3]

    return MedicalImage(
        array=arr,
        spacing=tuple(float(s) for s in spacing),
        origin=tuple(float(o) for o in origin),
        direction=direction,
        metadata={"path": str(path), "format": "nifti"},
    )


def _qform_affine(quatern: tuple[float, ...], pixdim: tuple[float, ...]) -> np.ndarray:
    """Build the qform rotation affine from the quaternion fields."""
    b, c, d, qx, qy, qz = quatern
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    rot = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    scales = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    affine = rot * scales
    return np.hstack([affine, np.array([[qx], [qy], [qz]])])


def write_nifti(image: MedicalImage, path: Path, compress: bool | None = None) -> None:
    """Write a NIfTI-1 file (.nii / .nii.gz)."""
    path = Path(path)
    if compress is None:
        compress = path.name.endswith(".gz")

    arr = np.ascontiguousarray(image.array)
    shape_zyx = arr.shape
    shape_xyz = shape_zyx[::-1]

    dtype_code = {
        np.dtype(np.uint8): 2,
        np.dtype(np.int16): 4,
        np.dtype(np.int32): 8,
        np.dtype(np.float32): 16,
        np.dtype(np.float64): 64,
        np.dtype(np.uint16): 512,
    }.get(arr.dtype)
    if dtype_code is None:
        arr = arr.astype(np.float32)
        dtype_code = 16

    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, 3, *shape_xyz, 1, 1, 1, 1)
    struct.pack_into("<h", header, 70, dtype_code)
    struct.pack_into("<h", header, 72, arr.dtype.itemsize * 8)
    struct.pack_into(
        "<8f", header, 76, 1.0, *[float(s) for s in image.spacing], 1.0, 1.0, 1.0, 1.0
    )
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)  # scl_slope
    struct.pack_into("<h", header, 254, 1)  # sform_code
    # LPS -> RAS affine rows.
    direction = image.direction * np.asarray(image.spacing)[None, :]
    affine = np.hstack([direction, np.asarray(image.origin).reshape(3, 1)])
    ras = affine.copy()
    ras[0, :] *= -1
    ras[1, :] *= -1
    struct.pack_into("<12f", header, 280, *ras.reshape(-1))
    header[344:348] = b"n+1\x00"

    payload = bytes(header) + arr.tobytes()
    if compress:
        path.write_bytes(gzip.compress(payload))
    else:
        path.write_bytes(payload)
