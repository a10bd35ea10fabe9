"""Series preparation: decode, then the isotropic middle sagittal slice.

Counterpart of ``spine_vision_tpu/io/series.py``. The original pipeline
resamples the whole volume to 0.3 mm isotropic and keeps one middle sagittal
slice; :func:`extract_isotropic_middle_slice` computes that slice directly.
Separable linear interpolation commutes, so it blends the two native slices
that bracket the target sagittal position (on the host, as the JAX code
does), resamples the remaining two axes corner-aligned as two hat-matrix
products on the device (f32 ``torch.matmul``, TF32 off for the call), and
applies the orientation's in-plane transpose and flips afterwards. The slice
returns to the host as numpy.

Study inference (``infer/pipeline.py::study_input_from_paths``) prepares its
series here.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from spine_vision_torch.device import resolve_device
from spine_vision_torch.io.readers import read_medical_image
from spine_vision_torch.io.types import MedicalImage

ISOTROPIC_MM = 0.3

# The TF32 switch is process-wide: one lock keeps two threads from
# restoring it under each other's products.
_TF32_LOCK = threading.Lock()


def _corner_aligned_resize_2d(
    plane: np.ndarray,
    out_shape: tuple[int, int],
    scales: tuple[float, float],
    device: torch.device,
) -> np.ndarray:
    """Bilinear 2D resize with ``src = out_index * scale`` (the ITK and
    ``trilinear_resample`` convention), as two hat-matrix products."""
    plane_t = torch.from_numpy(np.ascontiguousarray(plane, dtype=np.float32)).to(device)
    mats = []
    for axis in range(2):
        n = plane.shape[axis]
        positions = torch.arange(out_shape[axis], dtype=torch.float32, device=device)
        positions = torch.clamp(positions * scales[axis], 0.0, n - 1.0)
        grid = torch.arange(n, dtype=torch.float32, device=device)
        mats.append(torch.clamp(1.0 - (positions[:, None] - grid[None, :]).abs(), min=0.0))
    with _TF32_LOCK:
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = mats[0] @ plane_t @ mats[1].T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
    return out.cpu().numpy()


def extract_isotropic_middle_slice(
    image: MedicalImage, iso: float = ISOTROPIC_MM, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, tuple[float, float]]:
    """Middle sagittal slice of the isotropically resampled, LPI-oriented
    volume, without resampling the whole volume.

    Returns (slice ``[rows, cols]`` float32, (row, col) spacing in mm): the
    values of ``resample_to_isotropic`` + ``extract_middle_slice`` +
    ``slice_spacing``.
    """
    dev = resolve_device(device)
    if image.metadata.get("is_2d"):
        # 2D inputs are resampled in-plane to iso too; rows are y, cols x.
        plane = image.array[0]
        sx, sy = float(image.spacing[0]), float(image.spacing[1])
        out_shape = (
            int(round(plane.shape[0] * sy / iso)),
            int(round(plane.shape[1] * sx / iso)),
        )
        return _corner_aligned_resize_2d(plane, out_shape, (iso / sy, iso / sx), dev), (iso, iso)

    arr = np.asarray(image.array)
    spacing = [float(s) for s in image.spacing]  # (x, y, z)
    sizes = image.size  # (x, y, z)
    out_size = [int(round(sizes[k] * spacing[k] / iso)) for k in range(3)]
    scale = [iso / spacing[k] for k in range(3)]

    perm, flips = image.orientation_plan("LPI")

    # Middle index along the oriented x (L) axis, mapped back through the
    # post-resample flip to a resampled-native index, then to a source
    # coordinate (corner-aligned: src = idx * scale).
    slice_xyz_axis = perm[0]
    out_w = out_size[slice_xyz_axis]
    mid = out_w // 2
    native_idx = (out_w - 1 - mid) if flips[0] else mid
    x_src = float(np.clip(native_idx * scale[slice_xyz_axis], 0, sizes[slice_xyz_axis] - 1))

    # Blend the two bracketing native slices (array is (z, y, x): xyz axis k
    # lives on array axis 2 - k).
    slice_arr_axis = 2 - slice_xyz_axis
    x0 = int(np.floor(x_src))
    x1 = min(x0 + 1, sizes[slice_xyz_axis] - 1)
    w = x_src - x0
    lo = np.take(arr, x0, axis=slice_arr_axis).astype(np.float32)
    hi = np.take(arr, x1, axis=slice_arr_axis).astype(np.float32)
    blended = (1.0 - w) * lo + w * hi

    # Remaining array axes, in order, and their xyz identities.
    remaining_arr_axes = [a for a in (0, 1, 2) if a != slice_arr_axis]
    remaining_xyz = [2 - a for a in remaining_arr_axes]
    plane = _corner_aligned_resize_2d(
        blended,
        (out_size[remaining_xyz[0]], out_size[remaining_xyz[1]]),
        (scale[remaining_xyz[0]], scale[remaining_xyz[1]]),
        dev,
    )

    # The orientation's in-plane action, after resampling as in the original
    # order: rows = oriented z (xyz axis perm[2]), cols = oriented y (perm[1]).
    out = plane if remaining_xyz[0] == perm[2] else plane.T
    if flips[2]:
        out = out[::-1, :]
    if flips[1]:
        out = out[:, ::-1]
    return np.ascontiguousarray(out), (iso, iso)


def prepare_series_slice(
    path: Path, iso: float = ISOTROPIC_MM, device: str | torch.device = "cuda"
) -> tuple[np.ndarray, tuple[float, float]]:
    """Decode a series (DICOM directory, .mha, .nii(.gz), .nrrd) and return
    its isotropic middle sagittal slice and (row, col) spacing."""
    return extract_isotropic_middle_slice(read_medical_image(Path(path)), iso, device)
