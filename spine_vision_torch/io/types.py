"""Medical image container with physical-space geometry.

Copied from ``spine_vision_tpu/io/types.py`` (pure numpy). Follows ITK
conventions, as SimpleITK's Image does:

- ``size``/``spacing``/``origin`` are in (x, y, z) order.
- ``direction`` is a 3x3 matrix whose COLUMNS are the physical-space (LPS)
  unit vectors along the x/y/z index axes.
- ``array`` is the numpy view in (z, y, x) index order (what
  ``sitk.GetArrayFromImage`` returns).

``orient`` reimplements ``sitk.DICOMOrient``: axis permutation + flips so
each index axis points along a requested anatomical direction. The
anatomical code letters name the direction the index *increases toward*
in LPS: L/R (+x/-x), P/A (+y/-y), S/I (+z/-z).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np

# LPS unit vectors for each anatomical code letter.
_CODE_TO_VECTOR = {
    "L": np.array([1.0, 0.0, 0.0]),
    "R": np.array([-1.0, 0.0, 0.0]),
    "P": np.array([0.0, 1.0, 0.0]),
    "A": np.array([0.0, -1.0, 0.0]),
    "S": np.array([0.0, 0.0, 1.0]),
    "I": np.array([0.0, 0.0, -1.0]),
}


@dataclass
class MedicalImage:
    """A 3D (or 2D) medical image with ITK-convention geometry."""

    array: np.ndarray  # (z, y, x) or (y, x)
    spacing: tuple[float, ...] = (1.0, 1.0, 1.0)  # (x, y, z)
    origin: tuple[float, ...] = (0.0, 0.0, 0.0)  # (x, y, z) in LPS mm
    direction: np.ndarray = field(
        default_factory=lambda: np.eye(3)
    )  # columns = index-axis directions in LPS
    metadata: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.array.ndim == 2:
            self.array = self.array[None, ...]
            if len(self.spacing) == 2:
                self.spacing = (*self.spacing, 1.0)
            if len(self.origin) == 2:
                self.origin = (*self.origin, 0.0)
            self.metadata.setdefault("is_2d", True)
        self.direction = np.asarray(self.direction, dtype=np.float64).reshape(3, 3)

    # -- sitk-like accessors -------------------------------------------------

    @property
    def size(self) -> tuple[int, int, int]:
        """(x, y, z) size (sitk GetSize order)."""
        d, h, w = self.array.shape
        return (w, h, d)

    def get_spacing(self) -> tuple[float, float, float]:
        return tuple(float(s) for s in self.spacing)  # type: ignore[return-value]

    @property
    def spacing_zyx(self) -> tuple[float, float, float]:
        sx, sy, sz = self.spacing
        return (float(sz), float(sy), float(sx))

    # -- orientation ---------------------------------------------------------

    def orientation_code(self) -> str:
        """Nearest anatomical code (e.g. 'LPI') of the current direction."""
        letters = []
        for axis in range(3):
            column = self.direction[:, axis]
            best = max(
                _CODE_TO_VECTOR.items(), key=lambda kv: float(np.dot(column, kv[1]))
            )
            letters.append(best[0])
        return "".join(letters)

    def orientation_plan(self, code: str = "LPI") -> tuple[list[int], list[bool]]:
        """Axis permutation + flips realizing ``orient(code)``.

        Returns (perm, flips) over (x, y, z) index axes: perm[new_axis] =
        old_axis, flips[new_axis] = whether that old axis reverses.
        """
        code = code.upper()
        if len(code) != 3:
            raise ValueError(f"Orientation code must have 3 letters: {code}")
        targets = [_CODE_TO_VECTOR[c] for c in code]

        # For each target axis, find the index axis whose direction column has
        # the largest |projection|, and whether it needs flipping.
        used: set[int] = set()
        perm: list[int] = []  # perm[new_axis] = old_axis (x,y,z indexing)
        flips: list[bool] = []
        for target in targets:
            projections = [
                abs(float(np.dot(self.direction[:, a], target)))
                if a not in used
                else -np.inf
                for a in range(3)
            ]
            old_axis = int(np.argmax(projections))
            used.add(old_axis)
            perm.append(old_axis)
            flips.append(float(np.dot(self.direction[:, old_axis], target)) < 0)
        return perm, flips

    def orient(self, code: str = "LPI") -> "MedicalImage":
        """Reorient so index axis k increases toward ``code[k]`` (sitk.DICOMOrient).

        Axis permutation + flips only (no resampling); updates array,
        spacing, origin, and direction consistently.
        """
        perm, flips = self.orientation_plan(code)

        # Build new geometry.
        size = self.size
        new_spacing = tuple(self.spacing[perm[k]] for k in range(3))
        new_direction = np.zeros((3, 3))
        origin = np.asarray(self.origin, dtype=np.float64)
        for k in range(3):
            col = self.direction[:, perm[k]].copy()
            if flips[k]:
                # Flipping an axis moves the origin to the other end.
                origin = origin + col * self.spacing[perm[k]] * (size[perm[k]] - 1)
                col = -col
            new_direction[:, k] = col

        # Apply to the (z, y, x) array: index axis x,y,z -> array axis 2,1,0.
        arr = self.array
        array_perm = [2 - perm[2], 2 - perm[1], 2 - perm[0]]
        arr = np.transpose(arr, array_perm)
        for k in range(3):
            if flips[k]:
                arr = np.flip(arr, axis=2 - k)

        return replace(
            self,
            array=np.ascontiguousarray(arr),
            spacing=new_spacing,
            origin=tuple(origin),
            direction=new_direction,
            metadata=dict(self.metadata),
        )

    # -- geometry of the middle sagittal slice -------------------------------

    def extract_middle_slice(self) -> np.ndarray:
        """Middle sagittal slice after LPI orientation, as the original
        pipeline takes it: array (I, P, L) -> [:, :, mid]."""
        if self.metadata.get("is_2d"):
            return self.array[0]
        oriented = self.orient("LPI")
        arr = oriented.array
        mid = arr.shape[2] // 2
        return arr[:, :, mid]

    def slice_spacing(self) -> tuple[float, float]:
        """(row, col) mm spacing of the middle sagittal slice
        as the original pipeline computes it."""
        if self.metadata.get("is_2d"):
            sx, sy = self.spacing[0], self.spacing[1]
            return (float(sy), float(sx))
        oriented = self.orient("LPI")
        sx, sy, sz = oriented.spacing
        return (float(sz), float(sy))
