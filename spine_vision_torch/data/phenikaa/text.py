"""Text drawn from the committed DejaVu glyph atlas, as Pillow draws it.

The JAX package renders its OCR training lines and pages with Pillow's
``ImageDraw.text`` and TrueType fonts; the port has neither, and composites
the same text from ``glyphs/dejavu.npz`` (written where Pillow and the fonts
are, by ``tests/fixtures/torch_glyphs/generate.py``, whose docstring says
what was measured). :class:`AtlasFont` is one face at one pixel size:

- the pen starts at 0 and advances, in 26.6 pixels, by each character's
  advance plus the kerning of the pair it starts;
- a glyph lands at the rounded pen position (a decomposed character's
  bitmap is chosen by the pen's fraction instead);
- the glyphs merge into one mask, each over the last, and the mask blends
  ``fill`` into the image with Pillow's rounding (``draw``);
- ``getbbox`` is ``ImageDraw.textbbox((0, 0), ...)``'s box.

Faces are named by their file stems (``"DejaVuSans-Bold"``).
"""

from __future__ import annotations

import threading
from functools import lru_cache
from pathlib import Path

import numpy as np

ATLAS_PATH = Path(__file__).resolve().parent / "glyphs" / "dejavu.npz"
_LOCK = threading.Lock()


def _div255(a: np.ndarray) -> np.ndarray:
    t = a + 128
    return ((t >> 8) + t) >> 8


@lru_cache(maxsize=None)
def _atlas() -> dict[str, np.ndarray]:
    with np.load(ATLAS_PATH) as data:
        return {k: data[k] for k in data.files}


def atlas_faces() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(trained faces, holdout faces) in the JAX package's order."""
    a = _atlas()
    faces, n = tuple(str(f) for f in a["faces"]), int(a["n_trained"])
    return faces[:n], faces[n:]


class AtlasFont:
    """One face at one size (``ImageFont.truetype(face, size)``)."""

    def __init__(self, face: str, size: int) -> None:
        a = _atlas()
        faces = [str(f) for f in a["faces"]]
        sizes = [int(s) for s in a["sizes"]]
        if face not in faces or size not in sizes:
            raise KeyError(f"the glyph atlas has no {face} at {size} px")
        fi, si = faces.index(face), sizes.index(size)
        self.face, self.size = face, size
        self._index = {chr(c): i for i, c in enumerate(a["chars"].tolist())}
        self._advance = a["advance"][fi, si]
        self._bbox_y = a["bbox_y"][fi, si].astype(np.int64)
        self._cbox_x = a["cbox_x"][fi, si].astype(np.int64)
        self._phased = a["phased"][fi]
        self._first = a["first_variant"][fi, si]
        fs = a["kern_fs"] == fi * len(sizes) + si
        self._kern = {(int(p[0]), int(p[1])): int(v)
                      for p, v in zip(a["kern_pair"][fs], a["kern_value"][fs])}

    def _ids(self, text: str) -> list[int]:
        try:
            return [self._index[c] for c in text]
        except KeyError as e:
            raise KeyError(f"{e.args[0]!r} is not in the glyph atlas") from None

    def _pens(self, ids: list[int]) -> tuple[list[int], int]:
        pens, pen = [], 0
        for i, c in enumerate(ids):
            pens.append(pen)
            pen += int(self._advance[c])
            if i + 1 < len(ids):
                pen += self._kern.get((c, ids[i + 1]), 0)
        return pens, pen

    def _glyph(self, c: int, pen: int) -> tuple[np.ndarray, int, int]:
        a = _atlas()
        if self._phased[c]:
            v, origin = int(self._first[c]) + (pen & 63), pen >> 6
        else:
            v, origin = int(self._first[c]), (pen + 32) >> 6
        b = int(a["variant_bitmap"][v])
        h, w = (int(x) for x in a["bitmap_shape"][b])
        off = int(a["bitmap_offset"][b])
        bitmap = a["bitmap_data"][off : off + h * w].reshape(h, w)
        return bitmap, origin + int(a["variant_left"][v]), int(a["variant_top"][v])

    def getbbox(self, text: str) -> tuple[int, int, int, int]:
        """``ImageDraw.textbbox((0, 0), text, font)``."""
        ids = self._ids(text)
        if not ids:
            return 0, 0, 0, 0
        pens, _ = self._pens(ids)
        x0 = x1 = 0
        for c, pen in zip(ids, pens):
            x1 = max(x1, (pen + int(self._advance[c]) + 32) >> 6)
            px = (pen + 32) >> 6
            if self._cbox_x[c, 1] > self._cbox_x[c, 0]:
                x0, x1 = min(x0, px + self._cbox_x[c, 0]), max(x1, px + self._cbox_x[c, 1])
            if self._phased[c]:  # the marks' ink
                bitmap, left, _ = self._glyph(c, pen)
                if bitmap.size:
                    x0, x1 = min(x0, left), max(x1, left + bitmap.shape[1])
        top = int(self._bbox_y[ids, 0].min())
        bottom = int(self._bbox_y[ids, 1].max())
        return int(x0), top, int(x1), bottom

    def mask(self, text: str, shape: tuple[int, int], xy: tuple[int, int]
             ) -> tuple[np.ndarray, tuple[int, int, int, int]]:
        """The coverage mask (int64) of ``text`` drawn at ``xy`` on an image
        of ``shape``, over the region ``(y0, y1, x0, x1)`` its glyphs touch."""
        h, w = shape
        ids = self._ids(text)
        pens, _ = self._pens(ids)
        placed = []
        for c, pen in zip(ids, pens):
            bitmap, left, top = self._glyph(c, pen)
            if bitmap.size:
                placed.append((bitmap, xy[0] + left, xy[1] + top))
        if not placed:
            return np.zeros((0, 0), np.int64), (0, 0, 0, 0)
        y0 = max(min(y for _, _, y in placed), 0)
        y1 = min(max(y + b.shape[0] for b, _, y in placed), h)
        x0 = max(min(x for _, x, _ in placed), 0)
        x1 = min(max(x + b.shape[1] for b, x, _ in placed), w)
        out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)), np.int64)
        for bitmap, x, y in placed:
            ya, yb = max(y, y0), min(y + bitmap.shape[0], y1)
            xa, xb = max(x, x0), min(x + bitmap.shape[1], x1)
            if ya >= yb or xa >= xb:
                continue
            src = bitmap[ya - y : yb - y, xa - x : xb - x].astype(np.int64)
            dst = out[ya - y0 : yb - y0, xa - x0 : xb - x0]
            out[ya - y0 : yb - y0, xa - x0 : xb - x0] = src + dst - _div255(src * dst)
        return out, (y0, y1, x0, x1)

    def draw(self, img: np.ndarray, xy: tuple[int, int], text: str, fill: int) -> None:
        """``ImageDraw.Draw(img).text(xy, text, fill=fill, font=self)`` on a
        uint8 ``[H, W]`` image, in place (the blend leaves a pixel of zero
        coverage as it is, so only the glyphs' region is touched)."""
        m, (y0, y1, x0, x1) = self.mask(text, img.shape, xy)
        if m.size:
            region = img[y0:y1, x0:x1].astype(np.int64)
            img[y0:y1, x0:x1] = _div255(region * (255 - m) + int(fill) * m).astype(np.uint8)


@lru_cache(maxsize=None)
def _font(face: str, size: int) -> AtlasFont:
    return AtlasFont(face, size)


def truetype(face: str, size: int) -> AtlasFont:
    """The cached :class:`AtlasFont` of ``face`` at ``size`` px."""
    with _LOCK:
        return _font(face, int(size))
