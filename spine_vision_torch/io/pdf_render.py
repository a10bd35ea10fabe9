"""PDF content-stream interpreter and rasteriser (ISO 32000-1 §8-9), the
port's counterpart of PyMuPDF's ``page.get_pixmap(matrix=Matrix(z, z))``
(``spine_vision_tpu/io/pdf.py``; MuPDF's draw device).

- The page: its box is the CropBox clipped to the MediaBox, both inherited
  through the page tree, turned by ``/Rotate`` (a multiple of 90; any other
  value reads as 0), origin top-left, y down. The raster is that box times
  ``dpi / 72`` rounded as MuPDF's ``fz_round_rect``: ``floor(x0 + 0.001)``,
  ``ceil(x1 - 0.001)``. RGB uint8 on white, no alpha.
- State: ``q``/``Q``, ``cm``, ``w``, ``J``, ``j``, ``M``, ``d``, ``gs``
  (``LW``, ``LC``, ``LJ``, ``ML``, ``D``, ``ca``, ``CA``, ``Font``; a soft
  mask or a blend mode other than Normal raises); ``ri``, ``i`` and marked
  content ignored.
- Colour: DeviceGray, DeviceRGB, DeviceCMYK (``r = 1 - min(1, c + k)``, the
  same for g and b: MuPDF's conversion without a colour-management engine),
  ICCBased through its ``/N`` device space, CalGray and CalRGB as their device
  spaces, Indexed over any of them. A colour component c in [0, 1] is the byte
  ``floor(255 c + 0.5)``.
- Paths: ``m l c v y h re``, filled nonzero or even-odd, stroked into
  polygons (butt, round and square caps; miter, round and bevel joins; dash
  arrays) that are filled nonzero; a zero width draws a one-pixel line. The
  stroke width is ``w`` times the CTM's expansion ``sqrt(|det|)``. Curves are
  flattened in device space to within 0.1 pixel.
- Clipping: ``W``/``W*`` after the next painting operator, text render mode
  7, a form's ``BBox``; the clip is a coverage mask over its bounding box.
- Text: ``BT``/``ET``, ``Tf Tm Td TD T* Tc Tw Tz TL Ts Tr``, ``Tj TJ ' "``;
  render modes 0-3 and 7 (4-6 raise). Glyph outlines from ``io/pdf_fonts.py``
  filled nonzero, one scan conversion a shown string; Type 3 glyphs run their
  procedures (``d0``, ``d1``: colour operators ignored under ``d1``).
- XObjects: forms (``Matrix``, ``BBox`` clip, their resources; transparency
  groups without soft masks or blend modes painted as plain forms), images
  with ``/Decode``, ``/ImageMask`` (stencils in the fill colour), ``/SMask``
  (per-pixel alpha) and ``/Interpolate`` (read; the filter below is the
  same with or without it); inline images ``BI ID EI``; 1-16 bits a
  component (16-bit samples keep their high byte).
- Images are placed through the CTM: an image whose device map is axis
  aligned (any multiple of 90 degrees, flips included) is grid-fitted to
  whole pixels (``floor(x0 + 0.001)``, ``ceil(x1 - 0.001)``) and resampled
  separably: copied exactly at 1:1, area-averaged when shrinking,
  bilinear when enlarging (14-bit integer weights). Any other map samples
  bilinearly at each pixel centre in 16.16 fixed point (no antialiased
  image edges).
- Rasterisation: coverage of fixed-point edges (1/256 pixel) on a 16 x 16
  sample grid a pixel (sample centres at (16 k + 8) / 256), integer counts,
  ``alpha = (count * 255 + 128) >> 8``; composite ``d = (d (255 - a) + s a +
  127) / 255`` with ``a`` the coverage times the clip times ``ca`` or
  ``CA``, each step rounded. MuPDF's default (antialiasing level 8, its own
  sample grid) is not this grid; the difference to PyMuPDF's pixels is not
  measured (no PyMuPDF where the port runs).

The four raster steps run in C++ (``native/src/host_ops.cpp``:
``pdf_coverage``, ``pdf_composite``, ``pdf_resample_axes``,
``pdf_resample_affine``; g++ at first use) or, with ``plain=True``, in the
numpy versions below (:func:`coverage_plain`, :func:`composite_plain`,
:func:`resample_axes_plain`, :func:`resample_affine_plain`), which give the
same bytes. Shadings (``sh``, shading patterns), tiling patterns, soft masks,
blend modes, Separation, DeviceN and Lab colour spaces, image colour-key
masks (``/Mask``), annotations with appearance streams and text render modes
4-6 raise ``NotImplementedError`` naming ROADMAP Queue 1 item 13: never a
blank or partial page.
"""

from __future__ import annotations

import math
import time

import numpy as np

from spine_vision_torch.io import pdf_fonts
from spine_vision_torch.io.pdf_parse import (
    IMAGE_FILTERS,
    Name,
    PdfError,
    Stream,
    apply_filter,
    content_ops,
    decode_image_filter,
    stream_filters,
    unsupported,
)

FIX = 256  # edge coordinates in 1/256 pixel (16 x 16 samples a pixel: the native code's grid)
FLATNESS = 0.1  # pixels
WEIGHT_BITS = 14
_LIMIT = 1 << 26  # fixed-point coordinates are clamped to +-2^26 (262144 pixels)


# -- plain versions of the native raster functions --------------------------------
def coverage_plain(edges: np.ndarray, even_odd: bool, box: tuple) -> np.ndarray:
    """Coverage, uint8 ``[bh, bw]``, of the pixels of ``box`` by ``edges``:
    the plain version of ``native.pdf_coverage``."""
    bx, by, bw, bh = (int(v) for v in box)
    cov = np.zeros((bh, bw), np.uint8)
    e = np.asarray(edges, np.int64).reshape(-1, 5)
    if bw <= 0 or bh <= 0 or not len(e):
        return cov
    x0, y0, x1, y1, w = e.T
    s0 = np.maximum((y0 + 7) // 16, by * 16)
    s1 = np.minimum((y1 + 7) // 16, (by + bh) * 16)
    keep = s0 < s1
    x0, y0, x1, y1, w, s0, s1 = (a[keep] for a in (x0, y0, x1, y1, w, s0, s1))
    if not len(x0):
        return cov
    counts = s1 - s0
    idx = np.repeat(np.arange(len(x0)), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    s = s0[idx] + (np.arange(idx.size) - first)
    ys = s * 16 + 8
    x = x0[idx] + ((ys - y0[idx]) * (x1[idx] - x0[idx])) // (y1[idx] - y0[idx])
    k = np.clip((x + 7) // 16 - bx * 16, 0, bw * 16)
    order = np.lexsort((k, s))
    s, k, ww = s[order], k[order], w[idx][order]
    csum = np.cumsum(ww)
    start = np.ones(s.size, bool)
    start[1:] = s[1:] != s[:-1]
    row_id = np.cumsum(start) - 1
    wsum = csum - (csum - ww)[start][row_id]
    inside = (wsum & 1) != 0 if even_odd else wsum != 0
    valid = inside[:-1] & (s[1:] == s[:-1]) & (k[1:] != k[:-1])
    ka, kb = k[:-1][valid], k[1:][valid]
    rows = s[:-1][valid] // 16 - by
    width = bw + 1
    flat_a, flat_b = rows * width + (ka >> 4), rows * width + (kb >> 4)
    size = bh * width
    diff = (np.bincount(flat_a, minlength=size) * 16 - np.bincount(flat_b, minlength=size) * 16)
    extra = (np.bincount(flat_b, weights=kb & 15, minlength=size)
             - np.bincount(flat_a, weights=ka & 15, minlength=size)).astype(np.int64)
    count = np.cumsum(diff.reshape(bh, width), axis=1) + extra.reshape(bh, width)
    return ((count[:, :bw] * 255 + 128) >> 8).astype(np.uint8)


def composite_plain(page: np.ndarray, box: tuple, cov: np.ndarray, src, rgb, alpha: int,
                    clip) -> None:
    """The plain version of ``native.pdf_composite`` (in place)."""
    bx, by, bw, bh = (int(v) for v in box)
    H, W = page.shape[:2]
    x0, y0, x1, y1 = max(bx, 0), max(by, 0), min(bx + bw, W), min(by + bh, H)
    if x1 <= x0 or y1 <= y0:
        return
    a = cov[y0 - by:y1 - by, x0 - bx:x1 - bx].astype(np.int32)
    if clip is not None:
        cx, cy, mask = clip
        m = np.zeros_like(a)
        mh, mw = mask.shape
        ox0, oy0 = max(x0, cx), max(y0, cy)
        ox1, oy1 = min(x1, cx + mw), min(y1, cy + mh)
        if ox1 > ox0 and oy1 > oy0:
            m[oy0 - y0:oy1 - y0, ox0 - x0:ox1 - x0] = mask[oy0 - cy:oy1 - cy, ox0 - cx:ox1 - cx]
        a = (a * m + 127) // 255
    a = ((a * int(alpha) + 127) // 255)[..., None]
    if src is not None:
        s = np.asarray(src)[y0 - by:y1 - by, x0 - bx:x1 - bx].astype(np.int32)
    else:
        s = np.asarray(rgb, np.int32)[None, None, :]
    d = page[y0:y1, x0:x1].astype(np.int32)
    page[y0:y1, x0:x1] = ((d * (255 - a) + s * a + 127) // 255).astype(np.uint8)


def resample_axes_plain(src: np.ndarray, xtab: tuple, ytab: tuple) -> np.ndarray:
    """The plain version of ``native.pdf_resample_axes``."""
    src = np.asarray(src, np.uint8)
    xi, xw = (np.asarray(t, np.int64) for t in xtab)
    yi, yw = (np.asarray(t, np.int64) for t in ytab)
    used = np.unique(yi[yw != 0]) if yw.size else np.zeros(0, np.int64)
    tmp = np.zeros((src.shape[0], xi.shape[0], src.shape[2]), np.int64)
    for t in range(xi.shape[1]):
        tmp[used] += xw[:, t][None, :, None] * src[used][:, xi[:, t], :]
    out = np.zeros((yi.shape[0], xi.shape[0], src.shape[2]), np.int64)
    for t in range(yi.shape[1]):
        out += yw[:, t][:, None, None] * tmp[yi[:, t]]
    return ((out + (1 << 27)) >> 28).astype(np.uint8)


def resample_affine_plain(src: np.ndarray, m: np.ndarray, box: tuple) -> tuple:
    """The plain version of ``native.pdf_resample_affine``."""
    src = np.asarray(src, np.uint8)
    sh, sw, nc = src.shape
    m = [int(v) for v in m]
    bx, by, bw, bh = (int(v) for v in box)
    one = 65536
    X = np.arange(bx, bx + bw, dtype=np.int64)[None, :]
    Y = np.arange(by, by + bh, dtype=np.int64)[:, None]
    u = m[0] * X + m[1] * Y + m[2]
    v = m[3] * X + m[4] * Y + m[5]
    inside = (u >= 0) & (v >= 0) & (u < sw * one) & (v < sh * one)
    uu, vv = u - one // 2, v - one // 2
    i0, j0 = uu // one, vv // one
    fu, fv = (uu - i0 * one)[..., None], (vv - j0 * one)[..., None]
    i1, j1 = np.clip(i0 + 1, 0, sw - 1), np.clip(j0 + 1, 0, sh - 1)
    i0, j0 = np.clip(i0, 0, sw - 1), np.clip(j0, 0, sh - 1)  # outside: masked below
    s = src.astype(np.int64)
    top = s[j0, i0] * (one - fu) + s[j0, i1] * fu
    bot = s[j1, i0] * (one - fu) + s[j1, i1] * fu
    out = ((top * (one - fv) + bot * fv + (1 << 31)) >> 32).astype(np.uint8)
    out[~inside] = 0
    return out, np.where(inside, 255, 0).astype(np.uint8)


class Raster:
    """The raster steps: C++ (``native``) or the plain numpy versions; the
    seconds spent in them are summed in ``seconds``."""

    def __init__(self, plain: bool = False):
        self.plain = plain
        self.seconds = 0.0
        if not plain:
            from spine_vision_torch import native

            self.native = native

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds += time.perf_counter() - t0
        return out

    def coverage(self, edges, even_odd, box):
        fn = coverage_plain if self.plain else self.native.pdf_coverage
        return self._timed(fn, edges, even_odd, box)

    def composite(self, page, box, cov, src, rgb, alpha, clip):
        fn = composite_plain if self.plain else self.native.pdf_composite
        return self._timed(fn, page, box, cov, src, rgb, alpha, clip)

    def resample_axes(self, src, xtab, ytab):
        fn = resample_axes_plain if self.plain else self.native.pdf_resample_axes
        return self._timed(fn, src, xtab, ytab)

    def resample_affine(self, src, m, box):
        fn = resample_affine_plain if self.plain else self.native.pdf_resample_affine
        return self._timed(fn, src, m, box)


# -- geometry ------------------------------------------------------------------------
def mul(m1, m2) -> tuple:
    """``m1 x m2``: apply m1, then m2 (PDF row-vector matrices)."""
    a, b, c, d, e, f = m1
    A, B, C, D, E, F = m2
    return (a * A + b * C, a * B + b * D, c * A + d * C, c * B + d * D,
            e * A + f * C + E, e * B + f * D + F)


def apply(m, x, y) -> tuple:
    return m[0] * x + m[2] * y + m[4], m[1] * x + m[3] * y + m[5]


def invert(m) -> tuple:
    a, b, c, d, e, f = m
    det = a * d - b * c
    if det == 0:
        raise PdfError("a singular matrix")
    return (d / det, -b / det, -c / det, a / det, (c * f - d * e) / det, (b * e - a * f) / det)


def round_rect(x0: float, y0: float, x1: float, y1: float) -> tuple:
    """MuPDF's ``fz_round_rect``."""
    return (math.floor(x0 + 0.001), math.floor(y0 + 0.001), math.ceil(x1 - 0.001),
            math.ceil(y1 - 0.001))


def _box(value, doc) -> tuple | None:
    v = doc.resolve(value)
    if not isinstance(v, list) or len(v) != 4:
        return None
    x0, y0, x1, y1 = (float(doc.resolve(c)) for c in v)
    return min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1)


def page_geometry(doc, page: dict, zoom: float) -> tuple:
    """(the device matrix, (W, H)) of a page at ``zoom`` pixels a point."""
    media = _box(page.get("MediaBox"), doc) or (0.0, 0.0, 612.0, 792.0)
    crop = _box(page.get("CropBox"), doc) or media
    bx0, by0 = max(media[0], crop[0]), max(media[1], crop[1])
    bx1, by1 = min(media[2], crop[2]), min(media[3], crop[3])
    if bx1 <= bx0 or by1 <= by0:
        bx0, by0, bx1, by1 = media
    rotate = int(doc.resolve(page.get("Rotate", 0)) or 0)
    rotate = rotate % 360 if rotate % 90 == 0 else 0
    z = zoom
    m = {0: (z, 0.0, 0.0, -z, -bx0 * z, by1 * z),
         90: (0.0, z, z, 0.0, -by0 * z, -bx0 * z),
         180: (-z, 0.0, 0.0, z, bx1 * z, -by0 * z),
         270: (0.0, -z, -z, 0.0, by1 * z, bx1 * z)}[rotate]
    corners = [apply(m, x, y) for x in (bx0, bx1) for y in (by0, by1)]
    xs, ys = [p[0] for p in corners], [p[1] for p in corners]
    x0, y0, x1, y1 = round_rect(min(xs), min(ys), max(xs), max(ys))
    m = (m[0], m[1], m[2], m[3], m[4] - x0, m[5] - y0)
    return m, (max(x1 - x0, 0), max(y1 - y0, 0))


def flatten(ops: list, m) -> list:
    """Subpaths (lists of M/L/Q/C operators, user space) through ``m`` into
    device polylines: [(points float64 [n, 2], closed)]."""
    out = []
    for sub, closed in ops:
        pts = []
        cur = None
        for op in sub:
            kind = op[0]
            if kind == "M":
                cur = apply(m, op[1], op[2])
                pts = [cur]
            elif kind == "L":
                cur = apply(m, op[1], op[2])
                pts.append(cur)
            elif kind == "C":
                p1, p2, p3 = apply(m, op[1], op[2]), apply(m, op[3], op[4]), apply(m, op[5], op[6])
                pts.extend(_cubic(cur, p1, p2, p3))
                cur = p3
            elif kind == "Q":
                p1, p2 = apply(m, op[1], op[2]), apply(m, op[3], op[4])
                pts.extend(_quad(cur, p1, p2))
                cur = p2
        if pts:
            out.append((np.asarray(pts, np.float64), closed))
    return out


def _cubic(p0, p1, p2, p3) -> list:
    dd = max(math.hypot(p0[0] - 2 * p1[0] + p2[0], p0[1] - 2 * p1[1] + p2[1]),
             math.hypot(p1[0] - 2 * p2[0] + p3[0], p1[1] - 2 * p2[1] + p3[1]))
    n = min(max(1, math.ceil(math.sqrt(0.75 * dd / FLATNESS))), 256)
    if n == 1:
        return [p3]
    t = np.arange(1, n + 1) / n
    mt = 1 - t
    b = np.stack([mt ** 3, 3 * mt * mt * t, 3 * mt * t * t, t ** 3], 1)
    pts = b @ np.array([p0, p1, p2, p3], np.float64)
    pts[-1] = p3
    return list(map(tuple, pts))


def _quad(p0, p1, p2) -> list:
    dd = math.hypot(p0[0] - 2 * p1[0] + p2[0], p0[1] - 2 * p1[1] + p2[1])
    n = min(max(1, math.ceil(math.sqrt(dd / (4 * FLATNESS)))), 256)
    if n == 1:
        return [p2]
    t = np.arange(1, n + 1) / n
    mt = 1 - t
    b = np.stack([mt * mt, 2 * mt * t, t * t], 1)
    pts = b @ np.array([p0, p1, p2], np.float64)
    pts[-1] = p2
    return list(map(tuple, pts))


def edges_of(polys: list) -> np.ndarray:
    """Closed polygons (device float points) to int32 edges ``[n, 5]``:
    x0, y0, x1, y1 in 1/256 pixel with y0 < y1, and the winding."""
    parts = []
    for pts in polys:
        if len(pts) < 2:
            continue
        q = np.clip(np.floor(np.asarray(pts, np.float64) * FIX + 0.5), -_LIMIT, _LIMIT)
        q = q.astype(np.int64)
        a, b = q, np.roll(q, -1, axis=0)
        down = b[:, 1] > a[:, 1]
        up = b[:, 1] < a[:, 1]
        sel = down | up
        lo = np.where(down[:, None], a, b)[sel]
        hi = np.where(down[:, None], b, a)[sel]
        w = np.where(down, 1, -1)[sel]
        parts.append(np.column_stack([lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1], w]))
    if not parts:
        return np.zeros((0, 5), np.int32)
    return np.concatenate(parts).astype(np.int32)


def _edges_box(edges: np.ndarray) -> tuple:
    x0 = int(np.floor(min(edges[:, 0].min(), edges[:, 2].min()) / FIX))
    x1 = int(np.ceil(max(edges[:, 0].max(), edges[:, 2].max()) / FIX)) + 1
    y0 = int(np.floor(edges[:, 1].min() / FIX))
    y1 = int(np.ceil(edges[:, 3].max() / FIX)) + 1
    return x0, y0, x1, y1


# -- strokes -------------------------------------------------------------------------
def _oriented(poly: np.ndarray) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    area = np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
    return poly[::-1] if area < 0 else poly


def _circle(c, r: float) -> np.ndarray:
    n = int(min(64, max(8, math.ceil(2 * math.pi * r / 1.5))))
    t = np.arange(n) * (2 * math.pi / n)
    return np.column_stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)])


def _dash(pts: np.ndarray, closed: bool, dash: list, phase: float) -> list:
    if closed:
        pts = np.vstack([pts, pts[:1]])
    seg = np.diff(pts, axis=0)
    lens = np.hypot(seg[:, 0], seg[:, 1])
    total = float(lens.sum())
    period = sum(dash)
    if period <= 0:
        return [(pts, False)]
    # Where the pattern switches on and off along the path.
    pos = -(phase % period)
    i = 0
    on = True
    marks = []
    while pos < total:
        nxt = pos + dash[i % len(dash)]
        if on and nxt > 0:
            marks.append((max(pos, 0.0), min(nxt, total)))
        pos = nxt
        on = not on
        i += 1
        if i > 100000:
            break
    cum = np.concatenate([[0.0], np.cumsum(lens)])
    out = []
    for a, b in marks:
        ia = int(np.searchsorted(cum, a, side="right") - 1)
        ib = int(np.searchsorted(cum, b, side="right") - 1)
        ia, ib = min(ia, len(lens) - 1), min(ib, len(lens) - 1)

        def at(d, k):
            if lens[k] == 0:
                return pts[k]
            return pts[k] + seg[k] * ((d - cum[k]) / lens[k])

        piece = [at(a, ia)] + [pts[k] for k in range(ia + 1, ib + 1)] + [at(b, ib)]
        out.append((np.asarray(piece), False))
    return out


def stroke_polygons(polylines: list, width: float, cap: int, join: int, miter: float,
                    dash: list | None, phase: float) -> list:
    """Device polylines to the polygons of their stroke (each oriented
    positively, so the nonzero fill of all of them is their union)."""
    hw = width / 2.0
    polys = []
    pieces = []
    for pts, closed in polylines:
        if dash:
            pieces += _dash(pts, closed, dash, phase)
        else:
            pieces.append((pts, closed))
    for pts, closed in pieces:
        # Drop repeated points.
        if len(pts) > 1:
            keep = np.ones(len(pts), bool)
            keep[1:] = np.any(np.abs(np.diff(pts, axis=0)) > 1e-9, axis=1)
            pts = pts[keep]
        if closed and len(pts) > 2 and np.allclose(pts[0], pts[-1]):
            pts = pts[:-1]
        if len(pts) == 1:
            if cap == 1:
                polys.append(_circle(pts[0], hw))
            elif cap == 2:
                x, y = pts[0]
                polys.append(np.array([[x - hw, y - hw], [x + hw, y - hw], [x + hw, y + hw],
                                       [x - hw, y + hw]]))
            continue
        if len(pts) < 2:
            continue
        ring = np.vstack([pts, pts[:1]]) if closed else pts
        d = np.diff(ring, axis=0)
        lens = np.hypot(d[:, 0], d[:, 1])
        u = d / lens[:, None]
        n = np.column_stack([-u[:, 1], u[:, 0]]) * hw
        a, b = ring[:-1], ring[1:]
        quads = np.stack([a + n, b + n, b - n, a - n], 1)
        polys += list(quads)
        nseg = len(u)
        verts = range(nseg) if closed else range(1, nseg)
        for k in verts:
            u0, u1 = u[k - 1], u[k]
            p = ring[k]
            turn = u0[0] * u1[1] - u0[1] * u1[0]
            if abs(turn) < 1e-12 and np.dot(u0, u1) > 0:
                continue
            if join == 1:
                polys.append(_circle(p, hw))
                continue
            side = -1.0 if turn > 0 else 1.0
            o0, o1 = n[k - 1] * side, n[k] * side
            polys.append(np.array([p, p + o0, p + o1]))
            if join == 0:
                # miter length / width = 1 / sin(phi / 2), phi the angle between the segments
                phi_sin = math.sqrt(max(0.0, (1 + float(np.dot(u0, u1))) / 2))
                if phi_sin > 1e-9 and 1.0 / phi_sin <= miter:
                    nn0, nn1 = o0 / hw, o1 / hw
                    tip = p + (nn0 + nn1) * hw / (1 + float(np.dot(nn0, nn1)))
                    polys.append(np.array([p, p + o0, tip, p + o1]))
        if not closed:
            for p, t, sgn in ((ring[0], u[0], -1.0), (ring[-1], u[-1], 1.0)):
                if cap == 1:
                    polys.append(_circle(p, hw))
                elif cap == 2:
                    nn = np.array([-t[1], t[0]]) * hw
                    ext = t * hw * sgn
                    polys.append(np.array([p + nn, p + nn + ext, p - nn + ext, p - nn]))
    return [_oriented(np.asarray(p, np.float64)) for p in polys]


# -- colour --------------------------------------------------------------------------
def _byte(v: float) -> int:
    return int(min(255, max(0, math.floor(v * 255.0 + 0.5))))


class ColorSpace:
    """A colour space reduced to what the renderer draws: ``n`` components
    into RGB bytes; Indexed holds its base and table."""

    def __init__(self, kind: str, n: int, base=None, table: bytes = b"", hival: int = 0):
        self.kind, self.n, self.base, self.table, self.hival = kind, n, base, table, hival

    def rgb(self, comps: list) -> tuple:
        if self.kind == "Indexed":
            i = int(min(max(round(comps[0]), 0), self.hival))
            n = self.base.n
            vals = [b / 255.0 for b in self.table[i * n:(i + 1) * n]]
            vals += [0.0] * (n - len(vals))
            return self.base.rgb(vals)
        comps = list(comps) + [0.0] * (self.n - len(comps))
        if self.kind == "DeviceGray":
            g = _byte(comps[0])
            return g, g, g
        if self.kind == "DeviceRGB":
            return tuple(_byte(c) for c in comps[:3])
        c, m, y, k = comps[:4]
        return tuple(_byte(1 - min(1.0, v + k)) for v in (c, m, y))

    def initial(self) -> list:
        if self.kind == "DeviceCMYK":
            return [0.0, 0.0, 0.0, 1.0]
        return [0.0] * self.n


GRAY, RGB, CMYK = ColorSpace("DeviceGray", 1), ColorSpace("DeviceRGB", 3), ColorSpace("DeviceCMYK", 4)
_DEVICE = {"DeviceGray": GRAY, "G": GRAY, "DeviceRGB": RGB, "RGB": RGB, "DeviceCMYK": CMYK,
           "CMYK": CMYK, "CalGray": GRAY, "CalRGB": RGB}


def color_space(doc, obj, resources: dict | None) -> ColorSpace:
    obj = doc.resolve(obj)
    if isinstance(obj, Name):
        if str(obj) in _DEVICE:
            return _DEVICE[str(obj)]
        if str(obj) == "Pattern":
            raise unsupported("patterns")
        spaces = doc.resolve((resources or {}).get("ColorSpace")) or {}
        if str(obj) in spaces:
            return color_space(doc, spaces[str(obj)], None)
        raise unsupported(f"the colour space {obj}")
    if isinstance(obj, list) and obj:
        kind = str(doc.resolve(obj[0]))
        if kind in ("CalGray", "CalRGB"):
            return _DEVICE[kind]
        if kind == "ICCBased":
            stream = doc.resolve(obj[1])
            n = int(doc.resolve(stream.get("N", 3)))
            alt = stream.get("Alternate")
            if alt is not None:
                alt_space = color_space(doc, alt, resources)
                if alt_space.n == n:
                    return alt_space
            if n not in (1, 3, 4):
                raise unsupported(f"an ICC profile of {n} components")
            return {1: GRAY, 3: RGB, 4: CMYK}[n]
        if kind in ("Indexed", "I"):
            base = color_space(doc, obj[1], resources)
            hival = int(doc.resolve(obj[2]))
            table = doc.resolve(obj[3])
            if isinstance(table, Stream):
                table = table.data()
            return ColorSpace("Indexed", 1, base, bytes(table or b""), hival)
        if kind in ("Separation", "DeviceN", "Lab", "Pattern"):
            raise unsupported(f"the {kind} colour space")
        if kind in _DEVICE:
            return _DEVICE[kind]
    raise unsupported(f"the colour space {obj!r}")


# -- the interpreter -----------------------------------------------------------------
_OPERANDS = {"m": 2, "l": 2, "c": 6, "v": 4, "y": 4, "re": 4, "cm": 6, "w": 1, "J": 1, "j": 1,
             "M": 1, "d": 2, "gs": 1, "g": 1, "G": 1, "rg": 3, "RG": 3, "k": 4, "K": 4,
             "cs": 1, "CS": 1, "Do": 1, "BI": 1, "Tc": 1, "Tw": 1, "Tz": 1, "TL": 1, "Ts": 1,
             "Tr": 1, "Tf": 2, "Td": 2, "TD": 2, "Tm": 6, "Tj": 1, "'": 1, '"': 3, "TJ": 1}

class GState:
    __slots__ = ("ctm", "clip", "fill_cs", "fill", "stroke_cs", "stroke", "lw", "cap", "join",
                 "miter", "dash", "phase", "fill_alpha", "stroke_alpha", "font", "size", "tc",
                 "tw", "th", "tl", "rise", "mode")

    def copy(self) -> "GState":
        g = GState.__new__(GState)
        for k in GState.__slots__:
            setattr(g, k, getattr(self, k))
        return g


class Renderer:
    """Renders one page onto an RGB uint8 raster."""

    def __init__(self, doc, page: dict, zoom: float, plain: bool = False):
        self.doc = doc
        self.page_dict = page
        self.matrix, (self.W, self.H) = page_geometry(doc, page, zoom)
        self.page = np.full((self.H, self.W, 3), 255, np.uint8)
        self.raster = Raster(plain)
        self.fonts: dict = {}
        self.glyph_cache: dict = {}
        g = GState()
        g.ctm, g.clip = self.matrix, None
        g.fill_cs, g.fill, g.stroke_cs, g.stroke = GRAY, (0, 0, 0), GRAY, (0, 0, 0)
        g.lw, g.cap, g.join, g.miter, g.dash, g.phase = 1.0, 0, 0, 10.0, None, 0.0
        g.fill_alpha = g.stroke_alpha = 255
        g.font, g.size, g.tc, g.tw, g.th, g.tl, g.rise, g.mode = None, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0
        self.gs = g
        self.stack: list[GState] = []
        self.depth = 0
        self.decode_seconds = 0.0

    # -- painting ----------------------------------------------------------------
    def _visible(self, box: tuple) -> tuple | None:
        x0, y0, x1, y1 = box
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, self.W), min(y1, self.H)
        clip = self.gs.clip
        if clip is not None:
            cx, cy, mask = clip
            x0, y0 = max(x0, cx), max(y0, cy)
            x1, y1 = min(x1, cx + mask.shape[1]), min(y1, cy + mask.shape[0])
        if x1 <= x0 or y1 <= y0:
            return None
        return x0, y0, x1 - x0, y1 - y0

    def fill_polys(self, polys: list, even_odd: bool, rgb, alpha: int) -> None:
        edges = edges_of(polys)
        if not len(edges) or alpha == 0:
            return
        box = self._visible(_edges_box(edges))
        if box is None:
            return
        cov = self.raster.coverage(edges, even_odd, box)
        self.raster.composite(self.page, box, cov, None, rgb, alpha, self.gs.clip)

    def clip_polys(self, polys: list, even_odd: bool) -> None:
        edges = edges_of(polys)
        box = self._visible(_edges_box(edges)) if len(edges) else None
        if box is None:
            self.gs.clip = (0, 0, np.zeros((0, 0), np.uint8))
            return
        cov = self.raster.coverage(edges, even_odd, box)
        old = self.gs.clip
        if old is not None:
            cx, cy, mask = old
            bx, by, bw, bh = box
            sub = mask[by - cy:by - cy + bh, bx - cx:bx - cx + bw].astype(np.int32)
            cov = ((cov.astype(np.int32) * sub + 127) // 255).astype(np.uint8)
        self.gs.clip = (box[0], box[1], cov)

    def stroke_device(self, polylines: list) -> None:
        g = self.gs
        expansion = math.sqrt(abs(g.ctm[0] * g.ctm[3] - g.ctm[1] * g.ctm[2]))
        width = g.lw * expansion if g.lw > 0 else 1.0
        dash = [float(v) * expansion for v in g.dash] if g.dash else None
        if dash is not None and not any(dash):
            dash = None
        polys = stroke_polygons(polylines, width, g.cap, g.join, g.miter, dash,
                                g.phase * expansion)
        self.fill_polys(polys, False, g.stroke, g.stroke_alpha)

    # -- content -----------------------------------------------------------------
    def run(self, data: bytes, resources: dict | None, type3: bool = False) -> None:
        self.depth += 1
        if self.depth > 32:
            raise PdfError("forms nested past 32")
        resources = self.doc.resolve(resources) or {}
        path: list = []
        sub: list | None = None
        start = cur = (0.0, 0.0)
        pending_clip = None
        text_m = line_m = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
        text_clip: list | None = None
        uncoloured = False
        doc = self.doc

        for op, args in content_ops(data):
            g = self.gs
            if len(args) < _OPERANDS.get(op, 0):
                continue  # an operator missing operands is skipped, as MuPDF does
            if op == "m":
                if sub:
                    path.append((sub, False))
                cur = start = (float(args[0]), float(args[1]))
                sub = [("M", *cur)]
            elif op == "l":
                if sub is None:
                    sub = [("M", *cur)]
                cur = (float(args[0]), float(args[1]))
                sub.append(("L", *cur))
            elif op in ("c", "v", "y"):
                a = [float(v) for v in args]
                if op == "c":
                    p = a
                elif op == "v":
                    p = [cur[0], cur[1], *a]
                else:
                    p = [a[0], a[1], a[2], a[3], a[2], a[3]]
                if sub is None:
                    sub = [("M", *cur)]
                sub.append(("C", *p))
                cur = (p[4], p[5])
            elif op == "h":
                if sub:
                    path.append((sub, True))
                    sub = None
                    cur = start
            elif op == "re":
                x, y, w, h = (float(v) for v in args)
                if sub:
                    path.append((sub, False))
                path.append(([("M", x, y), ("L", x + w, y), ("L", x + w, y + h),
                              ("L", x, y + h)], True))
                sub = None
                cur = start = (x, y)
            elif op in ("S", "s", "f", "F", "f*", "B", "B*", "b", "b*", "n"):
                if sub:
                    path.append((sub, op in ("s", "b", "b*")))
                sub = None
                polylines = flatten(path, g.ctm) if path else []
                if op in ("f", "F", "f*", "B", "B*", "b", "b*") and polylines:
                    self.fill_polys([p for p, _ in polylines], op.endswith("*"), g.fill,
                                    g.fill_alpha)
                if op in ("S", "s", "B", "B*", "b", "b*") and polylines:
                    self.stroke_device(polylines)
                if pending_clip is not None:
                    self.clip_polys([p for p, _ in polylines], pending_clip)
                    pending_clip = None
                path = []
            elif op in ("W", "W*"):
                pending_clip = op == "W*"
            elif op == "q":
                self.stack.append(g.copy())
            elif op == "Q":
                if self.stack:
                    self.gs = self.stack.pop()
            elif op == "cm":
                g.ctm = mul(tuple(float(v) for v in args[:6]), g.ctm)
            elif op == "w":
                g.lw = float(args[0])
            elif op == "J":
                g.cap = int(args[0])
            elif op == "j":
                g.join = int(args[0])
            elif op == "M":
                g.miter = float(args[0])
            elif op == "d":
                g.dash = [float(doc.resolve(v)) for v in args[0]] or None
                g.phase = float(args[1])
            elif op == "gs":
                self._ext_gstate(resources, args[0])
            elif op in ("g", "G", "rg", "RG", "k", "K"):
                if uncoloured:
                    continue
                cs = {"g": GRAY, "rg": RGB, "k": CMYK}[op.lower()]
                rgb = cs.rgb([float(v) for v in args])
                if op.islower():
                    g.fill_cs, g.fill = cs, rgb
                else:
                    g.stroke_cs, g.stroke = cs, rgb
            elif op in ("cs", "CS"):
                if uncoloured:
                    continue
                cs = color_space(doc, args[0], resources)
                rgb = cs.rgb(cs.initial())
                if op == "cs":
                    g.fill_cs, g.fill = cs, rgb
                else:
                    g.stroke_cs, g.stroke = cs, rgb
            elif op in ("sc", "scn", "SC", "SCN"):
                if uncoloured:
                    continue
                if any(isinstance(v, Name) for v in args):
                    raise unsupported("patterns")
                cs = g.fill_cs if op.islower() else g.stroke_cs
                rgb = cs.rgb([float(v) for v in args])
                if op.islower():
                    g.fill = rgb
                else:
                    g.stroke = rgb
            elif op == "Do":
                self._do(resources, args[0])
            elif op == "BI":
                self._image(args[0], resources)
            elif op == "sh":
                raise unsupported("shadings (sh)")
            elif op == "BT":
                text_m = line_m = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
                text_clip = []
            elif op == "ET":
                if g.mode == 7 and text_clip is not None:
                    self.clip_polys(text_clip, False)
                text_clip = None
            elif op == "Tc":
                g.tc = float(args[0])
            elif op == "Tw":
                g.tw = float(args[0])
            elif op == "Tz":
                g.th = float(args[0]) / 100.0
            elif op == "TL":
                g.tl = float(args[0])
            elif op == "Ts":
                g.rise = float(args[0])
            elif op == "Tr":
                g.mode = int(args[0])
                if g.mode in (4, 5, 6):
                    raise unsupported(f"text render mode {g.mode}")
            elif op == "Tf":
                g.font = self._font(resources, args[0])
                g.size = float(args[1])
            elif op in ("Td", "TD"):
                tx, ty = float(args[0]), float(args[1])
                if op == "TD":
                    g.tl = -ty
                line_m = text_m = mul((1, 0, 0, 1, tx, ty), line_m)
            elif op == "Tm":
                line_m = text_m = tuple(float(v) for v in args[:6])
            elif op == "T*":
                line_m = text_m = mul((1, 0, 0, 1, 0, -g.tl), line_m)
            elif op in ("Tj", "'", '"', "TJ"):
                if op == "'":
                    line_m = text_m = mul((1, 0, 0, 1, 0, -g.tl), line_m)
                elif op == '"':
                    g.tw, g.tc = float(args[0]), float(args[1])
                    line_m = text_m = mul((1, 0, 0, 1, 0, -g.tl), line_m)
                    args = args[2:]
                items = args[0] if op == "TJ" else [args[0]]
                text_m = self._show(items, text_m, text_clip, resources)
            elif op in ("d0", "d1"):
                uncoloured = type3 and op == "d1"
        self.depth -= 1

    def _ext_gstate(self, resources: dict, name) -> None:
        doc = self.doc
        gs = doc.resolve((doc.resolve(resources.get("ExtGState")) or {}).get(str(name))) or {}
        g = self.gs
        for key, value in gs.items():
            value = doc.resolve(value)
            if key == "LW":
                g.lw = float(value)
            elif key == "LC":
                g.cap = int(value)
            elif key == "LJ":
                g.join = int(value)
            elif key == "ML":
                g.miter = float(value)
            elif key == "D":
                g.dash = [float(doc.resolve(v)) for v in doc.resolve(value[0])] or None
                g.phase = float(value[1])
            elif key == "ca":
                g.fill_alpha = _byte(float(value))
            elif key == "CA":
                g.stroke_alpha = _byte(float(value))
            elif key == "SMask":
                if not (isinstance(value, Name) and value == "None"):
                    raise unsupported("soft masks")
            elif key == "BM":
                names = value if isinstance(value, list) else [value]
                if str(doc.resolve(names[0])) not in ("Normal", "Compatible"):
                    raise unsupported(f"the blend mode {names[0]}")
            elif key == "Font":
                g.font = self._load_font(value[0])
                g.size = float(value[1])

    def _font(self, resources: dict, name):
        fonts = self.doc.resolve(resources.get("Font")) or {}
        ref = fonts.get(str(name))
        if ref is None:
            raise unsupported(f"the font resource {name} is missing")
        return self._load_font(ref)

    def _load_font(self, ref):
        key = ref.num if hasattr(ref, "num") else id(ref)
        if key not in self.fonts:
            self.fonts[key] = pdf_fonts.load_font(self.doc, self.doc.resolve(ref))
        return self.fonts[key]

    def _glyph_polys(self, font, gid, trm) -> list:
        """Device polygons of a glyph, flattened once a (font, glyph, scale)
        in text space and moved by ``trm``."""
        scale = math.sqrt(abs(trm[0] * trm[3] - trm[1] * trm[2]))
        bucket = round(math.log2(max(scale, 1e-6)) * 4)
        key = (id(font), gid, bucket)
        polys = self.glyph_cache.get(key)
        if polys is None:
            s = 2.0 ** (bucket / 4.0)
            outline = font.outline(gid)
            polys = [p / s for p, _ in flatten([(c, True) for c in outline], (s, 0, 0, s, 0, 0))]
            self.glyph_cache[key] = polys
        a, b, c, d, e, f = trm
        m = np.array([[a, b], [c, d]])
        return [p @ m + (e, f) for p in polys]

    def _show(self, items: list, tm, text_clip, resources: dict) -> tuple:
        g = self.gs
        font = g.font
        if font is None:
            raise unsupported("text without a font")
        fills: list = []
        for item in items:
            if isinstance(item, (int, float)):
                tx = -float(item) / 1000.0 * g.size * g.th
                tm = mul((1, 0, 0, 1, tx, 0), tm)
                continue
            if not isinstance(item, bytes):
                continue
            for glyph in font.decode(item):
                trm = mul(mul((g.size * g.th, 0, 0, g.size, 0, g.rise), tm), g.ctm)
                if isinstance(font, pdf_fonts.Type3Font):
                    if g.mode == 7:
                        raise unsupported("a Type 3 glyph as a clip")
                    if g.mode != 3:
                        self._type3_glyph(font, glyph.glyph, trm, resources)
                elif g.mode != 3:
                    fills += self._glyph_polys(font, glyph.glyph, trm)
                spacing = g.tw if glyph.nbytes == 1 and glyph.code == 32 else 0.0
                tx = (glyph.width * g.size + g.tc + spacing) * g.th
                tm = mul((1, 0, 0, 1, tx, 0), tm)
        if fills:
            if g.mode in (0, 2):
                self.fill_polys(fills, False, g.fill, g.fill_alpha)
            if g.mode in (1, 2):
                self.stroke_device([(p, True) for p in fills])
            if g.mode == 7 and text_clip is not None:
                text_clip += fills
        return tm

    def _type3_glyph(self, font, name, trm, resources: dict) -> None:
        proc = font.proc(name)
        if not isinstance(proc, Stream):
            return
        saved, depth = self.gs, len(self.stack)
        self.gs = saved.copy()
        self.gs.ctm = mul(tuple(font.matrix), trm)
        self.gs.dash = None
        self.run(proc.data(), font.resources or resources, type3=True)
        self.gs = saved
        del self.stack[depth:]

    def _do(self, resources: dict, name) -> None:
        doc = self.doc
        xobj = doc.resolve((doc.resolve(resources.get("XObject")) or {}).get(str(name)))
        if not isinstance(xobj, Stream):
            return
        sub = str(doc.resolve(xobj.get("Subtype")) or "")
        if sub == "Image":
            self._image(xobj, resources)
        elif sub == "Form":
            group = doc.resolve(xobj.get("Group"))
            if isinstance(group, dict) and group.get("S") == "Transparency":
                if doc.resolve(group.get("SMask")) not in (None, "None"):
                    raise unsupported("a transparency group with a soft mask")
            saved, depth = self.gs, len(self.stack)
            self.gs = saved.copy()
            matrix = doc.resolve(xobj.get("Matrix"))
            if isinstance(matrix, list) and len(matrix) == 6:
                self.gs.ctm = mul(tuple(float(doc.resolve(v)) for v in matrix), self.gs.ctm)
            bbox = _box(xobj.get("BBox"), doc)
            if bbox is not None:
                x0, y0, x1, y1 = bbox
                rect = [("M", x0, y0), ("L", x1, y0), ("L", x1, y1), ("L", x0, y1)]
                self.clip_polys([p for p, _ in flatten([(rect, True)], self.gs.ctm)], False)
            self.run(xobj.data(), xobj.get("Resources") or resources)
            self.gs = saved
            del self.stack[depth:]
        elif sub == "PS":
            return
        else:
            raise unsupported(f"the XObject subtype {sub}")

    # -- images ------------------------------------------------------------------
    def _samples(self, st: Stream, resources: dict, is_mask: bool = False):
        """(uint8 [h, w, nc], stencil) of an image: RGB or gray bytes, or a
        stencil's paint alpha."""
        doc = self.doc
        d = st.dict
        get = lambda k, default=None: doc.resolve(d.get(k, default))  # noqa: E731
        w, h = int(get("Width")), int(get("Height"))
        stencil = bool(get("ImageMask", False))
        bpc = 1 if stencil else int(get("BitsPerComponent", 8) or 8)
        mask = get("Mask")
        if mask is not None and not is_mask:
            raise unsupported("an image /Mask (colour key or stencil)")
        filters, parms = stream_filters(st)
        data = st.raw
        decoded = None
        for fname, parm in zip(filters, parms):
            if fname in IMAGE_FILTERS:
                t0 = time.perf_counter()
                decoded = decode_image_filter(fname, data, parm, plain=self.raster.plain,
                                              height=h)
                self.decode_seconds += time.perf_counter() - t0
                break
            data = apply_filter(fname, data, parm)
        if stencil or is_mask:
            cs = GRAY
        else:
            csobj = get("ColorSpace")
            if csobj is None and decoded is not None and not isinstance(decoded, np.ndarray):
                csobj = Name("DeviceGray")
            cs = color_space(doc, csobj, resources) if csobj is not None else None
        decode = get("Decode")
        if decoded is not None:
            arr = np.asarray(decoded)
            if arr.dtype == np.uint16:
                arr = (arr >> 8).astype(np.uint8)
            if filters and "CCITTFaxDecode" in filters:
                samples = arr.reshape(arr.shape[0], arr.shape[1], 1).astype(np.int64)
                bpc = 1
            else:
                if arr.ndim == 2:
                    arr = arr[..., None]
                if arr.shape[2] in (2, 4):  # JPX alpha: dropped (no SMaskInData)
                    arr = arr[..., :-1]
                if cs is None:
                    cs = GRAY if arr.shape[2] == 1 else RGB
                samples = arr.astype(np.int64)
                bpc = 8
            h, w = samples.shape[:2]
            ncomp = samples.shape[2]
        else:
            ncomp = 1 if (stencil or is_mask) else cs.n
            samples = _unpack(data, w, h, ncomp, bpc)
        maxv = (1 << bpc) - 1
        if stencil:
            dec = [float(doc.resolve(v)) for v in decode] if decode else [0.0, 1.0]
            painted = samples[..., 0] == (0 if dec[0] < dec[1] else maxv)
            return np.where(painted, 255, 0).astype(np.uint8)[..., None], True
        if decode:
            dec = [float(doc.resolve(v)) for v in decode]
        elif cs is not None and cs.kind == "Indexed":
            dec = [0.0, float(maxv)]
        else:
            dec = [0.0, 1.0] * ncomp
        if is_mask:
            vals = dec[0] + samples[..., 0] * ((dec[1] - dec[0]) / maxv)
            return np.clip(np.floor(vals * 255 + 0.5), 0, 255).astype(np.uint8)[..., None], False
        identity = all(dec[2 * i] == 0.0 and dec[2 * i + 1] == 1.0 for i in range(ncomp))
        if cs.kind == "Indexed":
            idx = np.clip(np.floor(dec[0] + samples[..., 0] * ((dec[1] - dec[0]) / maxv) + 0.5),
                          0, cs.hival).astype(np.int64)
            lut = np.array([cs.rgb([i]) for i in range(cs.hival + 1)], np.uint8)
            return lut[idx], False
        if identity and bpc == 8:
            vals8 = samples.astype(np.uint8)
        else:
            comps = [dec[2 * i] + samples[..., i] * ((dec[2 * i + 1] - dec[2 * i]) / maxv)
                     for i in range(ncomp)]
            vals8 = np.stack([np.clip(np.floor(c * 255 + 0.5), 0, 255) for c in comps],
                             -1).astype(np.uint8)
        if cs.kind == "DeviceGray" or (cs.n == 1 and ncomp == 1):
            return vals8[..., :1], False
        if cs.kind == "DeviceRGB" or ncomp == 3:
            return vals8[..., :3], False
        c, m, y, k = (vals8[..., i].astype(np.int32) for i in range(4))
        rgb = np.stack([255 - np.minimum(255, v + k) for v in (c, m, y)], -1)
        return rgb.astype(np.uint8), False

    def _image(self, st: Stream, resources: dict) -> None:
        """An image XObject or inline image (its abbreviated colour spaces
        are ``_DEVICE``'s and ``color_space``'s names too)."""
        src, stencil = self._samples(st, resources)
        g = self.gs
        smask = None
        sm = self.doc.resolve(st.get("SMask"))
        if isinstance(sm, Stream):
            smask = self._samples(sm, resources, is_mask=True)[0]
        placed = self._place(src, g.ctm)
        if placed is None:
            return
        box, colour, cov = placed
        if smask is not None:
            placed_mask = self._place(smask, g.ctm, box)
            if placed_mask is not None:
                _, mcol, mcov = placed_mask
                alpha = (mcol[..., 0].astype(np.int32) * mcov + 127) // 255
                cov = ((cov.astype(np.int32) * alpha + 127) // 255).astype(np.uint8)
        if stencil:
            cov = ((cov.astype(np.int32) * colour[..., 0] + 127) // 255).astype(np.uint8)
            self.raster.composite(self.page, box, cov, None, g.fill, g.fill_alpha, g.clip)
            return
        if colour.shape[2] == 1:
            colour = np.repeat(colour, 3, axis=2)
        self.raster.composite(self.page, box, cov, np.ascontiguousarray(colour), None,
                              g.fill_alpha, g.clip)

    def _place(self, src: np.ndarray, ctm, box=None):
        """Resample ``src`` (uint8 [h, w, nc]) through the image space map
        onto the page: (box, colour [bh, bw, nc], coverage [bh, bw])."""
        h, w = src.shape[:2]
        a, b, c, d, e, f = ctm
        # Source pixel (col, row) -> device: X = s00 col + s01 row + s02, Y = s10 col + s11 row + s12.
        s00, s01, s02 = a / w, -c / h, c + e
        s10, s11, s12 = b / w, -d / h, d + f
        scale = max(abs(s00), abs(s01), abs(s10), abs(s11))
        eps = 1e-9 * max(scale, 1e-30)
        if abs(s01) <= eps and abs(s10) <= eps:
            return self._place_axes(src, s00, s02, s11, s12, box)
        if abs(s00) <= eps and abs(s11) <= eps:
            # A quarter turn: transpose the source, then it is axis aligned.
            return self._place_axes(np.ascontiguousarray(src.transpose(1, 0, 2)), s10, s12, s01,
                                    s02, box, swap=True)
        return self._place_affine(src, (s00, s01, s02, s10, s11, s12), box)

    def _place_axes(self, src, sx, ox, sy, oy, box, swap: bool = False):
        if swap:
            # After the transpose the source's columns run along Y and its rows along X.
            sx, ox, sy, oy = sy, oy, sx, ox
        if sx < 0:
            src = src[:, ::-1]
        if sy < 0:
            src = src[::-1]
        h, w = src.shape[:2]
        x_lo, x_hi = sorted((ox, ox + sx * w))
        y_lo, y_hi = sorted((oy, oy + sy * h))
        X0, Y0, X1, Y1 = round_rect(x_lo, y_lo, x_hi, y_hi)
        X1, Y1 = max(X1, X0 + 1), max(Y1, Y0 + 1)
        if box is None:
            box = self._visible((X0, Y0, X1, Y1))
            if box is None:
                return None
        bx, by, bw, bh = box
        xi, xw = axis_table(w, X1 - X0)
        yi, yw = axis_table(h, Y1 - Y0)
        cols = np.arange(bx, bx + bw) - X0
        rows = np.arange(by, by + bh) - Y0
        cov = np.full((bh, bw), 255, np.uint8)
        cin, rin = (cols >= 0) & (cols < X1 - X0), (rows >= 0) & (rows < Y1 - Y0)
        cov[~rin, :] = 0
        cov[:, ~cin] = 0
        cols, rows = np.clip(cols, 0, X1 - X0 - 1), np.clip(rows, 0, Y1 - Y0 - 1)
        colour = self.raster.resample_axes(np.ascontiguousarray(src), (xi[cols], xw[cols]),
                                           (yi[rows], yw[rows]))
        return box, colour, cov

    def _place_affine(self, src, s, box):
        h, w = src.shape[:2]
        s00, s01, s02, s10, s11, s12 = s
        corners = [(s00 * x + s01 * y + s02, s10 * x + s11 * y + s12)
                   for x in (0, w) for y in (0, h)]
        if box is None:
            xs, ys = [p[0] for p in corners], [p[1] for p in corners]
            box = self._visible(round_rect(min(xs), min(ys), max(xs), max(ys)))
            if box is None:
                return None
        inv = invert((s00, s10, s01, s11, s02, s12))
        # page pixel (X, Y) centre -> source: col = i0 (X+.5) + i2 (Y+.5) + i4 ...
        i0, i1, i2, i3, i4, i5 = inv
        one = 65536.0
        m = np.array([round(i0 * one), round(i2 * one), round((0.5 * i0 + 0.5 * i2 + i4) * one),
                      round(i1 * one), round(i3 * one), round((0.5 * i1 + 0.5 * i3 + i5) * one)],
                     np.int64)
        colour, cov = self.raster.resample_affine(np.ascontiguousarray(src), m, box)
        return box, colour, cov

    # -- the page ----------------------------------------------------------------
    def render(self) -> np.ndarray:
        doc = self.doc
        page = self.page_dict
        for annot in doc.resolve(page.get("Annots")) or []:
            annot = doc.resolve(annot)
            if not isinstance(annot, dict):
                continue
            flags = int(doc.resolve(annot.get("F", 0)) or 0)
            ap = doc.resolve(annot.get("AP"))
            if isinstance(ap, dict) and ap.get("N") is not None and not flags & 2:
                raise unsupported("annotation appearance streams")
        contents = doc.resolve(page.get("Contents"))
        streams = contents if isinstance(contents, list) else [contents]
        data = b"\n".join(doc.resolve(s).data() for s in streams
                          if isinstance(doc.resolve(s), Stream))
        self.run(data, page.get("Resources"))
        return self.page


def _unpack(data: bytes, w: int, h: int, ncomp: int, bpc: int) -> np.ndarray:
    """Samples ``[h, w, ncomp]`` (int64) of packed rows (each row padded to
    a byte)."""
    row_bytes = (w * ncomp * bpc + 7) // 8
    need = row_bytes * h
    raw = np.frombuffer(data[:need].ljust(need, b"\0"), np.uint8).reshape(h, row_bytes)
    if bpc == 8:
        vals = raw[:, :w * ncomp].astype(np.int64)
    elif bpc == 16:
        vals = raw[:, :2 * w * ncomp:2].astype(np.int64)  # the high byte
        return (vals.reshape(h, w, ncomp) * 257)
    elif bpc in (1, 2, 4):
        bits = np.unpackbits(raw, axis=1)[:, :w * ncomp * bpc].reshape(h, w * ncomp, bpc)
        weights = (1 << np.arange(bpc - 1, -1, -1)).astype(np.int64)
        vals = (bits.astype(np.int64) * weights).sum(-1)
    else:
        raise unsupported(f"{bpc} bits a component")
    return vals.reshape(h, w, ncomp)


def axis_table(n_src: int, n_dst: int) -> tuple[np.ndarray, np.ndarray]:
    """One axis's weights (indices, 14-bit weights; int32 ``[n_dst, taps]``):
    a copy at 1:1, area averages when shrinking, bilinear when enlarging."""
    one = 1 << WEIGHT_BITS
    if n_dst == n_src:
        return (np.arange(n_dst, dtype=np.int32)[:, None],
                np.full((n_dst, 1), one, np.int32))
    if n_dst > n_src:
        j = np.arange(n_dst, dtype=np.int64)
        num = (2 * j + 1) * n_src - n_dst
        den = 2 * n_dst
        i0 = num // den
        frac = num - i0 * den
        w1 = (frac * one + n_dst) // den
        idx = np.stack([np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1)], 1)
        wts = np.stack([one - w1, w1], 1)
        return idx.astype(np.int32), wts.astype(np.int32)
    taps = -(-n_src // n_dst) + 1
    idx = np.zeros((n_dst, taps), np.int32)
    wts = np.zeros((n_dst, taps), np.int32)
    for j in range(n_dst):
        lo, hi = j * n_src, (j + 1) * n_src  # in 1 / n_dst of a source pixel
        first, last = lo // n_dst, (hi - 1) // n_dst
        ids = np.arange(first, last + 1)
        overlap = np.minimum((ids + 1) * n_dst, hi) - np.maximum(ids * n_dst, lo)
        w = overlap * one // n_src
        w[int(np.argmax(w))] += one - int(w.sum())
        idx[j, :len(ids)] = ids
        wts[j, :len(ids)] = w
    return idx, wts


def render_page(doc, page: dict, dpi: float = 200, plain: bool = False,
                stats: dict | None = None, zoom: float | None = None) -> np.ndarray:
    """A page at ``dpi`` (``zoom = dpi / 72`` pixels a point, as the JAX
    package's ``fitz.Matrix``; or ``zoom`` itself) as RGB uint8 ``[H, W,
    3]``. ``plain`` runs the numpy raster steps instead of the C++ ones;
    ``stats`` gets the seconds of the whole render (``render_s``), of the
    raster steps (``raster_s``) and of the image filters (``decode_s``:
    JPEG, JPEG 2000, CCITT)."""
    t0 = time.perf_counter()
    renderer = Renderer(doc, page, dpi / 72.0 if zoom is None else zoom, plain=plain)
    out = renderer.render()
    if stats is not None:
        stats["render_s"] = stats.get("render_s", 0.0) + time.perf_counter() - t0
        stats["raster_s"] = stats.get("raster_s", 0.0) + renderer.raster.seconds
        stats["decode_s"] = stats.get("decode_s", 0.0) + renderer.decode_seconds
    return out
