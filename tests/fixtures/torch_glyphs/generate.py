"""Write the DejaVu glyph atlas that the PyTorch port's text renderer reads.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/fixtures/torch_glyphs/generate.py

Needs Pillow (with raqm), fontTools, matplotlib and the system DejaVu fonts:
the JAX package's ``data/phenikaa/synth.py`` draws its lines and pages with
``ImageFont.truetype`` from those files, and the port, which imports none of
them, composites the same text from this atlas
(``spine_vision_torch/data/phenikaa/glyphs/dejavu.npz``,
``spine_vision_torch/data/phenikaa/text.py``).

What Pillow does with a string, measured here and kept per face and size:

- raqm lays the text out in 26.6 pixels: each character advances the pen
  by its advance, plus a kerning adjustment after it that depends on the
  next character (pairs whose adjustment is nonzero are kept);
- each glyph is rendered once, whole-pixel, at the rounded pen position; a
  character the face lacks (the Mono faces have no precomposed "ẫ" and 45
  others) is drawn as a base and combining marks, each rounded on its own,
  so its bitmap depends on the pen's fraction: those characters keep one
  bitmap for each of the 64 fractions;
- the glyph bitmaps of a string are merged into one mask, each over the
  last (``s + d - s * d / 255``), and the mask blends the fill into the
  image;
- ``textbbox`` spans the pen line from 0 to the rounded end pen and each
  glyph's outline box in whole pixels (``FT_GLYPH_BBOX_PIXELS``), and the
  glyphs' ascender-relative tops and bottoms.

Each glyph's outline box is read from Pillow: ``getbbox`` in top-to-bottom
layout gives its width; the glyph's ink and the horizontal ``getbbox`` place
it (an edge that passes the pen line is pinned, and the box lies within the
pen line otherwise); where the box may end exactly at the rounded advance,
which shows only where the pen's fraction rounds the glyph's end past the
string's, the glyph drawn after a run of spaces with such a fraction tells;
what is left open takes the unhinted outline's box in the font file
(fontTools), and cannot move a ``textbbox``.

:func:`build` makes the arrays for any subset of faces, sizes and
characters (``tests/test_torch_synth.py`` holds the committed atlas to it on
a subset).
"""

from __future__ import annotations

import hashlib
import sys
import unicodedata
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "spine_vision_torch" / "data" / "phenikaa" / "glyphs" / "dejavu.npz"
# Every size synth.py asks for: lines 18-26 (22 unaugmented), pages 14-21
# (18), the report page 20, the variant page 13-21.
SIZES = tuple(range(13, 27))
REPORT_STRINGS = (
    "BỆNH VIỆN ĐẠI HỌC PHENIKAA", "PHIẾU CHỈ ĐỊNH CHỤP MRI", "Số phiếu: ",
    "Họ tên người bệnh: ", "Ngày sinh: ", "Chẩn đoán: Thoát vị đĩa đệm",
    "SỞ Y TẾ HÀ NỘI", "Đường Nguyễn Trác, Hà Đông", "Số phiếu:", "Giới tính",
    "Nữ", "Nam", "Địa chỉ", "Số 12 Tô Hiệu, Hà Đông, Hà Nội",
    "Thoát vị đĩa đệm L4/L5", " :", "Ngày chỉ định: ",
)


def font_paths() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """The JAX package's trained and holdout faces, in its order."""
    sys.path.insert(0, str(ROOT))
    from spine_vision_tpu.data.phenikaa import synth

    return tuple(synth.FONT_PATHS), tuple(synth.HOLDOUT_FONT_PATHS)


def all_chars() -> str:
    """Every character synth draws: the charset, the name pools, the field
    labels and the report pages' strings."""
    sys.path.insert(0, str(ROOT))
    from spine_vision_tpu.data.phenikaa import synth
    from spine_vision_tpu.models.textrec import VIETNAMESE_CHARSET

    pool = "".join(synth.SURNAMES + synth.MIDDLE_NAMES + synth.GIVEN_NAMES
                   + synth.FIELD_LABELS + REPORT_STRINGS)
    extra = sorted(set(pool) - set(VIETNAMESE_CHARSET))
    return VIETNAMESE_CHARSET + "".join(extra)


def _ink(font, text: str, phase: int = 0) -> tuple[np.ndarray, int, int]:
    """The tight ink bitmap of ``text`` drawn at pen fraction ``phase``/64,
    with its left and top relative to the drawing origin."""
    mask, off = font.getmask2(text, mode="L", start=(phase / 64, 0))
    w, h = mask.size
    a = np.asarray(mask, np.uint8).reshape(h, w) if w * h else np.zeros((0, 0), np.uint8)
    if a.size == 0 or a.max() == 0:
        return np.zeros((0, 0), np.uint8), 0, 0
    rows, cols = np.nonzero(a.max(1))[0], np.nonzero(a.max(0))[0]
    return (np.ascontiguousarray(a[rows[0] : rows[-1] + 1, cols[0] : cols[-1] + 1]),
            int(off[0] + cols[0]), int(off[1] + rows[0]))


def _mulfix(a: int, b: int) -> int:
    """FreeType's ``FT_MulFix``: ``a * b / 65536`` rounded, sign apart."""
    sign = -1 if (a < 0) != (b < 0) else 1
    return sign * ((abs(a) * abs(b) + 0x8000) >> 16)


def _right_probe(font, ch: str, adv: int) -> tuple[int, int] | None:
    """Where the pen fraction lets ``ch``'s box pass the end of the pen line:
    ``(box right - rounded pen, the end - rounded pen)`` of ``ch`` drawn
    after a run of spaces whose end pen has a fraction f with PIXEL(f) +
    PIXEL(adv) > PIXEL(f + adv), read from that string's ``getbbox``. Only
    an advance whose fraction is at least one half has such an f (and only
    there can a box that ends at the rounded advance pass the pen line);
    None otherwise, or where no run of up to 32 spaces gives one."""
    a = adv & 63
    if a < 32:
        return None
    for n in range(1, 33):
        text = " " * n + ch
        total = round(font.getlength(text) * 64)
        pen = total - adv
        if 32 <= (pen & 63) <= 95 - a:
            px = (pen + 32) >> 6
            return font.getbbox(text)[2] - px, ((total + 32) >> 6) - px
    return None


def _outline_box(font, ch: str, ink: tuple[int, int] | None, estimate: tuple[int, int]
                 ) -> tuple[int, int]:
    """The glyph's outline box in whole pixels about its rounded pen.

    Its width is the top-to-bottom layout's ``getbbox`` width; it covers the
    ink; the horizontal ``getbbox`` pins an edge that passes the pen line
    (0 on the left, the rounded advance on the right) and bounds the box
    within it otherwise; where the box may end at the rounded advance,
    :func:`_right_probe` tells whether it does. What is left open places it
    nearest ``estimate``, the box of the unhinted outline in the font file."""
    if ink is None:
        return 0, 0
    ttb = font.getbbox(ch, direction="ttb")
    width = ttb[2] - ttb[0]
    h0, _, h1, _ = font.getbbox(ch)
    adv = round(font.getlength(ch) * 64)
    adv_px = (adv + 32) >> 6
    il, ir = ink
    if h0 < 0:
        return h0, h0 + width
    if h1 > adv_px:
        return h1 - width, h1
    # Every left edge that keeps the ink inside the box and the box inside
    # the horizontal getbbox (which spans the box and the pen line).
    lo, hi = max(ir - width, h0), min(il, h1 - width)
    if lo > hi:
        return il, ir
    probe = _right_probe(font, ch, adv) if lo < hi else None
    if probe is not None:
        right, end = probe
        if right > end:  # the box passes the pen line: its right edge, exactly
            lo = hi = min(max(right - width, lo), hi)
        else:  # it ends before the rounded advance
            hi = max(lo, min(hi, end - width))
    x0 = min(max(estimate[0], lo), hi)
    return x0, x0 + width


def build(paths, sizes, chars: str) -> dict[str, np.ndarray]:
    """The atlas arrays for ``paths`` x ``sizes`` x ``chars``."""
    import PIL
    from fontTools.ttLib import TTFont
    from PIL import ImageFont, features

    n_f, n_s, n_c = len(paths), len(sizes), len(chars)
    advance = np.zeros((n_f, n_s, n_c), np.int32)
    bbox_y = np.zeros((n_f, n_s, n_c, 2), np.int16)
    cbox_x = np.zeros((n_f, n_s, n_c, 2), np.int16)
    first = np.zeros((n_f, n_s, n_c), np.int32)
    phased = np.zeros((n_f, n_c), bool)
    var_bitmap, var_left, var_top = [], [], []
    bitmaps: list[np.ndarray] = []
    seen: dict[bytes, int] = {}
    kern_fs, kern_pair, kern_value = [], [], []

    def bitmap_index(a: np.ndarray) -> int:
        key = a.shape[0].to_bytes(2, "little") + a.shape[1].to_bytes(2, "little") + a.tobytes()
        if key not in seen:
            seen[key] = len(bitmaps)
            bitmaps.append(a)
        return seen[key]

    for fi, path in enumerate(paths):
        tt = TTFont(path)
        cmap, glyf, upem = tt.getBestCmap(), tt["glyf"], tt["head"].unitsPerEm
        phased[fi] = [ord(c) not in cmap for c in chars]
        for si, size in enumerate(sizes):
            font = ImageFont.truetype(path, size)
            scale = ((size * 64 << 16) + upem // 2) // upem
            lengths = {}
            boxes = {}
            for ci, ch in enumerate(chars):
                lengths[ch] = font.getlength(ch)
                advance[fi, si, ci] = round(lengths[ch] * 64)
                bb = font.getbbox(ch)
                bbox_y[fi, si, ci] = (bb[1], bb[3])
                first[fi, si, ci] = len(var_bitmap)
                for phase in range(64 if phased[fi, ci] else 1):
                    a, left, top = _ink(font, ch, phase)
                    var_bitmap.append(bitmap_index(a))
                    var_left.append(left)
                    var_top.append(top)
                # A decomposed character's box is its base glyph's.
                base = unicodedata.normalize("NFD", ch)[0] if phased[fi, ci] else ch
                if base not in boxes:
                    a, left, _ = _ink(font, base)
                    g = glyf[cmap[ord(base)]]
                    estimate = (0, 0)
                    if getattr(g, "numberOfContours", 0) and hasattr(g, "xMin"):
                        estimate = (_mulfix(g.xMin, scale) >> 6, -(-_mulfix(g.xMax, scale) >> 6))
                    boxes[base] = _outline_box(
                        font, base, (left, left + a.shape[1]) if a.size else None, estimate)
                cbox_x[fi, si, ci] = boxes[base]
            for ai, a in enumerate(chars):
                for bi, b in enumerate(chars):
                    k = round((font.getlength(a + b) - lengths[a] - lengths[b]) * 64)
                    if k:
                        kern_fs.append(fi * n_s + si)
                        kern_pair.append((ai, bi))
                        kern_value.append(k)

    offsets = np.cumsum([0] + [b.size for b in bitmaps])
    return {
        "faces": np.array([Path(p).stem for p in paths]),
        "sizes": np.asarray(sizes, np.int32),
        "chars": np.array([ord(c) for c in chars], np.int32),
        "advance": advance,
        "bbox_y": bbox_y,
        "cbox_x": cbox_x,
        "phased": phased,
        "first_variant": first,
        "variant_bitmap": np.asarray(var_bitmap, np.int32),
        "variant_left": np.asarray(var_left, np.int16),
        "variant_top": np.asarray(var_top, np.int16),
        "bitmap_data": np.concatenate([b.ravel() for b in bitmaps]).astype(np.uint8),
        "bitmap_offset": offsets[:-1].astype(np.int64),
        "bitmap_shape": np.array([b.shape for b in bitmaps], np.int16).reshape(-1, 2),
        "kern_fs": np.asarray(kern_fs, np.int32),
        "kern_pair": np.asarray(kern_pair, np.int32).reshape(-1, 2),
        "kern_value": np.asarray(kern_value, np.int32),
        "font_sha256": np.array([hashlib.sha256(Path(p).read_bytes()).hexdigest()
                                 for p in paths]),
        "pillow_version": np.array(PIL.__version__),
        "freetype_version": np.array(features.version("freetype2")),
        "raqm_version": np.array(features.version("raqm") or ""),
    }


def main() -> None:
    trained, holdout = font_paths()
    arrays = build(trained + holdout, SIZES, all_chars())
    arrays["n_trained"] = np.array(len(trained))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
