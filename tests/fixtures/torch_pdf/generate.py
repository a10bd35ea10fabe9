"""Write the PDF fixtures and their record.

    python tests/fixtures/torch_pdf/generate.py

Needs matplotlib, Pillow and fontTools, and the DejaVu fonts that the OCR
was trained on (``spine_vision_tpu/data/phenikaa/synth.py``); the PDFs and
``record.json`` are committed, so a host without those tools (the card's)
reads them. The files:

- Raster pages written by Pillow (``Image.save(..., resolution=r)``):
  ``raster_gray_150.pdf`` and ``raster_gray_200.pdf`` (the OCR fixture
  ``tests/fixtures/torch_ocr/report_clean.png``, gray DCT), ``raster_rgb_300.pdf``
  (the same page tinted, RGB DCT), ``raster_bilevel_200.pdf`` (its
  ``convert("1")``, CCITT G4 with ``/BlackIs1 true``) and ``scan_a4_200.pdf``
  (an A4 report page drawn by Agg at 200 dpi, speckled, gray DCT at quality
  80: a scanned report).
- Vector reports written by matplotlib (:func:`report_figure`): the six
  lines of ``synth.py::render_report_page`` on A4 in DejaVu Sans at 7.2 pt
  (20 px at 200 dpi, the synth's em), the report number inside
  ``DEFAULT_PDF_ID_CROP_REGION`` (``(1100, 200, 1500, 400)`` at 200 dpi),
  table rules and a clipped rectangle: ``report_type42.pdf`` and
  ``report_type42_b.pdf`` (``pdf.fonttype`` 42, Type0/CIDFontType2) and
  ``report_type3.pdf`` (``pdf.fonttype`` 3).
- Files of a small writer here, for what the two tools do not write:
  ``truetype_simple.pdf`` (a simple TrueType font, WinAnsi with
  ``/Differences``), ``cff_type1c.pdf`` (a CFF font made with fontTools from
  DejaVu's outlines, charstrings calling local and global subroutines),
  ``xref_stream.pdf`` (objects in an object stream, an xref stream with the
  PNG Up predictor), ``incremental.pdf`` (an update through ``/Prev`` that
  replaces the page's content), ``broken_xref.pdf`` (wrong ``startxref`` and
  offsets: repaired), ``rotate90.pdf`` (a CropBox inside the MediaBox,
  ``/Rotate 90``), ``images.pdf`` (an inline image in each of the ASCII
  filters, an image with an ``/SMask``, enlarged, shrunk and turned
  images, a stencil mask, an Indexed image, CMYK and even-odd fills,
  dashes, caps and joins), ``no_pages.pdf`` (a page tree with no pages) and
  ``unsupported_*.pdf``, one feature each that raises ROADMAP Queue 1 item 13.

``record.json`` holds each page's raster shape and the sha256 of the port's
render at 200 dpi (``spine_vision_torch/io/pdf.py``), the report fields,
the raster pages' sources, and what each unsupported file names.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
OCR_PAGE = ROOT / "tests" / "fixtures" / "torch_ocr" / "report_clean.png"
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
A4_IN = (210 / 25.4, 297 / 25.4)
DPI = 200
STAMP = __import__("time").gmtime(1752796800)  # Pillow's dates, fixed (2025-07-18)

# Report fields: (file, fonttype, name, birthday, id). Each patient's
# crop-path ID and full-page birthday are what the OCR must read.
REPORTS = (
    ("report_type42.pdf", 42, "Nguyễn Văn An", "15/05/1980", "250012345"),
    ("report_type42_b.pdf", 42, "Trần Thị Bình", "02/09/1975", "250067890"),
    ("report_type3.pdf", 3, "Lê Văn Cường", "21/11/1962", "250024680"),
)
SCAN = ("scan_a4_200.pdf", 42, "Phạm Thị Dung", "08/03/1990", "250013579")


def report_lines(name: str, birthday: str, report_id: str) -> list:
    """``synth.py::render_report_page``'s six lines, each with its top-left
    corner in pixels at 200 dpi: the report number inside the ID crop."""
    return [
        ("BỆNH VIỆN ĐẠI HỌC PHENIKAA", 150, 150),
        ("PHIẾU CHỈ ĐỊNH CHỤP MRI", 150, 192),
        (f"Số phiếu: {report_id}", 1120, 290),
        (f"Họ tên người bệnh: {name}", 150, 420),
        (f"Ngày sinh: {birthday}", 150, 462),
        ("Chẩn đoán: Thoát vị đĩa đệm", 150, 504),
    ]


def report_figure(name: str, birthday: str, report_id: str, fonttype: int = 42):
    """The A4 report as a matplotlib figure (drawn by the PDF backend here
    and by Agg in ``tests/test_torch_pdf.py``)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.figure import Figure
    from matplotlib.lines import Line2D
    from matplotlib.patches import Rectangle

    matplotlib.rcParams.update({"pdf.fonttype": fonttype, "font.family": "DejaVu Sans",
                                "text.hinting": "no_hinting", "text.hinting_factor": 1,
                                "svg.hashsalt": "0", "path.simplify": False})
    fig = Figure(figsize=A4_IN)
    wpx, hpx = A4_IN[0] * DPI, A4_IN[1] * DPI

    def fx(x):
        return x / wpx

    def fy(y):
        return 1 - y / hpx

    for text, x, y in report_lines(name, birthday, report_id):
        fig.text(fx(x), fy(y), text, fontsize=7.2, color="black", va="top", ha="left")
    for k, y in enumerate((560, 620, 680, 740)):
        fig.add_artist(Line2D([fx(150), fx(1500)], [fy(y), fy(y)], lw=0.5 if k else 1.0,
                              color="black"))
    for x in (150, 700, 1500):
        fig.add_artist(Line2D([fx(x), fx(x)], [fy(560), fy(740)], lw=0.5, color="black"))
    clip = Rectangle((fx(200), fy(1100)), fx(500) - fx(200), fy(900) - fy(1100),
                     transform=fig.transFigure, visible=False)
    fig.add_artist(clip)
    shape = Rectangle((fx(300), fy(1200)), fx(300), fy(800) - fy(1200), facecolor="0.8",
                      edgecolor="0.2", lw=2.0, transform=fig.transFigure)
    fig.add_artist(shape)
    shape.set_clip_path(clip)
    return fig


def save_pdf(fig, path: Path) -> None:
    from matplotlib.backends.backend_pdf import FigureCanvasPdf

    FigureCanvasPdf(fig)
    buf = io.BytesIO()
    fig.savefig(buf, format="pdf", metadata={"CreationDate": None, "Creator": None,
                                              "Producer": None})
    path.write_bytes(buf.getvalue())


def agg_gray(fig, dpi: int = DPI) -> np.ndarray:
    """Agg's raster of the figure, gray (Pillow's ``L`` of its RGB)."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg

    canvas = FigureCanvasAgg(fig)
    fig.set_dpi(dpi)
    canvas.draw()
    rgba = np.asarray(canvas.buffer_rgba())
    r, g, b = (rgba[..., i].astype(np.int64) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)


# -- a small PDF writer ------------------------------------------------------------------
class N(str):
    """A name."""


class R(int):
    """A reference to object n."""


def ser(v) -> bytes:
    if v is None:
        return b"null"
    if v is True:
        return b"true"
    if v is False:
        return b"false"
    if isinstance(v, R):
        return b"%d 0 R" % int(v)
    if isinstance(v, N):
        return b"/" + str(v).encode()
    if isinstance(v, int):
        return str(v).encode()
    if isinstance(v, float):
        return (f"{v:.6f}".rstrip("0").rstrip(".") or "0").encode()
    if isinstance(v, bytes):
        return b"<" + v.hex().encode() + b">"
    if isinstance(v, str):
        return b"(" + v.encode("latin-1").replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)") + b")"
    if isinstance(v, (list, tuple)):
        return b"[" + b" ".join(ser(x) for x in v) + b"]"
    if isinstance(v, dict):
        return b"<<" + b" ".join(b"/" + k.encode() + b" " + ser(x) for k, x in v.items()) + b">>"
    raise TypeError(type(v))


class Writer:
    def __init__(self):
        self.objs: dict[int, bytes] = {}

    def add(self, obj, num: int | None = None) -> R:
        num = num or len(self.objs) + 1
        self.objs[num] = ser(obj)
        return R(num)

    def stream(self, d: dict, data: bytes, num: int | None = None, flate: bool = True) -> R:
        d = dict(d)
        if flate:
            data = zlib.compress(data, 9)
            d["Filter"] = N("FlateDecode")
        d["Length"] = len(data)
        num = num or len(self.objs) + 1
        self.objs[num] = ser(d) + b"\nstream\n" + data + b"\nendstream"
        return R(num)

    def page_doc(self, content: bytes, resources: dict, media=(0, 0, 595.276, 841.89),
                 extra: dict | None = None) -> R:
        c = self.stream({}, content)
        pages_num = len(self.objs) + 3
        page = self.add({"Type": N("Page"), "Parent": R(pages_num), "MediaBox": list(media),
                         "Resources": resources, "Contents": c, **(extra or {})})
        root = self.add({"Type": N("Catalog"), "Pages": R(pages_num)})
        self.add({"Type": N("Pages"), "Kids": [page], "Count": 1}, pages_num)
        return root

    def classic(self, root: R, extra_trailer: dict | None = None) -> bytes:
        out = bytearray(b"%PDF-1.7\n%\xe2\xe3\xcf\xd3\n")
        offsets = {}
        for num in sorted(self.objs):
            offsets[num] = len(out)
            out += b"%d 0 obj\n" % num + self.objs[num] + b"\nendobj\n"
        size = max(self.objs) + 1
        xref = len(out)
        out += b"xref\n0 %d\n0000000000 65535 f \n" % size
        for num in range(1, size):
            out += (b"%010d 00000 n \n" % offsets[num]) if num in offsets else b"0000000000 65535 f \n"
        trailer = {"Size": size, "Root": root, **(extra_trailer or {})}
        out += b"trailer\n" + ser(trailer) + b"\nstartxref\n%d\n%%%%EOF\n" % xref
        return bytes(out)


def _content_font_text(font: str, size: float, x: float, y: float, text: bytes) -> bytes:
    return b"BT /%s %g Tf %g %g Td <%s> Tj ET\n" % (font.encode(), size, x, y, text.hex().encode())


def dejavu_subset(chars: str) -> bytes:
    from fontTools import subset
    from fontTools.ttLib import TTFont

    font = TTFont(FONT, recalcTimestamp=False)
    opts = subset.Options()
    opts.hinting = False
    opts.notdef_outline = True
    opts.name_IDs = []
    opts.layout_features = []
    sub = subset.Subsetter(opts)
    sub.populate(unicodes=[ord(c) for c in chars])
    sub.subset(font)
    buf = io.BytesIO()
    font.save(buf)
    return buf.getvalue()


SIMPLE_LINES = ("BỆNH VIỆN ĐẠI HỌC PHENIKAA", "Số phiếu: 250012345",
                "Họ tên người bệnh: Nguyễn Văn An")


def _winansi_bytes(text: str, extra_codes: dict) -> bytes:
    out = bytearray()
    for ch in text:
        if ch in extra_codes:
            out.append(extra_codes[ch])
        else:
            out += ch.encode("cp1252")
    return bytes(out)


def _not_winansi(text: str) -> list:
    out = set()
    for ch in text:
        try:
            ch.encode("cp1252")
        except UnicodeEncodeError:
            out.add(ch)
    return sorted(out)


def simple_truetype_pdf() -> bytes:
    """A simple TrueType font (a DejaVu subset): WinAnsi, with the
    Vietnamese letters outside it named at codes 1-31 by /Differences."""
    from fontTools.ttLib import TTFont

    text = "".join(SIMPLE_LINES) + "StrokedKerned"
    extra = _not_winansi(text)
    data = dejavu_subset("".join(sorted(set(text))))
    font = TTFont(io.BytesIO(data))
    upm = font["head"].unitsPerEm
    cmap = font.getBestCmap()
    hmtx = font["hmtx"]
    codes = {ch: 1 + i for i, ch in enumerate(extra)}
    widths = []
    for code in range(1, 256):
        if code <= len(extra):
            u = ord(extra[code - 1])
        elif code < 32:
            u = None
        else:
            try:
                u = ord(bytes([code]).decode("cp1252"))
            except UnicodeDecodeError:
                u = None
        g = cmap.get(u) if u is not None else None
        widths.append(round(hmtx[g][0] * 1000 / upm) if g else 0)
    w = Writer()
    ff = w.stream({"Length1": len(data)}, data)
    desc = w.add({"Type": N("FontDescriptor"), "FontName": N("DejaVuSans"), "Flags": 32,
                  "FontBBox": [-1021, -463, 1794, 1233], "ItalicAngle": 0, "Ascent": 928,
                  "Descent": -236, "CapHeight": 729, "StemV": 80, "FontFile2": ff})
    diffs = [1] + [N(f"uni{ord(ch):04X}") for ch in extra]
    fnt = w.add({"Type": N("Font"), "Subtype": N("TrueType"), "BaseFont": N("DejaVuSans"),
                 "FirstChar": 1, "LastChar": 255, "Widths": widths, "FontDescriptor": desc,
                 "Encoding": {"Type": N("Encoding"), "BaseEncoding": N("WinAnsiEncoding"),
                              "Differences": diffs}})
    body = b"0 0 0.55 rg\n"
    for i, line in enumerate(SIMPLE_LINES):
        body += _content_font_text("F1", 14 - 2 * i, 40, 160 - 36 * i,
                                   _winansi_bytes(line, codes))
    body += b"BT /F1 12 Tf 2 Tr 0.5 w 1 0 0 RG 40 40 Td 3 Tc 120 Tz (Stroked) Tj ET\n"
    body += b"BT /F1 12 Tf 1 Tr 0.3 w 240 40 Td [(Ke) 120 (rned)] TJ ET\n"
    root = w.page_doc(body, {"Font": {"F1": fnt}}, media=(0, 0, 400, 200))
    return w.classic(root)


def cff_font(chars: str) -> tuple[bytes, dict, int]:
    """A CFF (Type1C) font of DejaVu's outlines for ``chars``: its bytes,
    {char: glyph name} and units per em. Each charstring keeps its first
    moveto and calls a subroutine (local for even glyphs, global for odd)
    for the rest."""
    from fontTools.cffLib import SubrsIndex
    from fontTools.fontBuilder import FontBuilder
    from fontTools.misc.psCharStrings import T2CharString
    from fontTools.pens.t2CharStringPen import T2CharStringPen
    from fontTools.ttLib import TTFont

    src = TTFont(FONT)
    gs = src.getGlyphSet()
    cmap = src.getBestCmap()
    names = {ch: cmap[ord(ch)] for ch in chars}
    order = [".notdef"] + sorted(set(names.values()))
    charstrings = {}
    for gname in order:
        pen = T2CharStringPen(gs[gname].width, gs)
        gs[gname].draw(pen)
        charstrings[gname] = pen.getCharString()
    fb = FontBuilder(2048, isTTF=False)
    fb.setupGlyphOrder(order)
    fb.setupCharacterMap({ord(c): g for c, g in names.items()})
    fb.setupCFF("DejaVuSansCFF", {"FullName": "DejaVu Sans CFF"}, charstrings, {})
    fb.setupHorizontalMetrics({g: (gs[g].width, 0) for g in order})
    fb.setupHorizontalHeader(ascent=1901, descent=-483)
    fb.setupNameTable({"familyName": "DejaVuSansCFF", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    cff = fb.font["CFF "].cff
    top = cff.topDictIndex[0]
    local, glob = [], []
    cs_index = top.CharStrings
    for i, gname in enumerate(order):
        cs = cs_index[gname]
        cs.decompile()
        prog = list(cs.program)
        ops = [k for k, v in enumerate(prog) if isinstance(v, str)]
        if len(ops) < 3 or prog[-1] != "endchar":
            continue
        cut = ops[0] + 1  # the first operator (a moveto, with the width)
        body = prog[cut:-1] + ["return"]
        target = local if i % 2 == 0 else glob
        target.append(body)
        cs.program = prog[:cut] + [len(target) - 1 - 107, "callsubr" if i % 2 == 0 else "callgsubr",
                                   "endchar"]
    top.Private.Subrs = SubrsIndex()
    for body in local:
        top.Private.Subrs.append(T2CharString(program=body))
    for body in glob:
        cff.GlobalSubrs.append(T2CharString(program=body))
    buf = io.BytesIO()
    cff.compile(buf, fb.font)
    return buf.getvalue(), names, 2048


def cff_pdf() -> bytes:
    text = ["BENH VIEN PHENIKAA", "So phieu: 250012345", "Ngay sinh: 15/05/1980"]
    data, names, upm = cff_font("".join(sorted(set("".join(text)))))
    from fontTools.ttLib import TTFont

    hmtx = TTFont(FONT)["hmtx"]
    widths = []
    for code in range(32, 127):
        ch = chr(code)
        widths.append(round(hmtx[names[ch]][0] * 1000 / upm) if ch in names else 0)
    w = Writer()
    ff = w.stream({"Subtype": N("Type1C")}, data)
    desc = w.add({"Type": N("FontDescriptor"), "FontName": N("DejaVuSansCFF"), "Flags": 32,
                  "FontBBox": [-1021, -463, 1794, 1233], "ItalicAngle": 0, "Ascent": 928,
                  "Descent": -236, "CapHeight": 729, "StemV": 80, "FontFile3": ff})
    fnt = w.add({"Type": N("Font"), "Subtype": N("Type1"), "BaseFont": N("DejaVuSansCFF"),
                 "FirstChar": 32, "LastChar": 126, "Widths": widths, "FontDescriptor": desc,
                 "Encoding": N("WinAnsiEncoding")})
    body = b"".join(_content_font_text("F1", 16, 30, 150 - 40 * i, t.encode())
                    for i, t in enumerate(text))
    root = w.page_doc(body, {"Font": {"F1": fnt}}, media=(0, 0, 320, 180))
    return w.classic(root)


def _shapes_content() -> bytes:
    return (b"1 0 0 rg 20 20 120 60 re f\n"
            b"0 0 1 RG 4 w 1 J 1 j 20 120 m 80 170 l 140 120 l S\n"
            b"0 0.6 0 RG 3 w 2 J 0 j 10 M 170 120 m 230 170 l 290 120 l S\n"
            b"0 g 0 w 20 100 m 290 100 l S\n"
            b"0.2 0.4 0.6 0.1 k 170 20 m 290 20 l 230 90 l h 200 60 m 260 60 l 230 30 l h f*\n"
            b"0 G 1.5 w [6 3] 2 d 0 J 20 190 m 290 190 l S\n")


def xref_stream_pdf() -> bytes:
    """Page objects in an object stream, an xref stream with /Predictor 12."""
    content = zlib.compress(_shapes_content())
    objs = {3: ser({"Type": N("Catalog"), "Pages": R(4)}),
            4: ser({"Type": N("Pages"), "Kids": [R(5)], "Count": 1}),
            5: ser({"Type": N("Page"), "Parent": R(4), "MediaBox": [0, 0, 320, 210],
                    "Contents": R(1), "Resources": {}})}
    offs, body = [], b""
    for n in objs:
        offs.append(len(body))
        body += objs[n] + b"\n"
    header = b" ".join(b"%d %d" % (n, o) for n, o in zip(objs, offs)) + b"\n"
    objstm = zlib.compress(header + body)
    out = bytearray(b"%PDF-1.5\n%\xe2\xe3\xcf\xd3\n")
    off1 = len(out)
    out += b"1 0 obj\n" + ser({"Length": len(content), "Filter": N("FlateDecode")}) + \
        b"\nstream\n" + content + b"\nendstream\nendobj\n"
    off2 = len(out)
    out += b"2 0 obj\n" + ser({"Type": N("ObjStm"), "N": 3, "First": len(header),
                               "Length": len(objstm), "Filter": N("FlateDecode")}) + \
        b"\nstream\n" + objstm + b"\nendstream\nendobj\n"
    off6 = len(out)
    rows = [(0, 0, 255), (1, off1, 0), (1, off2, 0), (2, 2, 0), (2, 2, 1), (2, 2, 2), (1, off6, 0)]
    raw = b"".join(bytes([t]) + o.to_bytes(4, "big") + bytes([g]) for t, o, g in rows)
    # PNG Up predictor, 6-byte rows
    prev = bytes(6)
    pred = b""
    for i in range(0, len(raw), 6):
        row = raw[i:i + 6]
        pred += b"\x02" + bytes((a - b) & 0xFF for a, b in zip(row, prev))
        prev = row
    xdata = zlib.compress(pred)
    out += b"6 0 obj\n" + ser({"Type": N("XRef"), "Size": 7, "W": [1, 4, 1], "Root": R(3),
                               "Filter": N("FlateDecode"), "Length": len(xdata),
                               "DecodeParms": {"Predictor": 12, "Columns": 6}}) + \
        b"\nstream\n" + xdata + b"\nendstream\nendobj\n"
    out += b"startxref\n%d\n%%%%EOF\n" % off6
    return bytes(out)


def incremental_pdf() -> bytes:
    w = Writer()
    root = w.page_doc(b"1 0 0 rg 10 10 100 100 re f\n", {}, media=(0, 0, 200, 120))
    base = w.classic(root)
    startxref = int(base.rsplit(b"startxref", 1)[1].split()[0])
    new = zlib.compress(b"0 0 1 rg 90 10 100 100 re f 0 g 0 w 0 60 m 200 60 l S\n")
    update = bytearray()
    off = len(base)
    update += b"1 0 obj\n" + ser({"Length": len(new), "Filter": N("FlateDecode")}) + \
        b"\nstream\n" + new + b"\nendstream\nendobj\n"
    xref = len(base) + len(update)
    update += b"xref\n1 1\n%010d 00000 n \n" % off
    update += b"trailer\n" + ser({"Size": len(w.objs) + 1, "Root": root, "Prev": startxref}) + \
        b"\nstartxref\n%d\n%%%%EOF\n" % xref
    return base + bytes(update)


def broken_xref_pdf() -> bytes:
    w = Writer()
    root = w.page_doc(_shapes_content(), {}, media=(0, 0, 320, 210))
    data = bytearray(w.classic(root))
    # Shift every object by inserting junk after the header, and point
    # startxref past the table.
    data[15:15] = b"% inserted junk that moves every offset\n" * 3
    cut = data.rfind(b"startxref")
    return bytes(data[:cut]) + b"startxref\n999999\n%%EOF\n"


def rotate90_pdf() -> bytes:
    w = Writer()
    body = (b"0.9 g 0 0 400 300 re f\n1 0 0 rg 60 60 100 40 re f\n0 0 1 rg 250 200 60 60 re f\n"
            b"0 G 2 w 60 60 m 340 240 l S\n")
    root = w.page_doc(body, {}, media=(0, 0, 400, 300),
                      extra={"CropBox": [40, 30, 360, 270], "Rotate": 90})
    return w.classic(root)


def images_pdf() -> bytes:
    rng = np.random.default_rng(5)
    w = Writer()
    # An RGB image with a gradient SMask (a logo with alpha), 24 x 16.
    yy, xx = np.mgrid[0:16, 0:24]
    rgb = np.stack([xx * 10, yy * 15, 255 - xx * 10], -1).astype(np.uint8)
    alpha = np.clip(255 - (np.hypot(xx - 12, yy - 8) * 24), 0, 255).astype(np.uint8)
    smask = w.stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 24, "Height": 16,
                      "ColorSpace": N("DeviceGray"), "BitsPerComponent": 8}, alpha.tobytes())
    logo = w.stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 24, "Height": 16,
                     "ColorSpace": N("DeviceRGB"), "BitsPerComponent": 8, "SMask": smask,
                     "Interpolate": True}, rgb.tobytes())
    big = rng.integers(0, 256, (64, 80), dtype=np.uint8)
    gray = w.stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 80, "Height": 64,
                     "ColorSpace": N("DeviceGray"), "BitsPerComponent": 8,
                     "Decode": [1, 0]}, big.tobytes())
    palette = bytes([0, 0, 0, 255, 0, 0, 0, 160, 0, 40, 40, 220])
    idx = (np.arange(12 * 9) % 4).astype(np.uint8).reshape(9, 12)
    packed = np.packbits(np.unpackbits(idx[..., None], axis=2)[..., 6:].reshape(9, 24), axis=1)
    indexed = w.stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 12, "Height": 9,
                        "ColorSpace": [N("Indexed"), N("DeviceRGB"), 3, palette],
                        "BitsPerComponent": 2}, packed.tobytes())
    stencil_bits = np.packbits((rng.random((20, 20)) < 0.5), axis=1)
    stencil = w.stream({"Type": N("XObject"), "Subtype": N("Image"), "Width": 20, "Height": 20,
                        "ImageMask": True}, stencil_bits.tobytes())
    inline = np.array([[0, 64, 128, 255], [255, 128, 64, 0], [30, 90, 150, 210]], np.uint8)
    hexdata = inline.tobytes().hex().encode() + b">"
    import base64

    a85 = base64.a85encode(inline.tobytes(), adobe=True)[2:]
    rl = bytes([len(inline.tobytes()) - 1]) + inline.tobytes() + b"\x80"
    body = (
        b"0.95 g 0 0 400 300 re f\n"
        b"q 96 0 0 64 20 220 cm /Logo Do Q\n"  # enlarged x4
        b"q 40 0 0 32 130 240 cm /Gray Do Q\n"  # shrunk by 2
        b"q 0 40 -30 0 220 220 cm /Gray Do Q\n"  # a quarter turn
        b"q 34.64 20 -16 27.71 300 200 cm /Logo Do Q\n"  # turned 30 degrees
        b"q 48 0 0 36 20 160 cm /Idx Do Q\n"
        b"0 0.5 0 rg q 40 0 0 40 100 150 cm /Mask Do Q\n"
        b"q 60 0 0 45 160 150 cm BI /W 4 /H 3 /CS /G /BPC 8 /F /AHx ID " + hexdata + b" EI Q\n"
        b"q 60 0 0 45 230 150 cm BI /W 4 /H 3 /CS /G /BPC 8 /F /A85 ID " + a85 + b" EI Q\n"
        b"q 60 0 0 45 300 150 cm BI /W 4 /H 3 /CS /G /BPC 8 /F /RL ID " + rl + b" EI Q\n"
        b"/GS1 gs 1 0 0 rg 20 20 150 100 re f 0 0 1 rg 80 50 150 100 re f\n"
    )
    resources = {"XObject": {"Logo": logo, "Gray": gray, "Idx": indexed, "Mask": stencil},
                 "ExtGState": {"GS1": {"Type": N("ExtGState"), "ca": 0.5, "CA": 0.5}}}
    root = w.page_doc(body + _shapes_content().replace(b"20 20 120 60 re f", b""), resources,
                      media=(0, 0, 400, 300))
    return w.classic(root)


def no_pages_pdf() -> bytes:
    w = Writer()
    w.add({"Type": N("Catalog"), "Pages": R(2)})
    w.add({"Type": N("Pages"), "Kids": [], "Count": 0})
    return w.classic(R(1))


def unsupported_pdfs() -> dict:
    """One file a feature that raises ROADMAP Queue 1 item 13: name -> (bytes,
    the words the error names)."""
    out = {}

    def page(body: bytes, resources: dict, **kw) -> bytes:
        w = Writer()
        res = {}
        for k, v in resources.items():
            res[k] = v(w) if callable(v) else v
        return w.classic(w.page_doc(body, res, media=(0, 0, 200, 100), **kw))

    def image(filter_name: str, parms: dict | None = None):
        def make(w):
            d = {"Type": N("XObject"), "Subtype": N("Image"), "Width": 8, "Height": 8,
                 "ColorSpace": N("DeviceGray"), "BitsPerComponent": 1, "Filter": N(filter_name)}
            if parms:
                d["DecodeParms"] = parms
            return {"Im": w.stream(d, b"\x00" * 16, flate=False)}
        return make

    draw = b"q 50 0 0 50 10 10 cm /Im Do Q\n"
    out["unsupported_jbig2.pdf"] = (page(draw, {"XObject": image("JBIG2Decode")}), "JBIG2Decode")
    out["unsupported_g3.pdf"] = (page(draw, {"XObject": image("CCITTFaxDecode", {
        "K": 0, "Columns": 8, "Rows": 8})}), "Group 3")
    out["unsupported_shading.pdf"] = (page(b"/Sh0 sh\n", {"Shading": {"Sh0": {
        "ShadingType": 2, "ColorSpace": N("DeviceRGB"), "Coords": [0, 0, 200, 0],
        "Function": {"FunctionType": 2, "Domain": [0, 1], "C0": [1, 0, 0], "C1": [0, 0, 1],
                     "N": 1}}}}), "shadings")
    out["unsupported_pattern.pdf"] = (page(b"/Pattern cs /P0 scn 0 0 100 100 re f\n", {}),
                                       "patterns")
    out["unsupported_softmask.pdf"] = (page(b"/GS0 gs 0 0 100 100 re f\n", {"ExtGState": {
        "GS0": {"SMask": {"Type": N("Mask"), "S": N("Luminosity"), "G": R(999)}}}}),
        "soft masks")
    out["unsupported_blend.pdf"] = (page(b"/GS0 gs 0 0 100 100 re f\n", {"ExtGState": {
        "GS0": {"BM": N("Multiply")}}}), "blend mode")
    out["unsupported_separation.pdf"] = (page(b"/CS0 cs 1 scn 0 0 100 100 re f\n", {
        "ColorSpace": {"CS0": [N("Separation"), N("Spot"), N("DeviceCMYK"), {
            "FunctionType": 2, "Domain": [0, 1], "C0": [0, 0, 0, 0], "C1": [0, 1, 0, 0],
            "N": 1}]}}), "Separation")
    out["unsupported_devicen.pdf"] = (page(b"/CS0 cs 1 1 scn 0 0 100 100 re f\n", {
        "ColorSpace": {"CS0": [N("DeviceN"), [N("A"), N("B")], N("DeviceCMYK"), {
            "FunctionType": 2, "Domain": [0, 1, 0, 1], "C0": [0, 0, 0, 0],
            "C1": [0, 1, 0, 0], "N": 1}]}}), "DeviceN")

    def helvetica(w):
        return {"F1": w.add({"Type": N("Font"), "Subtype": N("Type1"),
                             "BaseFont": N("Helvetica")})}

    out["unsupported_font.pdf"] = (page(b"BT /F1 12 Tf 10 10 Td (Hello) Tj ET\n",
                                        {"Font": helvetica}), "not embedded")

    def type1(w):
        ff = w.stream({"Length1": 4, "Length2": 0, "Length3": 0}, b"%!PS")
        desc = w.add({"Type": N("FontDescriptor"), "FontName": N("X"), "Flags": 32,
                      "FontFile": ff})
        return {"F1": w.add({"Type": N("Font"), "Subtype": N("Type1"), "BaseFont": N("X"),
                             "FontDescriptor": desc})}

    out["unsupported_type1.pdf"] = (page(b"BT /F1 12 Tf 10 10 Td (Hello) Tj ET\n",
                                         {"Font": type1}), "Type 1 font program")

    w = Writer()
    ap = w.stream({"Type": N("XObject"), "Subtype": N("Form"), "BBox": [0, 0, 50, 20]},
                  b"1 0 0 rg 0 0 50 20 re f")
    annot = w.add({"Type": N("Annot"), "Subtype": N("Square"), "Rect": [10, 10, 60, 30],
                   "AP": {"N": ap}})
    out["unsupported_annot.pdf"] = (w.classic(w.page_doc(b"", {}, media=(0, 0, 200, 100),
                                                         extra={"Annots": [annot]})),
                                    "annotation")
    w = Writer()
    root = w.page_doc(b"0 0 100 100 re f\n", {}, media=(0, 0, 200, 100))
    enc = w.add({"Filter": N("Standard"), "V": 1, "R": 2, "O": b"\0" * 32, "U": b"\0" * 32,
                 "P": -4})
    out["unsupported_encrypt.pdf"] = (w.classic(root, {"Encrypt": enc, "ID": [b"\1" * 16,
                                                                              b"\1" * 16]}),
                                      "encrypted")
    out["unsupported_rendermode.pdf"] = (page(b"BT 5 Tr ET\n", {}), "render mode")
    return out


def scan_page(rng) -> np.ndarray:
    """The scanned report: Agg's A4 raster of the fourth patient's report,
    speckled."""
    name, fonttype, pname, birthday, rid = SCAN
    gray = agg_gray(report_figure(pname, birthday, rid, fonttype)).astype(np.int16)
    gray += rng.integers(-6, 7, gray.shape).astype(np.int16)
    return np.clip(gray, 0, 255).astype(np.uint8)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from PIL import Image

    from spine_vision_torch.io import pdf as tpdf

    rng = np.random.default_rng(25)
    files: dict[str, bytes] = {}
    sources: dict[str, dict] = {}
    page = Image.open(OCR_PAGE)
    for name, img, res in (("raster_gray_150.pdf", page.convert("L"), 150),
                           ("raster_gray_200.pdf", page.convert("L"), 200),
                           ("raster_rgb_300.pdf", Image.merge("RGB", [
                               page.convert("L"), page.convert("L").point(lambda v: v * 0.9),
                               page.convert("L").point(lambda v: 255 - (255 - v) // 2)]), 300),
                           ("raster_bilevel_200.pdf", page.convert("1"), 200)):
        buf = io.BytesIO()
        img.save(buf, "PDF", resolution=res, creationDate=STAMP, modDate=STAMP)
        files[name] = buf.getvalue()
        sources[name] = {"resolution": res, "mode": img.mode}
    scan = Image.fromarray(scan_page(rng))
    buf = io.BytesIO()
    scan.save(buf, "PDF", resolution=DPI, quality=80, creationDate=STAMP, modDate=STAMP)
    files[SCAN[0]] = buf.getvalue()
    sources[SCAN[0]] = {"resolution": DPI, "mode": "L"}
    reports = {}
    for name, fonttype, pname, birthday, rid in REPORTS:
        buf = HERE / name
        save_pdf(report_figure(pname, birthday, rid, fonttype), buf)
        files[name] = buf.read_bytes()
        reports[name] = {"fonttype": fonttype, "name": pname, "birthday": birthday, "id": rid}
    reports[SCAN[0]] = {"fonttype": None, "name": SCAN[2], "birthday": SCAN[3], "id": SCAN[4]}
    files["truetype_simple.pdf"] = simple_truetype_pdf()
    files["cff_type1c.pdf"] = cff_pdf()
    files["xref_stream.pdf"] = xref_stream_pdf()
    files["incremental.pdf"] = incremental_pdf()
    files["broken_xref.pdf"] = broken_xref_pdf()
    files["rotate90.pdf"] = rotate90_pdf()
    files["images.pdf"] = images_pdf()
    files["no_pages.pdf"] = no_pages_pdf()
    unsupported = unsupported_pdfs()
    for name, (data, _) in unsupported.items():
        files[name] = data
    record: dict = {"dpi": DPI, "pages": {}, "reports": reports, "sources": sources,
                    "unsupported": {k: v for k, (_, v) in unsupported.items()},
                    "no_pages": ["no_pages.pdf"]}
    for name, data in sorted(files.items()):
        (HERE / name).write_bytes(data)
        if name in unsupported or name == "no_pages.pdf":
            continue
        pages = tpdf.pdf_to_arrays(HERE / name, DPI)
        record["pages"][name] = [{"shape": list(p.shape),
                                  "sha256": hashlib.sha256(p.tobytes()).hexdigest()}
                                 for p in pages]
    (HERE / "record.json").write_text(json.dumps(record, indent=1, ensure_ascii=False) + "\n")
    print(f"wrote {len(files)} files")


if __name__ == "__main__":
    main()
