"""The port's PDF renderer (``spine_vision_torch/io/pdf*.py``) on the CPU,
against the sources of the committed fixtures (``tests/fixtures/torch_pdf``,
written by its ``generate.py``) and the JAX package's wrappers.

- Raster sizes follow MuPDF's ``fz_round_rect`` of the page box times
  dpi / 72, for every box and rotation at 72, 150, 200 and 300 dpi.
- A raster page (Pillow's DCT and CCITT G4 pages) equals its source bit for
  bit at its own resolution: Pillow's decode of the same JPEG stream, and
  the bilevel image.
- The C++ raster steps and G4 decoder equal their plain numpy versions bit
  for bit, on every fixture and on random inputs; every page's sha256 is the
  record's.
- The vector reports against matplotlib's Agg raster of the same figure at
  the same dpi (``text.hinting = "no_hinting"``, ``hinting_factor = 1``),
  in gray (Pillow's ``L``), over the part both rasters share (Agg's is a
  pixel narrower and shorter). Tolerances, with the values measured when
  they were set: the page's mean absolute difference at most 1.0 for
  ``pdf.fonttype`` 42 (measured 0.589 and 0.650) and 1.5 for 3 (0.906);
  the 99th percentile of the absolute difference of 4 x 4 pixel means over
  the pooled cells with ink in either raster at most 70 for 42 (46.4 and
  54.1) and 160 for 3 (123.5). Agg snaps the table rules to whole pixels
  and places each glyph at a whole pixel; matplotlib's Type 3 writer lays
  text out with its own rounded advances, farther from Agg's layout.
- The OCR with the shipped weights reads each report's ID through the
  400 x 200 crop of ``DEFAULT_PDF_ID_CROP_REGION``, and the record's fields
  from the small raster pages.
- A stub ``fitz`` serving the port's pixmaps runs the JAX package's own
  wrappers: their zoom, ``[..., :3]``, the zero-page ``None`` and the PNG
  names give the port's results.
- Each unsupported feature raises ``NotImplementedError`` citing ROADMAP
  Queue 1 item 13, through ``DocumentExtractor.extract`` too.
"""

import base64
import hashlib
import importlib.util
import io
import json
import math
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from spine_vision_torch import native
from spine_vision_torch.io import pdf as tpdf
from spine_vision_torch.io import pdf_parse as pp
from spine_vision_torch.io import pdf_render as pr

HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "fixtures" / "torch_pdf"
RECORD = json.loads((FIXTURES / "record.json").read_text())
RENDERED = sorted(RECORD["pages"])
RASTER = {name: src for name, src in RECORD["sources"].items()}
AGG_TOL = {42: (1.0, 70.0), 3: (1.5, 160.0)}  # (page mean, pooled ink p99)


def _generator():
    spec = importlib.util.spec_from_file_location("torch_pdf_generate", FIXTURES / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _generator()


def _gray(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()


@pytest.fixture(scope="module")
def extractor():
    from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor

    return DocumentExtractor(device="cpu")


# -- sizes ---------------------------------------------------------------------------
BOXES = {
    "a4": ({"MediaBox": [0, 0, 595.276, 841.89]}, (595.276, 841.89)),
    "crop": ({"MediaBox": [0, 0, 400, 300], "CropBox": [40, 30, 360, 270.5]}, (320, 240.5)),
    "crop_outside": ({"MediaBox": [0, 0, 400, 300], "CropBox": [-50, 100, 250.3, 500]},
                     (250.3, 200)),
    "reversed": ({"MediaBox": [612, 792, 0, 0]}, (612, 792)),
    "inherited": (None, (300.7, 200.2)),
}


def _page_pdf(attrs: dict | None, rotate: int) -> bytes:
    w = GEN.Writer()
    if attrs is None:  # the boxes and /Rotate inherited from the page tree
        c = w.stream({}, b"0 g 10 10 50 50 re f")
        page = w.add({"Type": GEN.N("Page"), "Parent": GEN.R(4), "Contents": c})
        root = w.add({"Type": GEN.N("Catalog"), "Pages": GEN.R(4)})
        w.add({"Type": GEN.N("Pages"), "Kids": [page], "Count": 1, "Rotate": rotate,
               "MediaBox": [0, 0, 300.7, 200.2]}, 4)
        return w.classic(root)
    extra = {k: v for k, v in attrs.items() if k != "MediaBox"}
    extra["Rotate"] = rotate
    return w.classic(w.page_doc(b"0 g 10 10 50 50 re f", {}, media=attrs["MediaBox"],
                                extra=extra))


@pytest.mark.parametrize("dpi", (72, 150, 200, 300))
@pytest.mark.parametrize("rotate", (0, 90, 180, 270, -90, 450))
@pytest.mark.parametrize("box", sorted(BOXES))
def test_raster_size_follows_round_rect(tmp_path, box, rotate, dpi):
    attrs, (w, h) = BOXES[box]
    path = tmp_path / "p.pdf"
    path.write_bytes(_page_pdf(attrs, rotate))
    if rotate % 180:
        w, h = h, w
    z = dpi / 72.0
    want = (math.ceil(h * z - 0.001) - math.floor(0.001), math.ceil(w * z - 0.001), 3)
    page = tpdf.pdf_first_page_to_array(path, dpi)
    assert page.shape == want and page.dtype == np.uint8


def test_a4_and_pillow_pages_sizes():
    """An A4 page at 200 dpi is 1654 x 2339; a page Pillow wrote at
    ``resolution=r`` is its image's size at ``dpi = r``, at the other dpis
    its box's rounding."""
    assert tpdf.pdf_first_page_to_array(FIXTURES / "report_type42.pdf", 200).shape == (
        2339, 1654, 3)
    src = Image.open(HERE / "fixtures" / "torch_ocr" / "report_clean.png")
    for name, info in RASTER.items():
        if not name.startswith("raster_"):
            continue
        res = info["resolution"]
        for dpi in (72, 150, 200, 300):
            shape = tpdf.pdf_first_page_to_array(FIXTURES / name, dpi).shape
            w_pt, h_pt = src.width * 72 / res, src.height * 72 / res
            want = (math.ceil(h_pt * dpi / 72 - 0.001), math.ceil(w_pt * dpi / 72 - 0.001), 3)
            assert shape == want, (name, dpi)
            if dpi == res:
                assert shape == (src.height, src.width, 3)


# -- raster pages ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(RASTER))
def test_raster_pages_equal_their_sources(name):
    info = RASTER[name]
    page = tpdf.pdf_first_page_to_array(FIXTURES / name, info["resolution"])
    doc = tpdf.open_pdf(FIXTURES / name)
    res = doc.resolve(doc.pages()[0]["Resources"])
    image = doc.resolve(doc.resolve(res["XObject"])["image"])
    if info["mode"] == "1":
        want = np.asarray(Image.open(HERE / "fixtures" / "torch_ocr" / "report_clean.png")
                          .convert("1")).astype(np.uint8) * 255
    else:
        want = np.asarray(Image.open(io.BytesIO(image.raw)))  # the same JPEG stream
    if want.ndim == 2:
        want = np.repeat(want[..., None], 3, axis=2)
    np.testing.assert_array_equal(page, want)


# -- C++ against plain ---------------------------------------------------------------
@pytest.mark.parametrize("name", RENDERED)
def test_native_equals_plain_on_every_fixture(name):
    native_pages = tpdf.pdf_to_arrays(FIXTURES / name, RECORD["dpi"])
    plain_pages = tpdf.pdf_to_arrays(FIXTURES / name, RECORD["dpi"], plain=True)
    assert len(native_pages) == len(plain_pages) == len(RECORD["pages"][name])
    for got, plain, want in zip(native_pages, plain_pages, RECORD["pages"][name]):
        np.testing.assert_array_equal(got, plain)
        assert [list(got.shape), _sha(got)] == [want["shape"], want["sha256"]]


@pytest.mark.parametrize("seed", range(4))
def test_native_raster_steps_equal_plain(seed):
    rng = np.random.default_rng(seed)
    polys = [rng.uniform(-20, 120, (rng.integers(3, 9), 2)) for _ in range(6)]
    edges = pr.edges_of(polys)
    for even_odd in (False, True):
        for box in ((0, 0, 100, 100), (-7, 13, 55, 40), (90, 90, 40, 40)):
            np.testing.assert_array_equal(native.pdf_coverage(edges, even_odd, box),
                                          pr.coverage_plain(edges, even_odd, box))
    cov = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    src = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (30, 70), dtype=np.uint8)
    for s, rgb, clip in ((None, (10, 200, 30), None), (src, None, (-5, 8, mask)),
                         (None, (255, 0, 0), (20, 20, mask))):
        a = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
        b = a.copy()
        native.pdf_composite(a, (-10, 25, 50, 40), cov, s, rgb, 200, clip)
        pr.composite_plain(b, (-10, 25, 50, 40), cov, s, rgb, 200, clip)
        np.testing.assert_array_equal(a, b)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for n_dst in ((37, 53), (13, 20), (90, 111), (37, 20)):
        xtab, ytab = pr.axis_table(53, n_dst[1]), pr.axis_table(37, n_dst[0])
        assert (xtab[1].sum(1) == 1 << pr.WEIGHT_BITS).all()
        np.testing.assert_array_equal(native.pdf_resample_axes(img, xtab, ytab),
                                      pr.resample_axes_plain(img, xtab, ytab))
    m = np.array([43000, -21000, 9_000_000, 17000, 52000, -400_000], np.int64)
    got, want = native.pdf_resample_affine(img, m, (3, -4, 70, 60)), \
        pr.resample_affine_plain(img, m, (3, -4, 70, 60))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_copy_at_one_to_one_and_area_and_bilinear():
    """The axis tables: a copy at 1:1, each shrunk pixel the area mean of
    its source span, enlargement bilinear between the two nearest centres."""
    img = np.arange(12, dtype=np.uint8).reshape(1, 12, 1) * 20
    same = pr.resample_axes_plain(img, pr.axis_table(12, 12), pr.axis_table(1, 1))
    np.testing.assert_array_equal(same, img)
    half = pr.resample_axes_plain(img, pr.axis_table(12, 6), pr.axis_table(1, 1))
    np.testing.assert_array_equal(half[0, :, 0], img[0, ::2, 0] + 10)
    double = pr.resample_axes_plain(img, pr.axis_table(12, 24), pr.axis_table(1, 1))
    np.testing.assert_array_equal(double[0, 1:-1:2, 0], img[0, :-1, 0] + 5)


def test_g4_native_equals_plain_and_pillow():
    rng = np.random.default_rng(3)
    for trial in range(5):
        h, w = (int(v) for v in rng.integers(4, 200, 2))
        arr = rng.random((h, w)) < (0.05, 0.5, 0.95, 0.3, 0.7)[trial]
        if trial == 3:
            arr = np.repeat(arr[:, ::5], 5, axis=1)[:, :w]
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PDF")
        doc = pp.Document(buf.getvalue())
        image = doc.resolve(doc.resolve(doc.pages()[0]["Resources"])["XObject"]["image"])
        _, parms = pp.stream_filters(image)
        plain = pp.ccitt_decode(image.raw, parms[0], plain=True, height=h)
        fast = pp.ccitt_decode(image.raw, parms[0], height=h)
        np.testing.assert_array_equal(fast, plain)
        np.testing.assert_array_equal(plain, arr.astype(np.uint8))
    with pytest.raises(pp.PdfError, match="corrupt"):
        native.pdf_g4_decode(b"\x00\x01\xff\xff", 16, 4)
    with pytest.raises(pp.PdfError, match="corrupt"):
        pp.g4_decode_plain(b"\x00\x01\xff\xff", 16, 4)


# -- vector reports against Agg ------------------------------------------------------------
@pytest.mark.parametrize("report", GEN.REPORTS, ids=lambda r: r[0])
def test_vector_reports_against_agg(report):
    name, fonttype, pname, birthday, rid = report
    ours = _gray(tpdf.pdf_first_page_to_array(FIXTURES / name, GEN.DPI))
    agg = GEN.agg_gray(GEN.report_figure(pname, birthday, rid, fonttype))
    h, w = (min(a, b) // 4 * 4 for a, b in zip(ours.shape, agg.shape))
    ours, agg = ours[:h, :w].astype(np.int64), agg[:h, :w].astype(np.int64)
    page_mean = np.abs(ours - agg).mean()

    def pool(x):
        return x.reshape(h // 4, 4, w // 4, 4).mean(axis=(1, 3))

    ink = pool((np.minimum(ours, agg) < 250).astype(np.float64)) > 0
    pooled = np.abs(pool(ours) - pool(agg))[ink]
    mean_tol, p99_tol = AGG_TOL[fonttype]
    assert page_mean <= mean_tol, page_mean
    assert np.percentile(pooled, 99) <= p99_tol, np.percentile(pooled, 99)


# -- OCR ---------------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(RECORD["reports"]))
def test_ocr_reads_each_report_id_through_the_crop(extractor, name):
    from spine_vision_torch.data.phenikaa import DEFAULT_PDF_ID_CROP_REGION

    fields = RECORD["reports"][name]
    lines = extractor.extract_from_pdf_crop(FIXTURES / name, DEFAULT_PDF_ID_CROP_REGION)
    assert lines == [f"Số phiếu: {fields['id']}"]


def test_ocr_reads_the_small_pages(extractor):
    """The raster pages of the OCR fixture's clean report, read whole: its
    three fields; the simple TrueType and CFF pages: their lines."""
    manifest = json.loads((HERE / "fixtures" / "torch_ocr" / "manifest.json").read_text())
    truth = next(p for p in manifest["pages"] if p["file"] == "report_clean.png")["truth"]
    for name in ("raster_gray_200.pdf", "raster_bilevel_200.pdf", "raster_rgb_300.pdf"):
        lines = extractor.extract_from_pdf(FIXTURES / name, dpi=RASTER[name]["resolution"])
        fields = truth["fields"]
        text = " ".join(lines)
        assert fields["id"] in text and fields["birthday"] in text, (name, lines)
        assert fields["name"] in text, (name, lines)
    # At the dpi that makes their em about the synth's 20 px.
    lines = extractor.extract_from_pdf(FIXTURES / "cff_type1c.pdf", dpi=90)
    assert lines == ["BENH VIEN PHENIKAA", "So phieu: 250012345", "Ngay sinh: 15/05/1980"]
    lines = extractor.extract_from_pdf(FIXTURES / "truetype_simple.pdf", dpi=144)
    assert [line.strip(" _") for line in lines[:3]] == list(GEN.SIMPLE_LINES)
    assert extractor.extract_from_pdf(FIXTURES / "no_pages.pdf") == []
    assert extractor.extract(FIXTURES / "no_pages.pdf") == []


# -- the JAX package's wrappers on the port's pixmaps --------------------------------------
def test_jax_wrappers_on_the_port_pixmaps(monkeypatch, tmp_path):
    sys.path.insert(0, str(HERE))
    from torch_fitz_stub import fitz_stub

    from spine_vision_tpu.io import pdf as jpdf

    monkeypatch.setitem(sys.modules, "fitz", fitz_stub())
    for name, dpi in (("rotate90.pdf", 150), ("images.pdf", 100), ("report_type3.pdf", 200),
                      ("incremental.pdf", 300)):
        want = tpdf.pdf_to_arrays(FIXTURES / name, dpi)
        got = jpdf.pdf_to_arrays(FIXTURES / name, dpi)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(jpdf.pdf_first_page_to_array(FIXTURES / name, dpi),
                                      tpdf.pdf_first_page_to_array(FIXTURES / name, dpi))
    assert jpdf.pdf_first_page_to_array(FIXTURES / "no_pages.pdf") is None
    assert tpdf.pdf_first_page_to_array(FIXTURES / "no_pages.pdf") is None
    assert jpdf.pdf_to_arrays(FIXTURES / "no_pages.pdf") == tpdf.pdf_to_arrays(
        FIXTURES / "no_pages.pdf") == []
    jpaths = jpdf.pdf_to_images(FIXTURES / "rotate90.pdf", tmp_path / "jax", dpi=120)
    tpaths = tpdf.pdf_to_images(FIXTURES / "rotate90.pdf", tmp_path / "port", dpi=120)
    assert [p.name for p in jpaths] == [p.name for p in tpaths] == ["rotate90_page1.png"]
    for a, b in zip(jpaths, tpaths):
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


def test_multi_page_document_pages_and_names(tmp_path):
    """A three-page document (Pillow's ``save_all``: gray, RGB and bilevel
    pages at 100 dpi): every page, in order, equal to its image, and
    ``pdf_to_images``' numbered names."""
    rng = np.random.default_rng(7)
    images = [Image.fromarray(rng.integers(0, 256, (30, 40), dtype=np.uint8)),
              Image.fromarray(rng.integers(0, 256, (20, 50, 3), dtype=np.uint8)),
              Image.fromarray(rng.random((25, 33)) < 0.5)]
    path = tmp_path / "scan.pdf"
    images[0].save(path, "PDF", resolution=100, save_all=True, append_images=images[1:])
    pages = tpdf.pdf_to_arrays(path, 100)
    assert len(pages) == 3
    doc = tpdf.open_pdf(path)
    for page, image, info in zip(pages, images, doc.pages()):
        xobj = doc.resolve(doc.resolve(info["Resources"])["XObject"])
        stream = doc.resolve(next(iter(xobj.values())))
        want = (np.asarray(image).astype(np.uint8) * 255 if image.mode == "1"
                else np.asarray(Image.open(io.BytesIO(stream.raw))))
        if want.ndim == 2:
            want = np.repeat(want[..., None], 3, axis=2)
        np.testing.assert_array_equal(page, want)
    names = [p.name for p in tpdf.pdf_to_images(path, tmp_path / "out", dpi=100)]
    assert names == ["scan_page1.png", "scan_page2.png", "scan_page3.png"]


# -- the file layer ----------------------------------------------------------------------
def test_file_layer_repairs_and_updates():
    broken = tpdf.open_pdf(FIXTURES / "broken_xref.pdf")
    assert broken.repaired
    np.testing.assert_array_equal(tpdf.pdf_first_page_to_array(FIXTURES / "broken_xref.pdf"),
                                  tpdf.pdf_first_page_to_array(FIXTURES / "xref_stream.pdf"))
    assert not tpdf.open_pdf(FIXTURES / "xref_stream.pdf").repaired
    page = tpdf.pdf_first_page_to_array(FIXTURES / "incremental.pdf", 72)
    # The update's content: blue from x = 90 pt, no red left of it.
    assert tuple(page[100, 150]) == (0, 0, 255) and tuple(page[100, 40]) == (255, 255, 255)
    with pytest.raises(pp.PdfError):
        pp.Document(b"not a pdf")


def _png_predict(rows: list, bpp: int, kinds: list) -> bytes:
    out = b""
    prev = bytes(len(rows[0]))
    for row, kind in zip(rows, kinds):
        enc = bytearray()
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if kind == 0:
                p = 0
            elif kind == 1:
                p = a
            elif kind == 2:
                p = b
            elif kind == 3:
                p = (a + b) >> 1
            else:
                q = a + b - c
                pa, pb, pc = abs(q - a), abs(q - b), abs(q - c)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            enc.append((v - p) & 0xFF)
        out += bytes([kind]) + bytes(enc)
        prev = row
    return out


def _lzw_encode(data: bytes, early: int) -> bytes:
    table = {bytes([i]): i for i in range(256)}
    codes = [(256, 9)]
    w = b""
    nxt = 258

    def width():
        n = nxt - 1 + early
        return 9 if n < 512 else 10 if n < 1024 else 11 if n < 2048 else 12

    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], width()))
        table[wc] = nxt
        nxt += 1
        w = bytes([c])
    codes.append((table[w], width()))
    nxt += 1
    codes.append((257, width()))
    bits = "".join(format(c, f"0{n}b") for c, n in codes)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def test_filters():
    rng = np.random.default_rng(1)
    data = bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    # The PDF reference's LZW example, then code widths growing to 12 bits.
    assert pp.lzw_decode(bytes.fromhex("800B6050220C0C8501")) == b"-----A---B"
    text = bytes(rng.choice(list(b"abcdefgh"), 6000))
    for early in (0, 1):
        assert pp.lzw_decode(_lzw_encode(text, early), early) == text
    assert pp.ascii_hex_decode(data.hex().encode() + b" >") == data
    assert pp.ascii_hex_decode(b"4a 4B 5>") == b"JKP"
    assert pp.ascii85_decode(base64.a85encode(data, adobe=True)) == data
    assert pp.ascii85_decode(b"z!!~>") == b"\0" * 4 + b"\0"
    assert pp.run_length_decode(bytes([2]) + b"abc" + bytes([254]) + b"z" + b"\x80") == b"abczzz"
    rows = [bytes(rng.integers(0, 256, 12, dtype=np.uint8)) for _ in range(5)]
    for bpp, colors in ((1, 1), (3, 3)):
        enc = zlib.compress(_png_predict(rows, bpp, [0, 1, 2, 3, 4]))
        parm = {"Predictor": 12, "Colors": colors, "Columns": 12 // colors}
        assert pp.apply_filter("FlateDecode", enc, parm) == b"".join(rows)
    img = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    diff = np.diff(img.astype(np.int16), axis=1, prepend=0).astype(np.uint8)
    parm = {"Predictor": 2, "Colors": 3, "Columns": 5}
    assert pp.apply_filter("FlateDecode", zlib.compress(diff.tobytes()), parm) == img.tobytes()
    # A truncated deflate stream keeps what decodes, as MuPDF does.
    assert pp._inflate(zlib.compress(data)[:-8]) in (data, data[:len(pp._inflate(
        zlib.compress(data)[:-8]))])


def test_fonts_decode_to_their_glyphs():
    from fontTools.ttLib import TTFont

    from spine_vision_torch.io import pdf_fonts

    doc = tpdf.open_pdf(FIXTURES / "cff_type1c.pdf")
    font = doc.resolve(doc.resolve(doc.pages()[0]["Resources"])["Font"]["F1"])
    cff = pdf_fonts.load_font(doc, font)
    assert isinstance(cff.program, pdf_fonts.CFF)
    assert cff.program.private[0] and cff.program.gsubrs  # both kinds of subroutines
    dejavu = TTFont(GEN.FONT)
    glyph = cff.decode(b"S")[0]
    assert cff.program.charset and glyph.glyph == cff.program.names["S"]
    ref = dejavu["hmtx"][dejavu.getBestCmap()[ord("S")]][0] / dejavu["head"].unitsPerEm
    assert abs(glyph.width - round(ref * 1000) / 1000) < 1e-9
    outline = cff.outline(glyph.glyph)
    assert outline and all(op[0] in "MLC" for c in outline for op in c)
    doc = tpdf.open_pdf(FIXTURES / "report_type42.pdf")
    fonts = doc.resolve(doc.resolve(doc.pages()[0]["Resources"])["Font"])
    t0 = pdf_fonts.load_font(doc, doc.resolve(fonts["F1"]))
    assert isinstance(t0, pdf_fonts.Type0Font) and isinstance(t0.program, pdf_fonts.TrueType)
    assert pdf_fonts.glyph_unicode("uni1EBF") == 0x1EBF
    assert pdf_fonts.glyph_unicode("eacute") == 0xE9


# -- item 13 -------------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(RECORD["unsupported"]))
def test_unsupported_features_raise_item_13(extractor, name):
    words = RECORD["unsupported"][name]
    for call in (lambda: tpdf.pdf_to_arrays(FIXTURES / name),
                 lambda: tpdf.pdf_first_page_to_array(FIXTURES / name, 100),
                 lambda: extractor.extract(FIXTURES / name),
                 lambda: extractor.extract_from_pdf(FIXTURES / name)):
        with pytest.raises(NotImplementedError, match="item 13") as info:
            call()
        assert words.lower() in str(info.value).lower()
