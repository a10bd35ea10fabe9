"""The port's OCR engine (``spine_vision_torch/data/phenikaa/ocr.py``) with
the shipped weights on the CPU, held to the JAX package's record of four
fixture pages (``tests/fixtures/torch_ocr``) by
``spine_vision_torch/utils/ocr_parity.py``: the record's box count and
quads within 2 px on every page once threshold ties take JAX's decision,
the lines within a CER of 5e-3 of the record's, and the three report fields;
then the file contract, the loaders and the helpers against the JAX
package's.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor, TextDetector, TextRecognizer
from spine_vision_torch.data.png import write_png
from spine_vision_torch.models.convert import load_variables_npz
from spine_vision_torch.train.ocr import DEFAULT_WEIGHTS_DIR, character_error_rate
from spine_vision_torch.utils import ocr_parity
from spine_vision_tpu.train import ocr as jocr

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_ocr"


@pytest.fixture(scope="module")
def extractor():
    return DocumentExtractor(device="cpu")


# Four of the record's pages (the card's run, chip_smoke.py's ocr phase,
# takes all 18): the page whose boxes tie here, the one whose text came
# closest to a tie, and both reports.
PAGES = ["bench_03.png", "bench_08.png", "report_clean.png", "report_degraded.png"]


def test_extractor_holds_the_jax_record(extractor):
    pages = ocr_parity.load_record(FIXTURES, PAGES)
    assert [p.file for p in pages] == PAGES
    got = ocr_parity.check_against_record(extractor, pages)
    assert got["failures"] == []
    assert got["boxes_record"] == 4 + 8 + 6 + 6 and got["pages"] == 4
    assert got["max_quad_px"] <= ocr_parity.QUAD_TOL_PX
    assert got["cer_vs_record"] <= ocr_parity.CER_BOUND
    # bench_03's fourth box is a 16-pixel component whose last pixel lies at
    # 0.2998 here and 0.3027 in the record: a tie, not a fault.
    assert got["tie_pages"] == ["bench_03.png"]
    assert got["lines_paired"] == got["boxes_record"] - 1


def test_batched_extraction_matches_serial(extractor):
    pages = [p.image for p in ocr_parity.load_record(FIXTURES, ["bench_01.png", "bench_07.png"])]
    batched = extractor.extract_from_images(pages)
    assert sum(len(t) for t in batched) > 8
    assert batched == [extractor.extract_from_image(p) for p in pages]
    assert extractor.extract_from_images([]) == []
    blank = np.full((320, 448), 255, np.uint8)
    assert extractor.extract_from_images([blank, blank]) == [[], []]
    assert extractor.extract_lines_from_image(blank) == []


def test_report_files(extractor, tmp_path, caplog):
    path = FIXTURES / "report_clean.png"
    lines = extractor.extract_lines(path)
    assert extractor.extract(path) == [t for t, _ in lines]
    assert all(q.shape == (4, 2) for _, q in lines)
    # A JPEG page (baseline or progressive) reads as the JAX package's
    # Image.open(...).convert("RGB");
    # a truncated one warns and gives no lines, as there.
    from PIL import Image

    for name, kw in (("scan.jpg", {"quality": 92}), ("scan.jpeg", {"subsampling": 0}),
                     ("scan_p.jpg", {"progressive": True, "quality": 90})):
        Image.open(path).convert("RGB").save(tmp_path / name, "JPEG", **kw)
        page = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        got = extractor.extract_lines(tmp_path / name)
        want = extractor.extract_lines_from_image(page)
        assert [t for t, _ in got] == [t for t, _ in want] and len(got) > 4
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    (tmp_path / "cut.jpg").write_bytes(b"\xff\xd8\xff")
    with caplog.at_level(logging.WARNING, logger="spine_vision_torch"):
        assert extractor.extract(tmp_path / "cut.jpg") == []
    assert "OCR failed" in caplog.text
    # A missing raster decoder raises before any read: never an empty page.
    for name in ("scan.tif", "scan.tiff"):
        with pytest.raises(NotImplementedError, match="item 13"):
            extractor.extract(tmp_path / name)
        with pytest.raises(NotImplementedError, match="item 13"):
            extractor.extract_lines(tmp_path / name)
    # A PDF's first page renders through the port's renderer (io/pdf.py,
    # where the JAX package calls PyMuPDF): the clean report that Pillow
    # saved at 200 dpi reads its three fields; a corrupt one warns and gives
    # no lines, as in the JAX package.
    import shutil

    from spine_vision_torch.io.pdf import pdf_first_page_to_array

    fixture = FIXTURES.parent / "torch_pdf" / "raster_gray_200.pdf"
    truth = ocr_parity.load_record(FIXTURES, ["report_clean.png"])[0]
    for name in ("report.pdf", "report.PDF"):
        shutil.copy(fixture, tmp_path / name)
        got = extractor.extract_lines(tmp_path / name)
        want = extractor.extract_lines_from_image(pdf_first_page_to_array(fixture))
        assert [t for t, _ in got] == [t for t, _ in want] == extractor.extract(tmp_path / name)
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    text = " ".join(extractor.extract_from_pdf(tmp_path / "report.pdf"))
    fields = json.loads((FIXTURES / "manifest.json").read_text())["pages"]
    fields = next(p for p in fields if p["file"] == truth.file)["truth"]["fields"]
    assert all(fields[k] in text for k in ("id", "name", "birthday")), text
    assert extractor.extract_from_pdf_crop(tmp_path / "report.pdf", (0, 0, 10, 10)) == []
    (tmp_path / "cut.pdf").write_bytes(fixture.read_bytes()[:200])
    with caplog.at_level(logging.WARNING, logger="spine_vision_torch"):
        assert extractor.extract(tmp_path / "cut.pdf") == []
    assert "OCR failed" in caplog.text
    bad = tmp_path / "corrupt.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    with caplog.at_level(logging.WARNING, logger="spine_vision_torch"):
        assert extractor.extract(bad) == []
        assert extractor.extract_lines(tmp_path / "missing.png") == []
    assert "OCR failed" in caplog.text
    # An RGB PNG reads as cv2's IMREAD_COLOR, whose gray mean is the page.
    page = ocr_parity.load_record(FIXTURES, ["report_clean.png"])[0].image
    rgb = tmp_path / "rgb.png"
    write_png(rgb, np.repeat(page[..., None], 3, axis=-1))
    assert extractor.extract_lines(rgb)[2][0] == lines[2][0]


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (DocumentExtractor, TextDetector, TextRecognizer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_recognizer_checks_its_patches():
    with pytest.raises(ValueError, match="patch_height"):
        TextRecognizer(patch_height=48, device="cpu")
    recognizer = TextRecognizer(device="cpu")
    assert recognizer.recognize_batch(np.zeros((0, 32, 256), np.float32)) == []
    with pytest.raises(ValueError, match="patch width"):
        recognizer.recognize_batch(np.zeros((2, 32, 128), np.float32))
    with pytest.raises(ValueError, match=r"\[N, h, w\]"):
        recognizer.recognize_batch(np.zeros((2, 32, 256, 1), np.float32))
    with pytest.raises(FileNotFoundError):
        TextDetector(weights_dir=FIXTURES, device="cpu")


def test_shipped_weights_load_as_the_jax_package_reads_them():
    for name in ("ocr_detector", "ocr_recognizer"):
        got = load_variables_npz(DEFAULT_WEIGHTS_DIR / f"{name}.npz")
        want = jocr.load_variables_npz(jocr.DEFAULT_WEIGHTS_DIR / f"{name}.npz")
        flat_got = dict(_leaves(got))
        flat_want = dict(_leaves(want))
        assert flat_got.keys() == flat_want.keys()
        for key, value in flat_want.items():
            assert flat_got[key].dtype == value.dtype == np.float32
            np.testing.assert_array_equal(flat_got[key], value)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def test_character_error_rate_matches_jax():
    pairs = [(["abc", "", "Ngày sinh"], ["abd", "x", "Ngày sinh:"]), ([], []),
             (["", ""], ["", ""]), (["đđđ"], ["d"])]
    for pred, target in pairs:
        assert character_error_rate(pred, target) == jocr.character_error_rate(pred, target)
