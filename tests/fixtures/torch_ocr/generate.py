"""Write the OCR fixture pages and their manifest.

    JAX_PLATFORMS=cpu python tests/fixtures/torch_ocr/generate.py

The pages, rendered by the JAX package's synth (PIL and TrueType fonts) and
rounded to uint8 gray PNGs:

- ``bench_00.png`` .. ``bench_15.png``: ``bench.py``'s 16 OCR pages (rng 0,
  320x448, ``degrade="mild"``, ``degrade_p=0.5``);
- ``report_clean.png`` and ``report_degraded.png``: the report pages of
  ``tests/test_ocr_trained.py`` (rng 0, and rng 3 with the "mild" scan
  degradation).

``manifest.json`` records for each page the rendered ground truth (texts,
xyxy boxes, a report's three field values) and the JAX package's
``DocumentExtractor`` output with the shipped weights on the uint8 page:
its quads and texts (``extract_from_images`` over the 16 bench pages as one
batch, ``extract_lines`` on each report file), and the threshold ties: each
pixel ``[y, x, decision]`` of the detector's map (as that call computes it)
within ``TIE_BAND`` of the 0.3 threshold, with JAX's decision (1 when at
or above it). Two correct implementations that sum in another order differ
by a few 1e-3 there, so a comparison of boxes takes JAX's decision at those
pixels. ``tests/test_torch_ocr_fixtures.py``
holds the committed files to this generator; the PyTorch port's OCR is held
to the manifest on the CPU (``tests/test_torch_ocr.py``) and on the card
(``chip_smoke.py``'s ``ocr`` phase).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BENCH_PAGES = 16
THRESHOLD = 0.3  # the detector's binarization threshold
TIE_BAND = 0.01
REPORTS = (
    # (file, rng seed, name, birthday, report id, degraded)
    ("report_clean.png", 0, "Nguyễn Văn An", "15/05/1980", "250012345", False),
    ("report_degraded.png", 3, "Trần Thị Hương", "02/11/1975", "250054321", True),
)


def _to_uint8(page: np.ndarray) -> np.ndarray:
    return np.clip(np.round(page), 0, 255).astype(np.uint8)


def _report_truth(name: str, birthday: str, report_id: str) -> tuple[list, list]:
    """The lines and xyxy boxes ``synth.render_report_page`` draws."""
    from PIL import Image, ImageDraw, ImageFont

    from spine_vision_tpu.data.phenikaa import synth

    font = ImageFont.truetype(synth.FONT_PATHS[0], 20)
    draw = ImageDraw.Draw(Image.new("L", (640, 448)))
    lines = [
        "BỆNH VIỆN ĐẠI HỌC PHENIKAA",
        "PHIẾU CHỈ ĐỊNH CHỤP MRI",
        f"Số phiếu: {report_id}",
        f"Họ tên người bệnh: {name}",
        f"Ngày sinh: {birthday}",
        "Chẩn đoán: Thoát vị đĩa đệm",
    ]
    boxes = [list(draw.textbbox((24, 24 + 42 * i), line, font=font)) for i, line in enumerate(lines)]
    return lines, boxes


def render_pages() -> list[tuple[str, np.ndarray, dict]]:
    """``(file name, uint8 page, ground truth)`` of every fixture page."""
    from spine_vision_tpu.data.phenikaa import synth

    pages = []
    rng = np.random.default_rng(0)
    for i in range(BENCH_PAGES):
        page, boxes, texts = synth.detection_page(rng, (320, 448), degrade="mild", degrade_p=0.5)
        truth = {"texts": texts, "boxes": np.asarray(boxes, np.float64).tolist()}
        pages.append((f"bench_{i:02d}.png", _to_uint8(page), truth))
    for name, seed, patient, birthday, report_id, degraded in REPORTS:
        rng = np.random.default_rng(seed)
        page = synth.render_report_page(patient, birthday, report_id, rng)
        lines, boxes = _report_truth(patient, birthday, report_id)
        boxes = np.asarray(boxes, np.float32)
        if degraded:
            page, boxes = synth.degrade_image(page, rng, profile="mild", boxes=boxes)
        truth = {"texts": lines, "boxes": np.asarray(boxes, np.float64).tolist(),
                 "fields": {"name": patient, "birthday": birthday, "id": report_id}}
        pages.append((name, _to_uint8(page), truth))
    return pages


def _ties(prob_map: np.ndarray) -> list[list[int]]:
    ys, xs = np.nonzero(np.abs(prob_map - THRESHOLD) < TIE_BAND)
    return [[int(y), int(x), int(prob_map[y, x] >= THRESHOLD)] for y, x in zip(ys, xs)]


def _maps(detector, images: list[np.ndarray]) -> np.ndarray:
    """The JAX detector's maps of a batch, as its ``detect_batch`` computes
    them."""
    from spine_vision_tpu.data.phenikaa.ocr import _pad_to_multiple_2d, _to_gray_f32

    grays = [_pad_to_multiple_2d(_to_gray_f32(im) / 255.0, detector.shape_bucket, value=1.0)
             for im in images]
    n = len(grays)
    stacked = np.ones((1 << (n - 1).bit_length(), grays[0].shape[0], grays[0].shape[1]),
                      np.float32)
    for i, g in enumerate(grays):
        stacked[i] = g
    batch = stacked[..., None]
    return np.asarray(detector._forward(detector._ensure_variables(batch), batch))[:n, :, :, 0]


def jax_record(pages: list[tuple[str, np.ndarray, dict]], directory: Path) -> dict:
    """``{file: {"quads": ..., "texts": ..., "ties": ...}}``: the JAX
    package's ``DocumentExtractor`` with the shipped weights, the bench
    pages as one batch, each report read from its PNG file in
    ``directory``."""
    from spine_vision_tpu.data.phenikaa.ocr import DocumentExtractor

    extractor = DocumentExtractor()
    bench = [(name, page) for name, page, _ in pages if name.startswith("bench_")]
    images = [page for _, page in bench]
    quads = extractor.detector.detect_batch(images)
    texts = extractor.extract_from_images(images)
    maps = _maps(extractor.detector, images)
    record = {
        name: {"quads": np.asarray(q, np.float64).tolist(), "texts": t, "ties": _ties(m)}
        for (name, _), q, t, m in zip(bench, quads, texts, maps)
    }
    for name, page, _ in pages:
        if not name.startswith("bench_"):
            lines = extractor.extract_lines(directory / name)
            record[name] = {"quads": [np.asarray(q, np.float64).tolist() for _, q in lines],
                            "texts": [t for t, _ in lines],
                            "ties": _ties(_maps(extractor.detector, [page])[0])}
    return record


def main() -> None:
    from PIL import Image

    pages = render_pages()
    for name, page, _ in pages:
        Image.fromarray(page, "L").save(HERE / name, optimize=True)
    record = jax_record(pages, HERE)
    manifest = {
        "pages": [{"file": name, "truth": truth, "jax": record[name]} for name, _, truth in pages]
    }
    (HERE / "manifest.json").write_text(json.dumps(manifest, ensure_ascii=False, indent=1) + "\n")


if __name__ == "__main__":
    main()
