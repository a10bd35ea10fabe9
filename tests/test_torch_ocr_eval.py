"""The shipped OCR weights scored by the port's evaluation functions
(``spine_vision_torch/train/ocr.py``) on the port's rendered sets, on the
CPU, against the JAX package's figures for the same functions and seeds.

The JAX package's own runs (``evaluate_recognizer`` at seed 123 over 256
lines, ``evaluate_detector`` over 32 pages, ``evaluate_layout_extraction``
over 5) give CER 0.0689 clean, 0.1318 under ``degrade="hard"`` and 0.1579 in
the six holdout faces, box recall 1.000 and 0.988, and 1.0 of the report
pages. The port renders those sets bit for bit (``tests/test_torch_synth.py``),
so its figures differ only by the nets' arithmetic: the bands here are
0.005 (measured 0.06937, 0.13178 and 0.15771; the bands a card run must
meet are 0.02 and 0.03). The scoring itself is held to JAX's on JAX-rendered
lines and pages: within one character and one box.
"""

import numpy as np
import pytest
import torch

from spine_vision_torch.data.phenikaa import synth as ps
from spine_vision_torch.models.convert import load_variables_npz
from spine_vision_torch.train import ocr
from spine_vision_tpu.data.phenikaa import synth as js
from spine_vision_tpu.models.textdet import TextDetectionNet as JDet
from spine_vision_tpu.models.textrec import TextRecognitionNet as JRec
from spine_vision_tpu.train import ocr as jocr

JAX_CER = {"clean": 0.0689, "hard": 0.1318, "unseen_font": 0.1579}
JAX_RECALL = {"clean": 1.000, "hard": 0.988}
BAND = 0.005


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shipped():
    return (load_variables_npz(ocr.DEFAULT_WEIGHTS_DIR / "ocr_recognizer.npz"),
            load_variables_npz(ocr.DEFAULT_WEIGHTS_DIR / "ocr_detector.npz"))


_SETS = {"clean": {}, "hard": {"degrade": "hard"},
         "unseen_font": {"fonts": ps.HOLDOUT_FONT_PATHS}}


@pytest.mark.parametrize("name", list(JAX_CER))
def test_shipped_recognizer_cer_on_the_ports_lines(shipped, name):
    cer = ocr.evaluate_recognizer(None, shipped[0], device="cpu", **_SETS[name])
    assert abs(cer - JAX_CER[name]) <= BAND, cer


@pytest.mark.parametrize("name", list(JAX_RECALL))
def test_shipped_detector_recall_on_the_ports_pages(shipped, name):
    recall = ocr.evaluate_detector(None, shipped[1], device="cpu", **_SETS[name])
    assert abs(recall - JAX_RECALL[name]) <= BAND, recall


def test_shipped_weights_extract_the_unseen_layout(shipped):
    assert ocr.evaluate_layout_extraction(shipped[1], shipped[0], device="cpu") == 1.0


def test_recognizer_scoring_matches_jax_on_jax_lines(shipped):
    rec = jocr.load_variables_npz(jocr.DEFAULT_WEIGHTS_DIR / "ocr_recognizer.npz")
    want = jocr.evaluate_recognizer(JRec(), rec, n=128, degrade="hard")
    images, _, _, texts = js.recognition_batch(np.random.default_rng(123), 128, degrade="hard")
    got = ocr._recognizer_cer(None, shipped[0], images, texts, 256, "cpu")
    chars = sum(max(len(t), 1) for t in texts)
    assert abs(got - want) * chars <= 1 + 1e-9, (got, want)


def test_detector_scoring_matches_jax_on_jax_pages(shipped):
    det = jocr.load_variables_npz(jocr.DEFAULT_WEIGHTS_DIR / "ocr_detector.npz")
    want = jocr.evaluate_detector(JDet(), det, n_pages=16, degrade="hard")
    rng = np.random.default_rng(123)
    pages = [js.detection_page(rng, (320, 448), augment=False, degrade="hard")
             for _ in range(16)]
    net = ocr._load(ocr.TextDetectionNet(device="cpu"), shipped[1]).eval()
    with torch.no_grad():
        probs = [net(torch.from_numpy(p / 255.0).float()[None, ..., None])[0, :, :, 0].numpy()
                 for p, _, _ in pages]
    matched, total = ocr.box_recall(probs, [b for _, b, _ in pages])
    assert abs(matched - want * total) <= 1 + 1e-9, (matched, want * total)
