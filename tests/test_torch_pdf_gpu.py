"""The PDF report path on the card: pages rendered by the port's renderer
(``spine_vision_torch/io/pdf.py``, host C++) read by the shipped OCR on the
CUDA device. Skips without one. The file imports neither JAX nor the JAX
package, nor Pillow or matplotlib, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_pdf_gpu.py
"""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from spine_vision_torch.io import pdf as tpdf

pytestmark = pytest.mark.gpu

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_pdf"
RECORD = json.loads((FIXTURES / "record.json").read_text())


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the OCR nets run on the card here")
    return torch.device("cuda")


def test_reports_render_as_recorded_and_read_on_the_card(cuda):
    from spine_vision_torch.data.phenikaa import DEFAULT_PDF_ID_CROP_REGION
    from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor

    extractor = DocumentExtractor(device=cuda)
    for name, fields in RECORD["reports"].items():
        page = tpdf.pdf_first_page_to_array(FIXTURES / name, RECORD["dpi"])
        want = RECORD["pages"][name][0]
        assert [list(page.shape), hashlib.sha256(page.tobytes()).hexdigest()] == [
            want["shape"], want["sha256"]]
        crop = extractor.extract_from_pdf_crop(FIXTURES / name, DEFAULT_PDF_ID_CROP_REGION)
        assert crop == [f"Số phiếu: {fields['id']}"]
        text = " ".join(extractor.extract_from_pdf(FIXTURES / name))
        assert all(fields[k] in text for k in ("id", "name", "birthday")), text
