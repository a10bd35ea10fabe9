"""Rules of the PyTorch port that later slices must keep.

- No module of ``spine_vision_torch`` (nor ``chip_smoke.py``) imports JAX,
  Flax, optax or the JAX package; the port imports and runs without them.
  Nor cv2, PIL, rapidfuzz, PyMuPDF, pandas, pydantic, tqdm or openpyxl: the
  port runs where none is installed.
- Entry points run on the card by default and raise when there is none,
  instead of carrying on quietly on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spine_vision_torch.infer.pipeline import StudyInferencePipeline
from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "spine_vision_tpu", "cv2", "PIL",
             "rapidfuzz", "fitz", "pymupdf", "pandas", "pydantic", "tqdm", "openpyxl")
SOURCES = sorted((ROOT / "spine_vision_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        "import spine_vision_torch.infer.pipeline, spine_vision_torch.models.convert\n"
        "import spine_vision_torch.data.png, spine_vision_torch.data.cache\n"
        "import spine_vision_torch.train.classification, spine_vision_torch.utils.profiling\n"
        "import spine_vision_torch.data.phenikaa.ocr, spine_vision_torch.utils.ocr_parity\n"
        "import spine_vision_torch.io, spine_vision_torch.io.series, spine_vision_torch.native\n"
        "import spine_vision_torch.ops.resample, spine_vision_torch.core.registry\n"
        "import spine_vision_torch.infer.serve, spine_vision_torch.data.builders\n"
        "import spine_vision_torch.data.rsna, spine_vision_torch.data.phenikaa\n"
        "import spine_vision_torch.parallel\n"
        "import spine_vision_torch.train.ocr, spine_vision_torch.ops.ctc\n"
        "import spine_vision_torch.data.phenikaa.synth, spine_vision_torch.data.phenikaa.raster\n"
        "import spine_vision_torch.data.phenikaa.text\n"
        "import spine_vision_torch.models, spine_vision_torch.models.inference\n"
        "import spine_vision_torch.ops.pool, spine_vision_torch.data.pillow_resize\n"
        "from spine_vision_torch.models import heads, vit, swin, efficientnet\n"
        "from spine_vision_torch.data.phenikaa import synth\n"
        "synth.recognition_batch(__import__('numpy').random.default_rng(0), 2, degrade='hard')\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Classifier("resnet18")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoordinateRegressor("convnext_tiny")
    loc = CoordinateRegressor("convnext_tiny", dtype=torch.float32, device="cpu")
    cls = Classifier("resnet18", dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StudyInferencePipeline(loc, cls)
    from spine_vision_torch.train import ocr

    for entry in (ocr.train_recognizer, ocr.train_detector):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ocr.train_ocr_stack(tmp_path)
    for entry, size in ((ocr.evaluate_recognizer, {"n": 1}),
                        (ocr.evaluate_recognizer_mpl, {"n": 1}),
                        (ocr.evaluate_detector, {"n_pages": 1}),
                        (ocr.evaluate_layout_extraction, {"n_pages": 1})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(None, None, **size)


def test_chip_smoke_refuses_to_run_without_a_card():
    """No card here: the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode != 0 and '"ok"' not in out.stdout
