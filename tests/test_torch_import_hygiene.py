"""Rules of the PyTorch port that later slices must keep.

- No module of ``spine_vision_torch`` (nor ``chip_smoke.py``) imports JAX,
  Flax, optax or the JAX package; the port imports and runs without them.
  Nor cv2, PIL, rapidfuzz, PyMuPDF, fontTools, pandas, pydantic, tqdm or
  openpyxl: the port runs where none is installed (it renders PDF pages
  itself, with their fonts).
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
             "rapidfuzz", "fitz", "pymupdf", "pandas", "pydantic", "tqdm", "openpyxl",
             "fontTools")
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
        "import spine_vision_torch.parallel, spine_vision_torch.io.jpeg\n"
        "import spine_vision_torch.io.jpeg2000\n"
        "import spine_vision_torch.io.pdf, spine_vision_torch.io.pdf_parse\n"
        "import spine_vision_torch.io.pdf_fonts, spine_vision_torch.io.pdf_render\n"
        "from spine_vision_torch.io.pdf import pdf_first_page_to_array\n"
        "assert pdf_first_page_to_array('tests/fixtures/torch_pdf/report_type42.pdf', 72)"
        ".shape == (842, 596, 3)\n"
        "import spine_vision_torch.cli, spine_vision_torch.cli.train\n"
        "import spine_vision_torch.viz, spine_vision_torch.viz.tracker\n"
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
    # The CLI: every subcommand that builds a model, a pipeline or a builder
    # (--device cpu asks for the CPU).
    from spine_vision_torch import cli
    from spine_vision_torch.viz import ExperimentTracker

    for argv in (["train", "localization"], ["evaluate", "classification"],
                 ["dataset", "phenikaa"], ["serve", "--loc-checkpoint", "a",
                                           "--cls-checkpoint", "b", "--watch-dir", "w",
                                           "--output-dir", "o"]):
        with pytest.raises(RuntimeError, match="device='cpu'.*--device cpu"):
            cli.cli(argv)
    ExperimentTracker("p", "r", tmp_path / "tracker").log_metrics({"x": 1.0})
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
