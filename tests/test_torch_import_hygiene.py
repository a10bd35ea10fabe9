"""Rules of the PyTorch port that later slices must keep.

- No module of ``spine_vision_torch`` (nor ``chip_smoke.py``) imports JAX,
  Flax, optax or the JAX package; the port imports and runs without them.
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "spine_vision_tpu")
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
        "import chip_smoke\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Classifier("resnet18")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoordinateRegressor("convnext_tiny")
    loc = CoordinateRegressor("convnext_tiny", dtype=torch.float32, device="cpu")
    cls = Classifier("resnet18", dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StudyInferencePipeline(loc, cls)


def test_chip_smoke_refuses_to_run_without_a_card():
    """No card here: the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode != 0 and '"ok"' not in out.stdout
