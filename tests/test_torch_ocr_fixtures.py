"""The OCR fixture (``tests/fixtures/torch_ocr``) is what its generator
makes, with no hand edits: the JAX package's synth renders the committed
pages again bit for bit, with the manifest's ground truth, and the JAX
package's ``DocumentExtractor`` with the shipped weights gives the
manifest's quads, texts and threshold ties on the committed pages.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from spine_vision_torch.data.png import read_png

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_ocr"


@pytest.fixture(scope="module")
def generator():
    spec = importlib.util.spec_from_file_location("torch_ocr_generate", FIXTURES / "generate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def rendered(generator):
    return generator.render_pages()


def _manifest():
    return {p["file"]: p for p in json.loads((FIXTURES / "manifest.json").read_text())["pages"]}


def test_pages_are_the_synth_pages_bit_for_bit(rendered):
    manifest = _manifest()
    assert [name for name, _, _ in rendered] == list(manifest)
    for name, page, truth in rendered:
        np.testing.assert_array_equal(read_png(FIXTURES / name, mode="gray"), page, err_msg=name)
        assert json.loads(json.dumps(truth)) == manifest[name]["truth"], name
    total = sum((FIXTURES / name).stat().st_size for name, _, _ in rendered)
    assert total + (FIXTURES / "manifest.json").stat().st_size <= 1.5e6


def test_manifest_is_the_jax_extractors_record(generator, rendered):
    record = generator.jax_record(rendered, FIXTURES)
    manifest = _manifest()
    for name, want in record.items():
        got = manifest[name]["jax"]
        assert got["texts"] == want["texts"], name
        np.testing.assert_array_equal(np.asarray(got["quads"]), np.asarray(want["quads"]))
        assert got["ties"] == want["ties"], name
