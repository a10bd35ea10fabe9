"""The port's text detector (``spine_vision_torch/models/textdet.py``) and
Flax-order BatchNorm against ``spine_vision_tpu/models/textdet.py`` and
``flax.linen.BatchNorm`` on the same seeded inputs, and its box extraction
(``scipy.ndimage``) against the JAX package's cv2 path.

Tolerances: BatchNorm 1e-6 (the same f32 operations in the same order);
the net's probabilities: the median gap 1e-5 and the largest 1.5e-2. XLA
keeps the bf16 convolutions' sums in f32 and so does the port, but in
another order, so most probabilities agree to f32 rounding, while an
activation that lands on the other side of a bf16 rounding step before the
next convolution moves its neighbourhood; rounding every convolution's
output to bf16 would move the median by far more than 1e-5.
Boxes equal.
"""

import json
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

from spine_vision_torch.data.phenikaa.ocr import TextDetector
from spine_vision_torch.data.png import read_png
from spine_vision_torch.models import textdet as td
from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
from spine_vision_torch.models.layers import FlaxBatchNorm
from spine_vision_tpu.models import textdet as jd

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_ocr"
PROB_MEDIAN_GAP = 1e-5
PROB_ATOL = 1.5e-2


def test_flax_batchnorm_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    mod = FlaxBatchNorm(16)
    params, stats = random_flax_variables(mod, seed=3)
    load_flax_variables(mod, params, stats)
    xb = torch.from_numpy(x).bfloat16()
    got = mod(xb)
    want = nn.BatchNorm(use_running_average=True, dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_detection_net_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 64, 96, 1)).astype(np.float32)
    net = td.TextDetectionNet(width=8).eval()
    params, stats = random_flax_variables(net, seed=5)
    params["Conv_0"]["kernel"] *= 20  # a map spread over (0, 1), not all near 0.5
    load_flax_variables(net, params, stats)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jd.TextDetectionNet(width=8).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 32, 48, 1)
    assert want.std() > 0.2
    assert np.median(np.abs(got - want)) <= PROB_MEDIAN_GAP
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


@settings(max_examples=60, deadline=None)
@given(arrays(np.bool_, st.tuples(st.integers(1, 40), st.integers(1, 40))),
       st.sampled_from([1, 4, 16]))
def test_boxes_match_jax_cv2_on_random_maps(binary, min_area):
    prob = binary.astype(np.float32)
    got = td.extract_boxes_from_probmap(prob, min_area=min_area)
    want = jd.extract_boxes_from_probmap(prob, min_area=min_area)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_boxes_match_jax_cv2_on_fixture_maps_and_page_padding():
    """On the port's maps of three fixture pages, the boxes equal the cv2
    path's; and padding the batch to a power of two (the JAX package's
    guard against recompiles) leaves them unchanged, so the port drops it."""
    pages = [read_png(FIXTURES / f"bench_{i:02d}.png", mode="gray") for i in (0, 3, 9)]
    detector = TextDetector(device="cpu")
    maps = detector.probability_maps(pages)
    assert maps.shape == (3, 256, 256)
    boxes = [td.extract_boxes_from_probmap(m) for m in maps]
    for m, got in zip(maps, boxes):
        np.testing.assert_array_equal(got, jd.extract_boxes_from_probmap(m))
    assert sum(len(b) for b in boxes) > 10
    white = np.full_like(pages[0], 255)
    padded = detector.detect_batch(pages + [white])
    assert len(padded[3]) == 0
    for got, want in zip(padded[:3], boxes):
        np.testing.assert_array_equal(got, want)


def test_manifest_ties_are_what_resolves_the_fixture_boxes():
    """Thresholding the port's own map with the JAX record's decisions at
    its tie pixels gives the record's boxes exactly."""
    from spine_vision_torch.utils.ocr_parity import resolve_ties

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    page = next(p for p in manifest["pages"] if p["file"] == "bench_03.png")
    detector = TextDetector(device="cpu")
    prob = detector.probability_maps([read_png(FIXTURES / page["file"], mode="gray")])[0]
    got = td.extract_boxes_from_probmap(resolve_ties(prob, page["jax"]["ties"]))
    np.testing.assert_allclose(got, np.asarray(page["jax"]["quads"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(0, 0), (5, 0)])
def test_boxes_of_an_empty_map(shape):
    got = td.extract_boxes_from_probmap(np.zeros(shape, np.float32))
    assert got.shape == (0, 4, 2) and got.dtype == np.float32
