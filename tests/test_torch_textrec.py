"""The port's text recognizer (``spine_vision_torch/models/textrec.py``) and
Flax-layout attention against ``spine_vision_tpu/models/textrec.py`` and
``flax.linen.MultiHeadDotProductAttention`` on the same seeded inputs.

XLA computes the Flax modules' bf16 operations in f32 and rounds each
result to bf16, except where the model casts it up to f32; the port rounds
at the same points and sums in another order. Tolerances, in units of the
largest |output|: the attention (added to its f32 input, as the net uses
it) and the net's logits with the median gap within 1e-5 (f32 rounding; a
port rounding elsewhere than XLA moves the median far past it) and the
largest within 2e-2 (a value on the other side of a bf16 rounding step
moves its neighbourhood). The decode and the charset equal.
"""

from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from spine_vision_torch.models import textrec as tr
from spine_vision_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
    random_flax_variables,
)
from spine_vision_torch.models.layers import MultiHeadDotProductAttention
from spine_vision_tpu.models import textrec as jr

MEDIAN_GAP = 1e-5
MAX_GAP = 2e-2


def _assert_close(got, want):
    scale = np.abs(want).max()
    gap = np.abs(got - want) / scale
    assert np.median(gap) <= MEDIAN_GAP and gap.max() <= MAX_GAP, (np.median(gap), gap.max())


def test_attention_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 10, 32)).astype(np.float32)
    mod = MultiHeadDotProductAttention(32, 4)
    params, _ = random_flax_variables(mod, seed=2)
    load_flax_variables(mod, params)
    assert {k: v["kernel"].shape for k, v in params.items()} == {
        "query": (32, 4, 8), "key": (32, 4, 8), "value": (32, 4, 8), "out": (4, 8, 32)}
    with torch.no_grad():
        got = (torch.from_numpy(x) + mod(torch.from_numpy(x))).numpy()
    flax_mod = nn.MultiHeadDotProductAttention(num_heads=4, dtype=jnp.bfloat16)
    want = jax.jit(lambda p, x: x + flax_mod.apply({"params": p}, x, x))(params, jnp.asarray(x))
    _assert_close(got - x, np.asarray(want) - x)


def _nets(seed: int):
    net = tr.TextRecognitionNet(width=16, num_layers=2, num_heads=4, patch_width=64).eval()
    params, stats = random_flax_variables(net, seed=seed)
    load_flax_variables(net, params, stats)
    return net, {"params": params, "batch_stats": stats}


def test_recognition_net_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (3, 32, 64, 1)).astype(np.float32)
    net, variables = _nets(seed=4)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jr.TextRecognitionNet(width=16).apply)(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (3, 16, tr.charset_size())
    _assert_close(got, want)


def test_recognition_net_variables_round_trip():
    net, variables = _nets(seed=6)
    params, stats = export_flax_variables(net)
    assert params["pos_embedding"].shape == (1, 16, 64)
    assert params["MultiHeadDotProductAttention_1"]["out"]["kernel"].shape == (4, 16, 64)
    # Kernels live in bf16 (the Flax model's casts), so they come back rounded.
    want = variables["params"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(
        params["Dense_0"]["kernel"], torch.from_numpy(want).bfloat16().float().numpy())
    np.testing.assert_array_equal(params["pos_embedding"], variables["params"]["pos_embedding"])
    np.testing.assert_array_equal(stats["BatchNorm_3"]["var"],
                                  variables["batch_stats"]["BatchNorm_3"]["var"])


def test_ctc_greedy_decode_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, 40, tr.charset_size())).astype(np.float32)
    logits[:, ::3, tr.BLANK_ID] += 3.0  # blanks and repeats to collapse
    logits[:, 1::7] = logits[:, 2::7][:, : logits[:, 1::7].shape[1]]
    assert tr.VIETNAMESE_CHARSET == jr.VIETNAMESE_CHARSET
    assert tr.charset_size() == jr.charset_size() == 218
    assert tr.ctc_greedy_decode(logits) == jr.ctc_greedy_decode(logits)


def test_shipped_recognizer_full_width_logits_match_jax():
    """The shipped recognizer at its full width on the rectified boxes of
    two record pages (JAX's quads from ``tests/fixtures/torch_ocr``), the
    port against ``jax.jit(TextRecognitionNet().apply)`` with the shipped
    variables: the card test's bounds (median 1e-3 of max |logit|, max
    2e-2), which at full width the attention's spread of bf16 rounding
    steps needs, on the CPU as on the card."""
    from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor
    from spine_vision_torch.utils.ocr_parity import load_record
    from spine_vision_tpu.train.ocr import DEFAULT_WEIGHTS_DIR, load_variables_npz

    fixtures = Path(__file__).resolve().parent / "fixtures" / "torch_ocr"
    pages = load_record(fixtures, ["bench_00.png", "report_clean.png"])
    extractor = DocumentExtractor(device="cpu")
    quads = [np.asarray(p.jax["quads"], np.float32).reshape(-1, 4, 2) for p in pages]
    patches = extractor.rectify_pages([p.image for p in pages], quads).numpy()
    assert patches.shape[0] == sum(len(q) for q in quads) > 10
    got = extractor.recognizer.logits(patches)
    variables = load_variables_npz(DEFAULT_WEIGHTS_DIR / "ocr_recognizer.npz")
    net = jr.TextRecognitionNet()
    want = np.asarray(jax.jit(lambda v, x: net.apply(v, x, train=False))(
        variables, jnp.asarray(patches / 255.0)[..., None]))
    assert got.shape == want.shape == (patches.shape[0], 64, tr.charset_size())
    gap = np.abs(got - want) / np.abs(want).max()
    assert np.median(gap) <= 1e-3 and gap.max() <= 2e-2, (np.median(gap), gap.max())
