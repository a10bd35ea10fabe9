"""The port's perspective rectification (``spine_vision_torch/ops/warp.py``)
against ``spine_vision_tpu/ops/warp.py`` on the same seeded numpy inputs.

Tolerances: the homographies within 1e-4 relative (two LAPACK LU solves of
one f32 8x8 system); the patches within 0.05 gray levels of [0, 255] (the
sample coordinates differ by f32 rounding of the solve, times the image's
local slope).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.ops import warp as tw
from spine_vision_tpu.ops import warp as jw

PATCH_ATOL = 0.05


def _quads(rng, n, h, w):
    """Random convex-ish quads TL, TR, BR, BL inside (and a little past) an
    h x w image."""
    x1 = rng.uniform(-5, w * 0.6, n)
    y1 = rng.uniform(-5, h * 0.6, n)
    bw = rng.uniform(10, w * 0.5, n)
    bh = rng.uniform(6, h * 0.4, n)
    jitter = rng.uniform(-2, 2, (n, 4, 2))
    quads = np.stack([
        np.stack([x1, y1], -1), np.stack([x1 + bw, y1], -1),
        np.stack([x1 + bw, y1 + bh], -1), np.stack([x1, y1 + bh], -1),
    ], axis=1)
    return (quads + jitter).astype(np.float32)


def test_perspective_matrix_matches_jax():
    rng = np.random.default_rng(0)
    quads = _quads(rng, 6, 60, 90)
    dst = np.array([[0, 0], [255, 0], [255, 31], [0, 31]], np.float32)
    got = tw.perspective_matrix(torch.from_numpy(quads), torch.from_numpy(dst)).numpy()
    assert got.shape == (6, 3, 3)
    for q, g in zip(quads, got):
        want = np.asarray(jw.perspective_matrix(jnp.asarray(q), jnp.asarray(dst)))
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-6)
    one = tw.perspective_matrix(torch.from_numpy(quads[0]), torch.from_numpy(dst)).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("form", ["plain", "bounds", "offsets", "both"])
def test_rectify_polygons_matches_jax(form):
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 255, (70, 90)).astype(np.float32)
    quads = _quads(rng, 5, 35, 90)
    kw = {}
    if form in ("bounds", "both"):
        kw["bounds"] = rng.uniform(20, 60, (5, 2)).astype(np.float32)
    if form in ("offsets", "both"):
        kw["offsets"] = np.stack([rng.integers(0, 30, 5), np.zeros(5)], -1).astype(np.float32)
    got = tw.rectify_polygons(torch.from_numpy(image), torch.from_numpy(quads), 16, 48,
                              **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    want = np.asarray(jw.rectify_polygons(jnp.asarray(image), jnp.asarray(quads), 16, 48,
                                          **{k: jnp.asarray(v) for k, v in kw.items()}))
    assert got.shape == want.shape == (5, 16, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=PATCH_ATOL, rtol=0)


def test_rectify_polygons_identity():
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    quad = np.array([[[10.0, 5.0], [29.0, 5.0], [29.0, 24.0], [10.0, 24.0]]], np.float32)
    out = tw.rectify_polygons(torch.from_numpy(image), torch.from_numpy(quad), 20, 20)[0]
    np.testing.assert_allclose(out.numpy(), image[5:25, 10:30], rtol=1e-4, atol=1e-2)


def test_rectify_polygons_page_bounds_match_per_page():
    """Pages stacked into one tall image, page-local quads with per-quad
    bounds and row offsets, give each page's own rectification, quads
    hanging past their page's edge included (they repeat that page's
    border, not the next page's rows)."""
    rng = np.random.default_rng(1)
    pages = [rng.uniform(0, 255, (40, 60)).astype(np.float32),
             rng.uniform(0, 255, (30, 50)).astype(np.float32)]
    quads = [np.array([[5.0, 30.0], [40.0, 30.0], [40.0, 45.0], [5.0, 45.0]], np.float32),
             np.array([[20.0, 5.0], [55.0, 5.0], [55.0, 20.0], [20.0, 20.0]], np.float32)]
    per_page = [tw.rectify_polygons(torch.from_numpy(p), torch.from_numpy(q)[None], 16, 48)[0]
                for p, q in zip(pages, quads)]
    hmax, wmax = 40, 60
    stacked = np.zeros((2, hmax, wmax), np.float32)
    for i, p in enumerate(pages):
        stacked[i, : p.shape[0], : p.shape[1]] = p
    batched = tw.rectify_polygons(
        torch.from_numpy(stacked.reshape(-1, wmax)), torch.from_numpy(np.stack(quads)), 16, 48,
        bounds=torch.tensor([[39.0, 59.0], [29.0, 49.0]]),
        offsets=torch.tensor([[0.0, 0.0], [float(hmax), 0.0]]),
    )
    for got, want in zip(batched, per_page):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PATCH_ATOL)
