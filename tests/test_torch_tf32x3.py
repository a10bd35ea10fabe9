"""The f32 product core's arithmetic and plan, as far as the CPU can hold
them (``csrc/wg_gemm.cuh``'s 3xTF32 path; the kernels themselves run on the
card, ``tests/test_torch_kernels_gpu.py``'s ``f32`` cases).

- The split: ``cvt.rna.tf32.f32`` is ``(bits + 0x1000) & 0xFFFFE000`` on the
  f32 bit pattern (round to nearest, ties away, the low 13 bits cleared as
  ``hop::tf32_hi`` clears them); ``x_lo = tf32(x - x_hi)``.
- The three-product sum: each K step of 8 adds ``a_lo . b_hi``, then ``a_hi
  . b_lo``, then ``a_hi . b_hi`` into an f32 accumulator (a TF32 x TF32
  product is exact in f32; each step's sum of 8 is rounded once), at the main
  path's depths, on operands drawn as the card tests draw them: within 1e-5
  of max |f64 product|, ten times inside the f32 forms' 1e-4 bound.
- The plan (``ops/fused_mlp.py::k_splits`` through ``product_geometry`` and
  ``bwd_geometry``): every K-major product gets at least min(132, its (tile,
  64-deep K range) units) units, and its split ranges cover K exactly once.
"""

import numpy as np
import pytest
import torch

from spine_vision_torch.ops import fused_mlp as fm

F32_REL_TOL = 1e-4  # chip_smoke.py's and the card tests' f32 bound
SMS = 132


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` with the low 13 bits cleared, as f32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32(x)
    return hi, tf32((x - hi).astype(np.float32))


def product_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a [M, K] . b [N, K]^T`` as the core sums it: per K step of 8, the
    products lo . hi, hi . lo, hi . hi, each step's sum rounded to f32 and
    added to the f32 accumulator in that order."""
    (ah, al), (bh, bl) = split(a), split(b)
    m, k = a.shape
    steps = k // 8
    acc = np.zeros((m, b.shape[0]), np.float32)

    def step_sums(x, y):  # [steps, M, N]: exact products, one rounding a step
        xs = x.astype(np.float64).reshape(m, steps, 8).transpose(1, 0, 2)
        ys = y.astype(np.float64).reshape(-1, steps, 8).transpose(1, 2, 0)
        return (xs @ ys).astype(np.float32)

    terms = (step_sums(al, bh), step_sums(ah, bl), step_sums(ah, bh))
    for s in range(steps):
        for t in terms:
            acc = (acc + t[s]).astype(np.float32)
    return acc


def test_split_rounds_to_tf32_and_keeps_the_rest():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096),
                        [0.0, -0.0, 1.0, -1.5, 2.0 ** -120, 3.4e38]]).astype(np.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()  # TF32: 10 mantissa bits
    # hi is x to nearest (ties away from zero): within half a TF32 step.
    step = np.abs(hi.astype(np.float64)) * 2.0 ** -10
    assert (np.abs(hi.astype(np.float64) - x) <= 0.5 * np.maximum(step, 2.0 ** -149) * 1.001).all()
    # hi + lo leaves a residue of about 2^-22 |x|.
    resid = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - x.astype(np.float64))
    assert (resid <= 2.0 ** -21 * np.abs(x.astype(np.float64)) + 2.0 ** -149).all()
    # A tie rounds away from zero: 1 + 2^-11 (halfway to the next TF32 value).
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], np.float32)
    assert (tf32(tie) == np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)], np.float32)).all()


@pytest.mark.parametrize("c", [128, 256, 512])
@pytest.mark.parametrize("which", ["hidden", "narrow"])
def test_three_products_hold_f32_accuracy(c, which):
    """K = C (F1, stage B: activations by W1) and K = 4C (F2, stage C: the
    hidden by W2 or W1^T), the card tests' draws: activations N(0, 1),
    weights N(0, 1) * K^-1/2, hidden values GELU-like (|N(0, 1)|)."""
    rng = np.random.default_rng(c + len(which))
    m, n = 64, 48
    if which == "hidden":
        k = c
        a = rng.normal(size=(m, k)).astype(np.float32)
    else:
        k = 4 * c
        a = np.abs(rng.normal(size=(m, k))).astype(np.float32)
    b = (rng.normal(size=(n, k)) * k ** -0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    got = product_3xtf32(a, b)
    err = np.abs(got - exact).max()
    scale = np.abs(exact).max()
    assert err <= 1e-5 * scale, (err, scale)
    assert err <= F32_REL_TOL / 10 * scale
    # One TF32 pass (hi . hi alone) is far outside the f32 bound: why three.
    (ah, _), (bh, _) = split(a), split(b)
    one = ah.astype(np.float64) @ bh.astype(np.float64).T
    assert np.abs(one - exact).max() > 10 * err


# (m, c): the train step's widths at B32 512^2 and the study graph's at B16,
# #5's path (B2 at 128^2), and the card tests' MLP_BWD_SHAPES (128, 507, 297
# and 5 tokens).
PLAN_SHAPES = sorted({
    *((32 * hw * hw, c) for hw, c in ((128, 128), (64, 256), (32, 512))),
    *((16 * hw * hw, c) for hw, c in ((128, 128), (64, 256), (32, 512))),
    *((2 * hw * hw, c) for hw, c in ((32, 128), (16, 256), (8, 512))),
    *((m, c) for m in (128, 507, 297, 5) for c in fm.KERNEL_WIDTHS),
})


def _ranges(splits: int, ks: int, k: int) -> list[tuple[int, int]]:
    return [(s * ks, min(k, (s + 1) * ks)) for s in range(splits)]


@pytest.mark.parametrize("m,c", PLAN_SHAPES)
def test_f32_plan_fills_the_card_and_covers_k_once(m, c):
    prod = fm.product_geometry(m, c, torch.float32)
    bwd = fm.bwd_geometry(m, c, torch.float32)
    tiles_m = -(-m // 128)
    products = {  # name: (tiles, K, splits, ks)
        "F1": (prod["hidden_tiles"], c, prod["hidden_splits"], prod["hidden_ks"]),
        "F2": (prod["out_tiles"], 4 * c, prod["out_splits"], prod["out_ks"]),
        "B": (bwd["hidden_tiles"], c, bwd["hidden_splits"], bwd["hidden_ks"]),
        "C": (bwd["gy_tiles"], 4 * c, bwd["gy_splits"], bwd["gy_ks"]),
    }
    assert products["F1"][0] == products["B"][0] == (tiles_m, 4 * c // 128)
    assert products["F2"][0] == products["C"][0] == (tiles_m, -(-c // 128))
    for name, ((tm, tn), k, splits, ks) in products.items():
        tiles = tm * tn
        assert ks % 64 == 0, name
        ranges = _ranges(splits, ks, k)
        assert all(lo < hi for lo, hi in ranges), (name, ranges)  # each non-empty
        cover = np.zeros(k, np.int64)
        for lo, hi in ranges:
            cover[lo:hi] += 1
        assert (cover == 1).all(), name  # K exactly once
        units = tiles * splits
        assert units >= min(SMS, tiles * -(-k // 64)), (name, units)
        if tiles >= SMS:
            assert splits == 1, name  # a wave of tiles is not split
    assert prod["plan"] == (prod["hidden_splits"], prod["hidden_ks"], prod["out_splits"],
                            prod["out_ks"])
    assert bwd["plan"] == (bwd["hidden_splits"], bwd["hidden_ks"], bwd["gy_splits"],
                           bwd["gy_ks"])
    assert prod["hidden_ctas"] == min(SMS, tiles_m * 4 * c // 128 * prod["hidden_splits"])
    # The partials fit their workspaces: F1's [splits, m, 4C] and F2's [splits,
    # m, C] in the forward's; B's two planes, C's and stage D's in the backward's.
    split = lambda s, n: s * n if s > 1 else 0  # noqa: E731
    assert prod["ws_elems"] == max(split(prod["hidden_splits"], m * 4 * c),
                                   split(prod["out_splits"], m * c))
    assert bwd["ws_elems"] == max(bwd["splits"] * 4 * c * c,
                                  2 * split(bwd["hidden_splits"], m * 4 * c),
                                  split(bwd["gy_splits"], m * c))


def test_k_splits_rule():
    """The rule itself: a wave of tiles is not split; fewer tiles take
    ranges of floor(ranges of 64 x tiles / 132) of 64 (at least one)."""
    assert fm.k_splits(132, 2048) == (1, 2048)
    assert fm.k_splits(4, 2048) == (32, 64)  # #5's F2 at B2 8^2: 4 tiles, 32 ranges
    assert fm.k_splits(16, 512) == (8, 64)  # its F1: 16 tiles, every range
    assert fm.k_splits(3, 3072) == (48, 64)  # 144 units
    assert fm.k_splits(6, 4096) == (32, 128)  # 64 ranges of 64 in pairs: 192 units
    assert fm.k_splits(1, 96) == (2, 64)  # a ragged last range
