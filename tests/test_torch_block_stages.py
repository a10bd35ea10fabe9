"""The block forward's plain stages (ops/convnext_block.py: P
``prologue_reference``, F1 ``hidden_reference``, F2 ``out_reference``), the
launches of csrc/convnext_block.cu, on the CPU: their composition is the
plain block bit for bit in both forms, each form's LayerNorm reads the t it
should, and the kernels' launch geometry covers every token once for every
built width."""

import numpy as np
import pytest
import torch

from spine_vision_torch.ops import convnext_block as cb
from spine_vision_torch.ops.dwconv import depthwise_conv7x7_reference, layer_norm_f32


def _args(seed, b, h, w, c, dtype):
    rng = np.random.default_rng(seed)

    def t(shape, scale, shift=0.0, dt=torch.float32):
        a = rng.normal(size=shape) * scale + shift
        return torch.from_numpy(a.astype(np.float32)).to(dt)

    return (t((b, h, w, c), 1.0, dt=dtype), t((49, c), 0.1, dt=dtype), t((c,), 0.1),
            t((c,), 0.1, 1.0), t((c,), 0.1), t((4 * c, c), c ** -0.5, dt=dtype),
            t((4 * c,), 0.1), t((c, 4 * c), (4 * c) ** -0.5, dt=dtype), t((c,), 0.1),
            t((c,), 0.1, 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emit_conv", [False, True])
def test_stages_compose_to_the_reference_bit_for_bit(dtype, emit_conv):
    args = _args(1, 2, 9, 11, 32, dtype)
    x, k49, dw_bias, ls, lb, w1t, b1, w2t, b2, gamma = args
    y, t = cb.prologue_reference(x, k49, dw_bias, ls, lb, emit_conv=emit_conv)
    h = cb.hidden_reference(y, w1t, b1)
    out = cb.out_reference(h, w2t, b2, gamma, x)
    want = cb.block_reference(*args, emit_conv=emit_conv)
    if emit_conv:
        want, want_t = want
        assert t.dtype == dtype and torch.equal(t, want_t)
    else:
        assert t is None
    assert y.dtype == h.dtype == out.dtype == dtype
    assert out.shape == x.shape and h.shape == (*x.shape[:3], 4 * 32)
    assert torch.equal(out, want)
    # The kernels hand F1 and F2 flat [M, C] and [M, 4C] rows: the same
    # function, the products' sums in another order at most.
    flat = cb.out_reference(cb.hidden_reference(y.reshape(-1, 32), w1t, b1), w2t, b2, gamma, x)
    assert flat.shape == x.shape
    torch.testing.assert_close(flat.float(), want.float(), rtol=0,
                               atol=1e-2 * want.float().abs().max().item())


def test_each_form_layer_norms_its_own_t():
    """emit_conv: t is rounded to bf16 and the LayerNorm reads the rounded t;
    the inference form's LayerNorm reads the f32 t, and the two y differ."""
    x, k49, dw_bias, ls, lb = _args(2, 2, 8, 8, 64, torch.bfloat16)[:5]
    t32 = depthwise_conv7x7_reference(x, k49) + dw_bias
    y_inf, none = cb.prologue_reference(x, k49, dw_bias, ls, lb)
    y_emit, t = cb.prologue_reference(x, k49, dw_bias, ls, lb, emit_conv=True)
    assert none is None
    assert torch.equal(t, t32.to(torch.bfloat16))
    assert torch.equal(y_emit, layer_norm_f32(t.float(), ls, lb, 1e-6).to(torch.bfloat16))
    assert torch.equal(y_inf, layer_norm_f32(t32, ls, lb, 1e-6).to(torch.bfloat16))
    assert not torch.equal(y_inf, y_emit)


# Each width's shape on the train step's path (batch 32 at 512^2: the stage
# of that width runs at 128^2, 64^2 or 32^2) and a ragged one (507 tokens).
MAIN = {96: (32, 128, 128), 128: (32, 128, 128), 192: (32, 64, 64), 256: (32, 64, 64),
        384: (32, 32, 32), 512: (32, 32, 32)}
SMEM_A_SM = 233472  # bytes of shared memory an H100 multiprocessor holds
SMEM_RESERVED = 1024  # of it, reserved a CTA


def _prologue_cover(b, h, w, geo):
    """How many of P's CTAs store each token, decomposing blockIdx as
    block_prologue does."""
    rows, cols = geo["tile"]
    tiles_h, tiles_w = geo["tiles"]
    cover = np.zeros((b, h, w), np.int64)
    ids = np.arange(geo["ctas"])
    tw, th, bb = ids % tiles_w, (ids // tiles_w) % tiles_h, ids // (tiles_w * tiles_h)
    for r in range(rows):
        for q in range(cols):
            hh, ww = th * rows + r, tw * cols + q
            keep = (hh < h) & (ww < w)
            np.add.at(cover, (bb[keep], hh[keep], ww[keep]), 1)
    return cover


@pytest.mark.parametrize("c", cb.KERNEL_WIDTHS)
@pytest.mark.parametrize("ragged", [False, True])
def test_launch_geometry(c, ragged):
    b, h, w = (3, 13, 13) if ragged else MAIN[c]
    m = b * h * w
    geo = cb.forward_geometry(b, h, w, c)
    rows, cols = geo["tile"]
    assert (rows, cols) == ((8 if c <= 192 else 4), 8)
    assert geo["tiles"] == (-(-h // rows), -(-w // cols)) and geo["ctas"] == b * (
        geo["tiles"][0] * geo["tiles"][1])
    assert (_prologue_cover(b, h, w, geo) == 1).all()  # every token stored once
    assert geo["chunks"] * 64 >= c > (geo["chunks"] - 1) * 64
    assert 2 * (geo["prologue_smem"] + SMEM_RESERVED) <= SMEM_A_SM  # two CTAs an SM
    # F1: 128-row tiles by nb x 128 columns over [M, 4C], columns exactly.
    h4 = 4 * c
    tm, tn = geo["hidden_tiles"]
    assert (tm - 1) * 128 < m <= tm * 128
    assert tn * geo["hidden_nb"] * 128 == h4
    assert geo["hidden_nb"] == (1 if c == 96 else 2)
    # F2: over [M, C]; C = 96 and 192 end inside a tile, whose epilogue masks them.
    tm2, tn2 = geo["out_tiles"]
    span = geo["out_nb"] * 128
    assert tm2 == tm and (tn2 - 1) * span < c <= tn2 * span
    assert geo["out_nb"] == (2 if c in (256, 512) else 1)
    if ragged:  # each output element in one unit's tile, enumerated
        for tiles, nb, width in ((geo["hidden_tiles"], geo["hidden_nb"], h4),
                                 (geo["out_tiles"], geo["out_nb"], c)):
            cover = np.zeros((m, width), np.int64)
            for u in range(tiles[0] * tiles[1]):
                t_m, t_n = u // tiles[1], u % tiles[1]
                cover[t_m * 128: (t_m + 1) * 128, t_n * nb * 128: (t_n + 1) * nb * 128] += 1
            assert (cover == 1).all()


def test_shapes_without_a_kernel_raise_before_any_launch():
    """On the CPU a launch would fail to find nvcc; these raise ValueError
    first, from the checks."""
    with pytest.raises(ValueError):
        cb.forward_geometry(1, 4, 4, 640)
    with pytest.raises(ValueError):
        cb.forward_geometry(0, 4, 4, 128)
    with pytest.raises(ValueError):
        cb.forward_geometry(2 ** 16, 2 ** 8, 2 ** 7, 128)
    with pytest.raises(ValueError):
        cb.fwd_launch(*_args(3, 1, 4, 4, 640, torch.bfloat16))
