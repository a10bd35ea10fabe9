"""The port's ViT/DeiT and Swin against the JAX package's.

Small custom configurations: ``ViTConfig(8, 64, 2, 2)`` on a 14x14
position grid (the 224² grid of patch 16), run at 64² (the grid shrinks 14
-> 8, where ``jax.image.resize`` antialiases) and at 128² (it grows 14 ->
16, a plain bilinear resize); a two-stage ``SwinConfig(32, (2, 2), (2, 4),
window_size=4)`` at 20², whose first stage's 5x5 grid pads to 8x8 with the
shift on, whose merge pads 5 to 6, and whose last stage's 3x3 grid pads to
the window, which turns the shift off. Forward at f32 and bf16, then one
classification train step each. Neither family has BatchNorm or dropout in
its backbone, so training mode computes what eval mode does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_zoo_helpers import carry, check_step, forward_pair, images, rel_err, train_step_pair

from spine_vision_torch.models import swin as ts
from spine_vision_torch.models import vit as tv
from spine_vision_tpu.models import swin as js
from spine_vision_tpu.models import vit as jv

VIT = (8, 64, 2, 2)
SWIN = {"embed_dim": 32, "depths": (2, 2), "num_heads": (2, 4), "window_size": 4}


@pytest.mark.parametrize("out_size", [8, 16, 32, 5])
def test_position_grid_resize_is_jax_image_resize(out_size):
    """14 -> 8 and 14 -> 5 shrink (a triangle widened by the scale), 14 -> 16
    and 14 -> 32 grow (plain bilinear): the resize weights against
    ``jax.image.resize(..., "bilinear")`` on a random grid of unit scale,
    within 1e-5 (f32 sums in another order; measured 4.6e-6 at most). The
    weights without antialiasing miss by more than 1 when the grid
    shrinks."""
    grid = np.random.default_rng(out_size).normal(size=(1, 14, 14, 6)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(grid), (1, out_size, out_size, 6), "bilinear")
    got = tv.resize_grid(torch.from_numpy(grid), (out_size, out_size))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if out_size > 14:
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(grid).permute(0, 3, 1, 2), size=(out_size, out_size),
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)


def _vit(dtype):
    return (tv.ViT(tv.ViTConfig(*VIT), dtype=getattr(torch, dtype)),
            jv.ViT(config=jv.ViTConfig(*VIT), dtype=getattr(jnp, dtype)))


def _swin(dtype):
    return (ts.SwinTransformer(ts.SwinConfig(**SWIN), dtype=getattr(torch, dtype)),
            js.SwinTransformer(config=js.SwinConfig(**SWIN), dtype=getattr(jnp, dtype)))


# f32 within 1e-4 of the features' largest magnitude (measured 5.1e-7 to
# 6.9e-7 for ViT, 2.7e-7 for Swin). bf16: the stream, the projections and
# the softmax round to bf16 in both, in sums of another order: within 2e-2,
# test_torch_models.py's ConvNeXt bf16 bound (measured 7.6e-3 to 1.06e-2
# for ViT, 5.4e-3 for Swin).
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("model,hw", [("vit", 64), ("vit", 128), ("swin", 20)])
def test_transformer_forward_matches_jax(model, hw, dtype, bound):
    port, ref = (_vit if model == "vit" else _swin)(dtype)
    variables = carry(port, ref, (1, hw, hw, 3), seed=hw, train=False)
    got, want, _ = forward_pair(port, ref, images(hw + 1, (2, hw, hw, 3)), variables)
    assert got.dtype == torch.float32 and got.shape == (2, 64)
    assert rel_err(got.numpy(), want) <= bound


def test_swin_quirks_are_kept():
    """The padded tokens take part in the attention, the shift stops where
    the padded grid fits one window, and the merge pads odd sides."""
    block = ts.SwinBlock(8, 2, 4, shift=2)
    x = torch.randn(1, 5, 5, 8)
    calls = []
    block.attn.register_forward_hook(lambda m, args, out: calls.append(args))
    block(x)
    windows, mask = calls[-1]
    assert windows.shape == (4, 16, 8) and mask.shape == (4, 16, 16)
    assert (windows.abs().sum(-1) == 0).any()  # zero-padded tokens inside the windows
    block(torch.randn(1, 3, 3, 8))
    assert calls[-1][0].shape == (1, 16, 8) and calls[-1][1] is None
    assert ts.PatchMerging(8)(torch.randn(1, 5, 7, 8)).shape == (1, 3, 4, 16)


@pytest.mark.parametrize("model", ["vit", "swin"])
def test_transformer_train_step_matches_jax(monkeypatch, model):
    if model == "vit":
        make_port = lambda: tv.ViT(tv.ViTConfig(*VIT))  # noqa: E731
        make_ref = lambda: jv.ViT(config=jv.ViTConfig(*VIT), dtype=jnp.float32)  # noqa: E731
        hw = 64
    else:
        make_port = lambda: ts.SwinTransformer(ts.SwinConfig(**SWIN))  # noqa: E731
        make_ref = lambda: js.SwinTransformer(  # noqa: E731
            config=js.SwinConfig(**SWIN), dtype=jnp.float32)
        hw = 20
    tloss, jloss, port, state, jstate = train_step_pair(monkeypatch, make_port, make_ref, 64,
                                                        seed=11, hw=hw)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    check_step(port, state, jstate)
