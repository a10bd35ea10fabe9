"""Port's pre- and post-processing ops against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.core import tasks as ttasks
from spine_vision_torch.infer.pipeline import _normalize_slices_masked as t_normalize
from spine_vision_torch.ops import batchnorm as tbn
from spine_vision_torch.ops import crop as tcrop
from spine_vision_torch.ops import geometry as tgeo
from spine_vision_torch.ops import image as timage
from spine_vision_tpu.core import tasks as jtasks
from spine_vision_tpu.infer.pipeline import _normalize_slices_masked as j_normalize
from spine_vision_tpu.ops.batchnorm import batch_norm_inference
from spine_vision_tpu.ops.crop import crop_ivd_regions_impl
from spine_vision_tpu.ops.geometry import mm_to_pixels_jax, rotation_angles_jax
from spine_vision_tpu.ops.image import imagenet_normalize, resize_dynamic


def _padded(rng, m, hp, wp):
    buf = np.zeros((m, hp, wp), np.float32)
    hw = np.zeros((m, 2), np.int32)
    for i in range(m):
        h, w = int(rng.integers(hp // 2, hp)), int(rng.integers(wp // 2, wp))
        buf[i, :h, :w] = rng.normal(100, 30, (h, w))
        hw[i] = (h, w)
    return buf, hw


def test_resize_dynamic_on_padded_buffers():
    buf, hw = _padded(np.random.default_rng(0), 3, 96, 80)
    got = timage.resize_dynamic(torch.from_numpy(buf), torch.from_numpy(hw), 48, 40)
    want = jax.vmap(lambda im, e: resize_dynamic(im, e, 48, 40))(jnp.asarray(buf), jnp.asarray(hw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_masked_normalize_and_imagenet_normalize():
    buf, hw = _padded(np.random.default_rng(1), 3, 40, 50)
    hw[2] = (1, 1)  # a dummy row, as the pipeline pads batches
    got, valid = t_normalize(torch.from_numpy(buf), torch.from_numpy(hw))
    want, jvalid = j_normalize(jnp.asarray(buf), jnp.asarray(hw))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    rgb = np.random.default_rng(2).uniform(size=(2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        timage.imagenet_normalize(torch.from_numpy(rgb)).numpy(),
        np.asarray(imagenet_normalize(jnp.asarray(rgb))), rtol=1e-6, atol=1e-6,
    )


def test_mm_to_pixels_and_rotation_angles():
    spacing = np.array([[0.6875, 0.6875], [0.3, 0.5], [1.0, 1.0], [0.25, 0.2]], np.float32)
    delta = np.array([55.0, 15.0, 17.5, 20.0], np.float32)
    got = tgeo.mm_to_pixels(torch.from_numpy(delta), torch.from_numpy(spacing))
    want = jax.vmap(lambda sp: mm_to_pixels_jax(jnp.asarray(delta), sp))(jnp.asarray(spacing))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    rng = np.random.default_rng(3)
    x = rng.uniform(0.3, 0.7, (6, 5))
    y = np.sort(rng.uniform(0.1, 0.9, (6, 5)), axis=1)
    centers = np.stack([x, y], -1).astype(np.float32)
    centers[0, 1, 1] = centers[0, 0, 1]  # a zero dy takes the safe division
    hw = rng.integers(200, 500, (6, 2)).astype(np.int32)
    got = tgeo.rotation_angles(torch.from_numpy(centers), torch.from_numpy(hw), 1.3)
    want = jax.vmap(lambda c, e: rotation_angles_jax(c, e, 1.3))(
        jnp.asarray(centers), jnp.asarray(hw)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("separable", [True, False])
def test_crop_ivd_regions_matches_jax(separable):
    rng = np.random.default_rng(4 + separable)
    buf, hw = _padded(rng, 3, 160, 144)
    centers = np.stack(
        [rng.uniform(0.3, 0.7, (3, 5)), np.sort(rng.uniform(0.15, 0.85, (3, 5)), axis=1)], -1
    ).astype(np.float32)
    angles = np.zeros((3, 5), np.float32) if separable else rng.uniform(-35, 35, (3, 5))
    angles = angles.astype(np.float32)
    deltas = np.array([[40, 12, 14, 16], [30, 10, 12, 12], [60, 20, 20, 25]], np.float32)
    got = tcrop.crop_ivd_regions(
        torch.from_numpy(buf), torch.from_numpy(centers), torch.from_numpy(angles),
        torch.from_numpy(deltas), torch.from_numpy(hw), crop_h=32, crop_w=24,
        separable=separable,
    ).numpy()
    want = np.asarray(
        jax.vmap(
            lambda im, c, a, d, e: crop_ivd_regions_impl(
                im, c, a, d, crop_h=32, crop_w=24, image_hw=e, separable=separable
            )
        )(*(jnp.asarray(a) for a in (buf, centers, angles, deltas, hw)))
    )
    assert got.dtype == np.uint8 and got.shape == want.shape == (3, 5, 32, 24)
    diff = np.abs(got.astype(int) - want.astype(int))
    # uint8 truncation after f32 products in another order: a value at an
    # integer boundary may land one level apart; stated: <= 1 level, on at
    # most 1% of pixels.
    assert diff.max() <= 1
    assert np.mean(diff > 0) <= 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_inference(dtype):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 5, 16)).astype(np.float32)
    scale, bias, mean = (rng.normal(size=16).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    got = tbn.batch_norm_inference(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        *(torch.from_numpy(a) for a in (scale, bias, mean, var)),
    )
    want = batch_norm_inference(
        jnp.asarray(x, getattr(jnp, dtype)), *(jnp.asarray(a) for a in (scale, bias, mean, var))
    )
    assert got.dtype == getattr(torch, dtype)
    # bf16: same f32 math and a single rounding; allow one bf16 step.
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def test_task_registry_and_decode_match_jax():
    assert [t.name for t in ttasks.get_tasks()] == [t.name for t in jtasks.get_tasks()]
    for t, j in zip(ttasks.get_tasks(), jtasks.get_tasks()):
        assert (t.num_classes, t.task_type, t.class_names) == (j.num_classes, j.task_type, j.class_names)
    rng = np.random.default_rng(7)
    logits = {t.name: rng.normal(size=(5, t.num_classes)).astype(np.float32)
              for t in ttasks.get_tasks()}
    for fn in ("compute_predictions_for_tasks", "compute_probabilities_for_tasks"):
        got = getattr(ttasks, fn)(logits, ttasks.get_tasks())
        want = getattr(jtasks, fn)(logits, jtasks.get_tasks())
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{fn} {k}")
    for task_type in ("multilabel", "ordinal", "regression"):
        x = rng.normal(size=(4, 3)).astype(np.float32)
        for fn in ("compute_predictions", "compute_probabilities"):
            np.testing.assert_array_equal(
                getattr(ttasks.get_strategy(task_type), fn)(x),
                getattr(jtasks.get_strategy(task_type), fn)(x),
            )
