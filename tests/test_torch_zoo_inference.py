"""The port's test-time inference against ``spine_vision_tpu/models/inference.py``.

The same inputs go to both packages' ``classifier_test_inference`` and
``regressor_test_inference``: PNG files (gray and RGB, written by the port's
own encoder) and uint8 arrays (gray, RGB, RGBA) of several sizes. The JAX
functions decode and resize them with PIL; the port with ``data/png.py`` and
``data/pillow_resize.py``, whose bicubic resize (Pillow's default for
``Image.resize`` of RGB images) must give the same bytes. Both models carry
the same seeded weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_zoo_helpers import carry, rel_err

from spine_vision_torch.data.pillow_resize import resize
from spine_vision_torch.data.png import write_png
from spine_vision_torch.models import classifier as tcls
from spine_vision_torch.models import inference as tinf
from spine_vision_tpu.models import Classifier, CoordinateRegressor
from spine_vision_tpu.models import inference as jinf


@pytest.mark.parametrize("size", [(32, 32), (40, 24), (224, 224), (7, 300)])
def test_bicubic_resize_is_pillows_bit_for_bit(size):
    rng = np.random.default_rng(size[0])
    for shape in ((37, 53, 3), (120, 90, 3), (64, 64)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize(size))  # Pillow's default filter
        np.testing.assert_array_equal(resize(img, size), want, err_msg=str(shape))


def _inputs(tmp_path):
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (50, 70), dtype=np.uint8)
    rgb = rng.integers(0, 256, (33, 41, 3), dtype=np.uint8)
    write_png(tmp_path / "gray.png", gray)
    write_png(tmp_path / "rgb.png", rgb)
    rgba = rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)
    return [str(tmp_path / "gray.png"), tmp_path / "rgb.png", gray, rgb, rgba,
            rng.integers(0, 256, (64, 64), dtype=np.uint8)]


def _pair(kind):
    if kind == "classifier":
        port = tcls.Classifier("resnet18", dtype=torch.float32, device="cpu")
        ref = Classifier(backbone_name="resnet18", dtype=jnp.float32)
    else:
        port = tcls.CoordinateRegressor("resnet18", dtype=torch.float32, device="cpu")
        ref = CoordinateRegressor(backbone_name="resnet18", dtype=jnp.float32)
    return port, ref, carry(port, ref, (1, 32, 32, 3), seed=3, train=False)


def test_classifier_test_inference_matches_jax(tmp_path):
    port, ref, variables = _pair("classifier")
    inputs = _inputs(tmp_path)
    got = tinf.classifier_test_inference(port, inputs, image_size=(32, 40))
    want = jinf.classifier_test_inference(ref, variables, inputs, image_size=(32, 40))
    np.testing.assert_array_equal(got["images"], want["images"])
    assert got["images"].shape == (6, 32, 40, 3)
    assert got["logits"].keys() == want["logits"].keys()
    for task, logits in want["logits"].items():
        # f32 ResNet-18 on the same batch: within 1e-5 of the largest logit.
        assert rel_err(got["logits"][task], logits) <= 1e-5, task
        np.testing.assert_array_equal(got["predictions"][task], want["predictions"][task])
        np.testing.assert_allclose(got["probabilities"][task], want["probabilities"][task],
                                   atol=1e-5)
    assert got["num_images"] == 6 and got["device"] == "cpu"
    assert got["inference_time_ms"] > 0


def test_regressor_test_inference_matches_jax(tmp_path):
    port, ref, variables = _pair("regressor")
    inputs = _inputs(tmp_path)
    got = tinf.regressor_test_inference(port, inputs, image_size=(48, 40))
    want = jinf.regressor_test_inference(ref, variables, inputs, image_size=(48, 40))
    np.testing.assert_array_equal(got["images"], want["images"])
    np.testing.assert_allclose(got["coordinates"], want["coordinates"], atol=1e-5)
    np.testing.assert_allclose(got["pixel_coordinates"], want["pixel_coordinates"], atol=1e-3)
    assert got["coordinates"].shape == (6, 5, 2)
    # The forward of the batch it reports.
    batch = jnp.asarray(want["images"], jnp.float32) / 255.0
    from spine_vision_tpu.ops.image import imagenet_normalize

    direct = jax.jit(lambda v, x: ref.apply(v, x, train=False))(variables,
                                                                imagenet_normalize(batch))
    np.testing.assert_allclose(got["coordinates"], np.asarray(direct), atol=1e-5)


def test_unsupported_inputs_raise(tmp_path):
    port = tcls.CoordinateRegressor("resnet18", dtype=torch.float32, device="cpu")
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tinf.regressor_test_inference(port, [tmp_path / "x.jpg"], image_size=(32, 32))
    with pytest.raises(TypeError, match="uint8"):
        tinf.regressor_test_inference(port, [np.zeros((8, 8), np.float32)], image_size=(32, 32))
    with pytest.raises(TypeError, match="Unsupported"):
        tinf.regressor_test_inference(port, [object()], image_size=(32, 32))
