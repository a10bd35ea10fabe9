"""The OCR renderer's raster operations (``spine_vision_torch/data/phenikaa/raster.py``)
against Pillow, which the JAX package's ``synth.py`` calls: each one bit for
bit, on seeded numpy images (noise over a flat band, so that both edges and
texture are sampled) at odd sizes and at the renderer's own (a 32x256 line,
its 32x512 canvas, a 320x448 page).
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFilter

from spine_vision_torch.data.phenikaa import raster

SHAPES = [(37, 101), (32, 256), (32, 512), (320, 448)]


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    a[:, : shape[1] // 3] = 255  # a flat band, as a text line's background
    return a


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("slant", [-0.25, 0.07, 0.25])
def test_affine_transform_matches_pillow(shape, slant):
    h, w = shape
    a = _image(shape, 1)
    coeffs = (1.0, slant, -slant * h / 2.0, 0.0, 1.0, 0.0)
    want = Image.fromarray(a).transform((w, h), Image.AFFINE, coeffs, Image.BILINEAR,
                                        fillcolor=255)
    np.testing.assert_array_equal(raster.transform(a, (w, h), coeffs, 255), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_perspective_transform_matches_pillow(shape):
    h, w = shape
    a = _image(shape, 2)
    rng = np.random.default_rng(3)
    for _ in range(4):  # synth's rotation, shear and projective ranges ("hard")
        rot = np.deg2rad(rng.uniform(-3.0, 3.0))
        shear, persp = rng.uniform(-0.08, 0.08), rng.uniform(-0.015, 0.015)
        cx, cy = w / 2.0, h / 2.0
        ca, sa = np.cos(rot), np.sin(rot)
        b = sa + shear
        coeffs = (ca, b, cx - ca * cx - b * cy, -sa, ca, cy + sa * cx - ca * cy,
                  persp / w, persp / h)
        want = Image.fromarray(a).transform((w, h), Image.PERSPECTIVE, coeffs,
                                            Image.BILINEAR, fillcolor=245)
        got = raster.transform(a, (w, h), coeffs, 245, perspective=True)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_resize_matches_pillow(shape):
    h, w = shape
    a = _image(shape, 4)
    # Shrinking (the support widens), stretching, both axes, and the line
    # renderer's squeeze of a cropped canvas to 256 wide.
    for size in [(256, h), (w // 3 + 1, h), (2 * w + 3, h), (w, h // 2 + 1), (w * 2, h * 3),
                 (101, 37)]:
        want = np.asarray(Image.fromarray(a).resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(raster.resize_bilinear(a, size), want, err_msg=str(size))


@pytest.mark.parametrize("shape", SHAPES)
def test_rank_filters_match_pillow(shape):
    a = _image(shape, 5)
    np.testing.assert_array_equal(raster.min_filter3(a),
                                  np.asarray(Image.fromarray(a).filter(ImageFilter.MinFilter(3))))
    np.testing.assert_array_equal(raster.max_filter3(a),
                                  np.asarray(Image.fromarray(a).filter(ImageFilter.MaxFilter(3))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [0.6, 1.7, 3.0])
def test_gaussian_blur_matches_pillow(shape, radius):
    a = _image(shape, 6)
    want = Image.fromarray(a).filter(ImageFilter.GaussianBlur(radius=radius))
    np.testing.assert_array_equal(raster.gaussian_blur(a, radius), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("quality", [30, 40, 60, 90])
def test_jpeg_roundtrip_matches_pillow(shape, quality):
    a = _image(shape, 7)
    buf = io.BytesIO()
    Image.fromarray(a, "L").save(buf, format="JPEG", quality=quality)
    buf.seek(0)
    np.testing.assert_array_equal(raster.jpeg_roundtrip(a, quality), np.asarray(Image.open(buf)))


@pytest.mark.parametrize("quality", [30, 40, 60, 90])
def test_jpeg_quant_table_matches_the_file(quality):
    """The luminance table Pillow writes (the DQT segment, zigzag order)."""
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8), np.uint8), "L").save(buf, format="JPEG", quality=quality)
    data = buf.getvalue()
    at = data.index(b"\xff\xdb") + 5  # marker, length, precision/table id
    zigzag = np.frombuffer(data[at : at + 64], np.uint8).astype(np.int64)
    order = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8,
                                                      (i % 8 if (i // 8 + i % 8) % 2 == 0
                                                       else i // 8))))
    natural = np.zeros(64, np.int64)
    natural[order] = zigzag
    np.testing.assert_array_equal(raster.jpeg_quant_table(quality).ravel(), natural)
