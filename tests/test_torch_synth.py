"""The port's OCR renderer (``spine_vision_torch/data/phenikaa/synth.py`` over
the committed glyph atlas, ``text.py``) against the JAX package's
``synth.py`` (Pillow and the DejaVu fonts), on Generators from the same
seeds.

- The samplers and ``encode_text`` are bit for bit.
- A batch of degraded lines, a degraded image with boxes, a page and the
  report pages draw from the Generator in the JAX order and leave it in the
  JAX state; their texts, targets and boxes are bit for bit, and so is every
  image the seeds here give. The atlas reproduces Pillow's glyphs, kerning
  and compositing exactly; its one gap is ``textbbox``'s right edge, a
  pixel off in a few strings per thousand (a glyph's outline box is
  inferred from its ink and Pillow's boxes), which can move a page's x draw
  and truncation. So the strict checks run on these seeds, and a check over
  many strings bounds the gap.
- The committed atlas equals what ``tests/fixtures/torch_glyphs/generate.py``
  makes on a subset, and covers every character synth draws.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont

from spine_vision_torch.data.phenikaa import synth as ps
from spine_vision_torch.data.phenikaa import text as pt
from spine_vision_tpu.data.phenikaa import synth as js

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests" / "fixtures" / "torch_glyphs"))
import generate as glyph_gen  # noqa: E402


def _pair(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def test_faces_are_the_jax_packages_in_its_order():
    assert ps.FONT_PATHS == tuple(Path(p).stem for p in js.FONT_PATHS)
    assert ps.HOLDOUT_FONT_PATHS == tuple(Path(p).stem for p in js.HOLDOUT_FONT_PATHS)
    assert pt.atlas_faces() == (ps.FONT_PATHS, ps.HOLDOUT_FONT_PATHS)


def test_constants_are_the_jax_packages():
    for name in ("SURNAMES", "MIDDLE_NAMES", "GIVEN_NAMES", "FIELD_LABELS", "DEGRADE_PROFILES"):
        assert getattr(ps, name) == getattr(js, name), name
    np.testing.assert_array_equal(ps._CHARS, js._CHARS)


@pytest.mark.parametrize("seed", range(4))
def test_samplers_and_encoding_match_jax(seed):
    a, b = _pair(seed)
    for _ in range(200):
        assert ps.sample_name(a) == js.sample_name(b)
        assert ps.sample_date(a) == js.sample_date(b)
        ta, tb = ps.sample_line_text(a), js.sample_line_text(b)
        assert ta == tb
        assert ps.sample_line_text(a, max_chars=28) == js.sample_line_text(b, max_chars=28)
        for got, want in zip(ps.encode_text(ta, 40), js.encode_text(tb, 40)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    assert a.bit_generator.state == b.bit_generator.state
    ids, pad = ps.encode_text("Ngày sinh: 01/02/1990" + "€" * 3, 8)  # clipped; unknown dropped
    np.testing.assert_array_equal(ids, js.encode_text("Ngày sinh: 01/02/1990€€€", 8)[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_recognition_batch_matches_jax(seed):
    a, b = _pair(seed)
    got = ps.recognition_batch(a, 24, degrade="mild", degrade_p=0.7)
    want = js.recognition_batch(b, 24, degrade="mild", degrade_p=0.7)
    assert got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert a.bit_generator.state == b.bit_generator.state
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])


def test_hard_and_holdout_lines_match_jax():
    a, b = _pair(5)
    got = ps.recognition_batch(a, 16, degrade="hard", fonts=ps.HOLDOUT_FONT_PATHS)
    want = js.recognition_batch(b, 16, degrade="hard", fonts=js.HOLDOUT_FONT_PATHS)
    assert got[3] == want[3] and a.bit_generator.state == b.bit_generator.state
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("face", range(6))
def test_unaugmented_line_matches_pillow(face):
    """``render_line(augment=False)``: one face at 22 px, squeezed to 256.
    Bit for bit on these texts; the bound is the atlas's textbbox gap (a
    pixel of crop width moves the resize's taps by 1/300)."""
    rng = np.random.default_rng(face)
    diffs = []
    for _ in range(24):
        t = js.sample_line_text(rng)
        got = ps.render_line(t, np.random.default_rng(0), augment=False,
                             fonts=(ps.FONT_PATHS[face],))
        want = js.render_line(t, np.random.default_rng(0), augment=False,
                              fonts=(js.FONT_PATHS[face],))
        diffs.append(np.abs(got - want).mean())
    assert max(diffs) == 0.0


@pytest.mark.parametrize("profile", ["mild", "hard"])
def test_degrade_image_with_boxes_matches_jax(profile):
    for seed in range(6):
        a, b = _pair(seed)
        page = np.random.default_rng(seed).uniform(200, 255, (320, 448)).astype(np.float32)
        boxes = np.array([[20, 30, 200, 60], [50, 120, 400, 150]], np.float32)
        got = ps.degrade_image(page.copy(), a, profile=profile, boxes=boxes)
        want = js.degrade_image(page.copy(), b, profile=profile, boxes=boxes)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_page_matches_jax(seed):
    a, b = _pair(seed)
    for _ in range(6):
        got = ps.detection_page(a, degrade="mild", degrade_p=0.7)
        want = js.detection_page(b, degrade="mild", degrade_p=0.7)
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        target = ps.detection_target(got[1], (320, 448))
        np.testing.assert_array_equal(target, js.detection_target(want[1], (320, 448)))
    assert a.bit_generator.state == b.bit_generator.state


def test_small_and_unaugmented_pages_match_jax():
    """Pages of 64x128 (rows shorter than the text: crops past the edge)
    and evaluation pages in the holdout faces."""
    a, b = _pair(7)
    for hw, augment, fonts in [((64, 128), True, None), ((320, 448), False, "holdout")]:
        for _ in range(4):
            got = ps.detection_page(a, hw, augment=augment,
                                    fonts=ps.HOLDOUT_FONT_PATHS if fonts else None)
            want = js.detection_page(b, hw, augment=augment,
                                     fonts=js.HOLDOUT_FONT_PATHS if fonts else None)
            assert got[2] == want[2]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
    assert a.bit_generator.state == b.bit_generator.state


def test_report_pages_match_jax():
    args = ("Nguyễn Văn An", "15/05/1980", "250012345")
    np.testing.assert_array_equal(ps.render_report_page(*args, np.random.default_rng(0)),
                                  js.render_report_page(*args, np.random.default_rng(0)))
    for seed in range(3):
        a, b = _pair(seed)
        got = ps.render_report_page_variant(*args, a)
        want = js.render_report_page_variant(*args, b)
        np.testing.assert_array_equal(got, want)
        assert a.bit_generator.state == b.bit_generator.state


def test_matplotlib_lines_match_jax():
    a, b = _pair(3)
    got, gt = ps.recognition_eval_batch_mpl(a, 4)
    want, wt = js.recognition_eval_batch_mpl(b, 4)
    assert gt == wt
    np.testing.assert_array_equal(got, want)


def test_textbbox_gap_is_bounded():
    """Over 2400 strings in all twelve faces at six sizes: the atlas draws
    every one as Pillow does, and its textbbox is Pillow's on every one."""
    rng = np.random.default_rng(11)
    faces = list(zip(js.FONT_PATHS + js.HOLDOUT_FONT_PATHS,
                     ps.FONT_PATHS + ps.HOLDOUT_FONT_PATHS))
    total = off = 0
    for path, face in faces:
        for size in (13, 15, 18, 20, 22, 26):
            pil, atlas = ImageFont.truetype(path, size), pt.truetype(face, size)
            for _ in range(32):
                t = js.sample_line_text(rng)
                total += 1
                want, got = pil.getbbox(t), atlas.getbbox(t)
                if want != got:
                    off += 1
                    assert want[:2] == got[:2] and want[3] == got[3]
                    assert abs(want[2] - got[2]) <= 1
                img = Image.new("L", (700, 40), 250)
                ImageDraw.Draw(img).text((4, 3), t, fill=9, font=pil)
                mine = np.full((40, 700), 250, np.uint8)
                atlas.draw(mine, (4, 3), t, 9)
                np.testing.assert_array_equal(mine, np.asarray(img))
    assert off == 0, (off, total)


def test_atlas_equals_the_generator_on_a_subset():
    trained, holdout = glyph_gen.font_paths()
    chars = glyph_gen.all_chars()
    picks = [0, 3, len(chars) - 1] + [chars.index(c) for c in "ẫAVfj "]
    sub = "".join(chars[i] for i in sorted(set(picks)))
    paths = (trained[3], holdout[5])  # a Mono face (decomposed marks), an italic
    sizes = (14, 22)
    want = glyph_gen.build(paths, sizes, sub)
    atlas = pt._atlas()
    faces = [str(f) for f in atlas["faces"]]
    for p, face in zip(paths, (ps.FONT_PATHS[3], ps.HOLDOUT_FONT_PATHS[5])):
        fi = faces.index(face)
        wi = list(want["faces"]).index(face)
        for si, size in enumerate(sizes):
            font = pt.truetype(face, size)
            for ci, ch in enumerate(sub):
                c = font._index[ch]
                sj = list(atlas["sizes"]).index(size)
                assert atlas["advance"][fi, sj, c] == want["advance"][wi, si, ci]
                np.testing.assert_array_equal(atlas["bbox_y"][fi, sj, c], want["bbox_y"][wi, si, ci])
                np.testing.assert_array_equal(atlas["cbox_x"][fi, sj, c], want["cbox_x"][wi, si, ci])
                assert atlas["phased"][fi, c] == want["phased"][wi, ci]
                for phase in range(64 if want["phased"][wi, ci] else 1):
                    v_got = atlas["first_variant"][fi, sj, c] + phase
                    v_want = want["first_variant"][wi, si, ci] + phase
                    assert atlas["variant_left"][v_got] == want["variant_left"][v_want]
                    assert atlas["variant_top"][v_got] == want["variant_top"][v_want]

                    def bitmap(arrs, v):
                        b = arrs["variant_bitmap"][v]
                        h, w = arrs["bitmap_shape"][b]
                        o = arrs["bitmap_offset"][b]
                        return arrs["bitmap_data"][o : o + h * w].reshape(h, w)

                    np.testing.assert_array_equal(bitmap(atlas, v_got), bitmap(want, v_want))
            kern = {(sub[a], sub[b]): v for (a, b), v, fs in
                    zip(want["kern_pair"], want["kern_value"], want["kern_fs"])
                    if fs == wi * len(sizes) + si}
            for (a, b), v in kern.items():
                assert font._kern.get((font._index[a], font._index[b]), 0) == v
    assert str(atlas["pillow_version"]) and len(atlas["font_sha256"]) == 12


def test_atlas_covers_every_character_synth_draws():
    atlas_chars = {chr(c) for c in pt._atlas()["chars"]}
    assert set(glyph_gen.all_chars()) <= atlas_chars
    pools = ps.SURNAMES + ps.MIDDLE_NAMES + ps.GIVEN_NAMES + ps.FIELD_LABELS
    assert set("".join(pools)) | set(js.VIETNAMESE_CHARSET) <= atlas_chars
    with pytest.raises(KeyError, match="not in the glyph atlas"):
        pt.truetype(ps.FONT_PATHS[0], 20).getbbox("€")
