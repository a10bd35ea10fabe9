"""The port's in-memory datasets against the JAX package's datasets on disk.

The parity suite's builders render the same seeded slices in both packages:
the JAX package writes PNGs (PIL) and reads them back (cv2), the port keeps
the arrays in an image store beside the same ``annotations.csv``. Both
datasets must then give the same splits and samples: the localization
images, coordinates and masks bit for bit; for classification (crops made by
both packages' ``SeriesCropPipeline`` at the fallback centres, in both crop
modes) the same rows, splits and targets, the crops within one gray level on
at most 1% of the pixels (the crop kernels' bound, ``test_torch_pipeline.py``).
"""

from pathlib import Path

import numpy as np
import pytest

from spine_vision_torch.data import datasets as tds
from spine_vision_torch.infer import pipeline as tpipe
from spine_vision_torch.utils import parity as tparity
from spine_vision_tpu.data.datasets import ClassificationDataset as JClassification
from spine_vision_tpu.data.datasets import LocalizationDataset as JLocalization
from spine_vision_tpu.infer.pipeline import SeriesCropPipeline as JSeriesCrop
from spine_vision_tpu.infer.pipeline import StudyPipelineConfig as JConfig
from spine_vision_tpu.utils import parity as jparity

SEED = 3
N_LOC = 40
N_PATIENTS = 16
MODES = ("horizontal", "rotated")
CROP_CFG = {"loc_image_size": tparity.LOC_SIZE, "crop_size": tparity.CROP_SIZE,
            "crop_delta_mm": tparity.CROP_DELTA_MM, "padded_hw": tparity.SLICE_HW}


def _assert_crops_close(got: np.ndarray, want: np.ndarray) -> None:
    """<= 1 uint8 level on at most 1% of the pixels."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01, (diff.max(), np.mean(diff > 0))


@pytest.fixture(scope="module")
def loc_sets(tmp_path_factory):
    jroot, troot = tmp_path_factory.mktemp("jloc"), tmp_path_factory.mktemp("tloc")
    jrng, trng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    jparity._write_loc_dataset(jroot, jrng, N_LOC)
    store = tparity._build_loc_dataset(troot, trng, N_LOC)
    assert jrng.bit_generator.state == trng.bit_generator.state
    return jroot, troot, store


@pytest.fixture(scope="module")
def cls_sets(tmp_path_factory):
    jroot, troot = tmp_path_factory.mktemp("jcls"), tmp_path_factory.mktemp("tcls")
    jrng, trng = np.random.default_rng(SEED), np.random.default_rng(SEED)
    jpipes = {m: JSeriesCrop(None, None, config=JConfig(crop_mode=m, **CROP_CFG)) for m in MODES}
    tpipes = {m: tpipe.SeriesCropPipeline(None, tpipe.StudyPipelineConfig(crop_mode=m, **CROP_CFG),
                                          device="cpu") for m in MODES}
    jparity._write_cls_dataset(jroot, jrng, N_PATIENTS, jpipes)
    store = tparity._build_cls_dataset(troot, trng, N_PATIENTS, tpipes)
    assert jrng.bit_generator.state == trng.bit_generator.state
    return jroot, troot, store


def test_builders_write_the_same_annotations(loc_sets, cls_sets):
    for jroot, troot, store in (loc_sets, cls_sets):
        text = (troot / "annotations.csv").read_text()
        assert text == (jroot / "annotations.csv").read_text()
        assert sorted(store) == sorted(str(p.relative_to(jroot))
                                       for p in (jroot / "images").iterdir())


@pytest.mark.parametrize("split", ["train", "val", "test", "all"])
def test_localization_dataset_matches_jax(loc_sets, split):
    jroot, troot, store = loc_sets
    kw = {"split": split, "val_ratio": 0.2, "test_ratio": 0.1, "image_size": tparity.LOC_SIZE,
          "augment": True, "seed": SEED}
    want = JLocalization(jroot, **kw)
    got = tds.LocalizationDataset(troot, image_store=store, **kw)
    assert got.image_list == want.image_list and len(got) == len(want) > 0
    assert got.augment == want.augment == (split == "train")
    assert got.get_stats() == want.get_stats()
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g["image"].dtype == np.uint8 and g["image"].shape == (*tparity.LOC_SIZE, 3)
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["coords"], w["coords"])
        np.testing.assert_array_equal(g["mask"], w["mask"])
        assert g["series_type_idx"] == w["series_type_idx"] and g["metadata"] == w["metadata"]


def _row(record: dict, root: Path | None) -> dict:
    """A record with its image paths relative to the dataset root."""
    out = dict(record)
    for key in ("t1_path", "t2_path"):
        out[key] = str(Path(record[key]).relative_to(root)) if root else record[key]
    return out


@pytest.mark.parametrize("split", ["train", "val", "test", "all"])
@pytest.mark.parametrize("labels", [["pfirrmann", "herniation"], ["pfirrmann"]])
def test_classification_dataset_matches_jax(cls_sets, split, labels):
    jroot, troot, store = cls_sets
    kw = {"split": split, "val_ratio": 0.15, "target_labels": labels,
          "output_size": tparity.CROP_SIZE, "augment": False, "seed": SEED}
    want = JClassification(jroot, **kw)
    got = tds.ClassificationDataset(troot, image_store=store, **kw)
    assert len(got) == len(want) > 0
    assert [_row(r, None) for r in got.records] == [_row(r, jroot) for r in want.records]
    assert got.get_stats() == want.get_stats()
    assert got.get_label_distribution() == want.get_label_distribution()
    for label in ("pfirrmann", "herniation", "modic"):
        assert got.sample_label_values(label) == want.sample_label_values(label)
    gw, ww = got.compute_class_weights(), want.compute_class_weights()
    assert sorted(gw) == sorted(ww)
    for k in ww:
        np.testing.assert_array_equal(gw[k], ww[k])
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g["level_idx"] == w["level_idx"] and g["metadata"] == w["metadata"]
        assert sorted(g["targets"]) == sorted(w["targets"]) == sorted(labels)
        for k in w["targets"]:
            np.testing.assert_array_equal(g["targets"][k], w["targets"][k])
            assert np.asarray(g["targets"][k]).dtype == np.asarray(w["targets"][k]).dtype
        _assert_crops_close(g["image"], w["image"])
        np.testing.assert_array_equal(g["image"][..., 0], g["image"][..., 2])  # [T2, T1, T2]


def test_one_series_fills_three_channels(cls_sets):
    _, troot, store = cls_sets
    ds = tds.ClassificationDataset(troot, series_types=["sag_t2"], image_store=store,
                                   output_size=(32, 32))
    img = ds[0]["image"]
    assert img.shape == (32, 32, 3)
    np.testing.assert_array_equal(img[..., 0], img[..., 1])
    np.testing.assert_array_equal(
        img[..., 0], tds.resize_bilinear_u8(store[ds.records[0]["t2_path"]], 32, 32))


def test_datasets_without_a_store_name_the_roadmap(loc_sets, cls_sets):
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        tds.LocalizationDataset(loc_sets[1])
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        tds.ClassificationDataset(cls_sets[1])
    with pytest.raises(FileNotFoundError, match="not in the image store"):
        tds.LocalizationDataset(loc_sets[1], image_store={})[0]
