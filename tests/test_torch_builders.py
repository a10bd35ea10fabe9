"""The port's dataset builders against the JAX package's.

The JAX builder tests' synthetic trees (a SPIDER ``.mha`` tree and a
lumbar-coords pretrain tree of a JPG and a ``.npy``), plus a Phenikaa tree of
DICOM series and an RSNA tree of DICOM instances, built by both packages on
the CPU: the CSVs byte for byte, the normalised PNGs pixel for pixel, the
crops at the fallback centres within ``test_torch_pipeline.py``'s tolerance
(at most 1 uint8 level on at most 1% of the pixels). Then resume, the file
name parser, the level conversion, the RSNA duplicate descriptions and a
tiny ConvNeXt checkpoint through ``localization_model_path``.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from spine_vision_torch import io as tio
from spine_vision_torch.io.dicom_write import write_dicom_series
from spine_vision_torch.data import builders as tb
from spine_vision_torch.data.builders import classification as tcb
from spine_vision_torch.data.png import read_png
from spine_vision_torch.data.rsna import get_series_type, load_series_mapping
from spine_vision_torch.infer.pipeline import SeriesCropPipeline, StudyPipelineConfig
from spine_vision_torch.io.series import prepare_series_slice
from spine_vision_tpu.data import builders as jb
from spine_vision_tpu.data.rsna import get_series_type as jax_get_series_type
from spine_vision_tpu.data.rsna import load_series_mapping as jax_load_series_mapping
from spine_vision_tpu.ops.image import normalize_to_uint8 as jax_normalize_to_uint8

_SPIDER_FIELDS = ["Patient", "IVD label", "Pfirrman grade", "Disc herniation", "Disc narrowing",
                  "Disc bulging", "Spondylolisthesis", "Modic", "UP endplate", "LOW endplate"]
_PHENIKAA_FIELDS = ["Patient ID", "IVD label", "Pfirrman grade", "Disc herniation",
                    "Disc narrowing", "Disc bulging", "Spondylolisthesis", "UP endplate",
                    "LOW endplate", "Modic_0", "Modic_1", "Modic_2", "Modic_3"]
_CLS_CONFIG = {"crop_size": (32, 32), "image_size": (64, 64), "padded_hw": (256, 256),
               "device_batch_size": 2}


def _write_csv(path, fields, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)


def _grades(rng):
    return {"Pfirrman grade": int(rng.integers(1, 6)), "Disc herniation": int(rng.integers(0, 2)),
            "Disc narrowing": int(rng.integers(0, 2)), "Disc bulging": int(rng.integers(0, 2)),
            "Spondylolisthesis": int(rng.integers(0, 2)), "UP endplate": int(rng.integers(0, 2)),
            "LOW endplate": int(rng.integers(0, 2))}


def _classification_tree(root):
    """The JAX test's SPIDER tree (2 patients, ``.mha`` T1/T2 of 8x48x40)
    and a Phenikaa tree (2 patients, DICOM series directories "SAG T1" and
    "sag t2" of 6x40x48 int16, one-hot Modic columns)."""
    spider = root / "raw" / "SPIDER"
    (spider / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for pid in (1, 2):
        for spider_level in range(1, 6):
            rows.append({"Patient": pid, "IVD label": spider_level, **_grades(rng),
                         "Modic": int(rng.integers(0, 4))})
        for suffix in ("t1", "t2"):
            vol = rng.normal(100, 30, (8, 48, 40)).astype(np.float32)
            image = tio.MedicalImage(array=vol, spacing=(1.2, 1.0, 4.0), origin=(0, 0, 0))
            tio.write_medical_image(image, spider / "images" / f"{pid}_{suffix}.mha")
    _write_csv(spider / "radiological_gradings.csv", _SPIDER_FIELDS, rows)

    phenikaa = root / "interim" / "Phenikaa"
    sagittal = np.array([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    rows = []
    for pid in ("250000001", "250000002"):
        for level in range(1, 6):
            modic = int(rng.integers(0, 4))
            rows.append({"Patient ID": pid, "IVD label": level, **_grades(rng),
                         **{f"Modic_{i}": int(i == modic) for i in range(4)}})
        for name in ("SAG T1", "sag t2"):
            vol = rng.normal(500, 120, (6, 40, 48)).clip(0, 4000).astype(np.int16)
            image = tio.MedicalImage(array=vol, spacing=(0.9, 0.9, 3.5), direction=sagittal)
            write_dicom_series(image, phenikaa / "images" / pid / name)
    _write_csv(phenikaa / "radiological_labels.csv", _PHENIKAA_FIELDS, rows)
    return root


def _tree_files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def classification_builds(tmp_path_factory):
    """Both packages' builds (and resumed builds) of one tree at the
    fallback centres."""
    out = {}
    for name, pkg in (("port", tb), ("jax", jb)):
        root = _classification_tree(tmp_path_factory.mktemp(f"cls_{name}"))
        config = pkg.ClassificationDatasetConfig(base_path=root, **_CLS_CONFIG)
        kw = {"device": "cpu"} if name == "port" else {}
        first = pkg.create_classification_dataset(config, **kw)
        files = _tree_files(config.output_path)
        second = pkg.create_classification_dataset(config, **kw)
        out[name] = (config, first, files, second, _tree_files(config.output_path))
    return out


def test_classification_build_matches_jax(classification_builds):
    config, result, files, _, _ = classification_builds["port"]
    jconfig, jresult, jfiles, _, _ = classification_builds["jax"]
    # 2 patients x 2 series x 5 levels per source.
    assert result.num_samples == jresult.num_samples == 40
    assert result.summary == jresult.summary
    assert files.keys() == jfiles.keys()
    assert files[Path("annotations.csv")] == jfiles[Path("annotations.csv")]
    names = [p for p in files if p.suffix == ".png"]
    assert len(names) == 40
    worst_level, worst_share = 0, 0.0
    for name in names:
        got = read_png(config.output_path / name, mode="gray")
        want = np.asarray(Image.open(jconfig.output_path / name))
        assert got.shape == want.shape == (32, 32) and got.dtype == want.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        worst_level, worst_share = max(worst_level, diff.max()), max(worst_share, np.mean(diff > 0))
    # Stated: <= 1 uint8 level on at most 1% of the crop pixels.
    assert worst_level <= 1 and worst_share <= 0.01, (worst_level, worst_share)


def test_classification_resume_writes_nothing(classification_builds):
    """The second run recovers every record and writes no crop; it rewrites
    the CSV with the same records, in the crops' file-name order (both
    packages), byte for byte the JAX package's resumed CSV."""
    csv_name = Path("annotations.csv")
    for name in ("port", "jax"):
        _, first, files, second, files_after = classification_builds[name]
        assert second.num_samples == first.num_samples == 40
        assert "0 new" in second.summary and "40 recovered" in second.summary, second.summary
        assert {k: v for k, v in files_after.items() if k != csv_name} == {
            k: v for k, v in files.items() if k != csv_name}, name
        lines, lines_after = files[csv_name].splitlines(), files_after[csv_name].splitlines()
        assert lines[0] == lines_after[0] and sorted(lines) == sorted(lines_after), name
    assert (classification_builds["port"][4][csv_name]
            == classification_builds["jax"][4][csv_name])


def test_parse_image_filename_matches_jax():
    for filename in ("spider_42_sag_t2_L3.png", "phenikaa_250012345_sag_t1_L5.png",
                     "spider_a_b_sag_t1_L1.png", "other_42_sag_t2_L3.png",
                     "spider_42_ax_t2_L3.png", "spider_42_sag_t2_L3.jpg"):
        got, want = tb.parse_image_filename(filename), jb.parse_image_filename(filename)
        assert (got is None) == (want is None), filename
        if want is not None:
            assert vars(got) == vars(want)
    info = tb.parse_image_filename("spider_42_sag_t2_L3.png")
    assert (info.source, info.patient_id, info.series_type, info.ivd_level) == (
        "spider", "42", "sag_t2", 3)


def test_spider_level_conversion():
    from spine_vision_tpu.data.builders.classification import convert_spider_to_phenikaa_level

    for level in range(1, 6):
        want = convert_spider_to_phenikaa_level(level)
        assert tcb.convert_spider_to_phenikaa_level(level) == want
    assert tcb.convert_spider_to_phenikaa_level(1) == 5  # L5/S1
    assert tcb.convert_spider_to_phenikaa_level(5) == 1  # L1/L2


def test_data_parallel_raises_naming_item_9(tmp_path, monkeypatch, classification_builds):
    """``data_parallel=True`` crops each batch over the device list (two CPU
    entries here) and writes the files of the build without one, byte for
    byte."""
    lists = []

    def two_cpus(devices=None):
        lists.append(devices)
        return (torch.device("cpu"),) * 2

    monkeypatch.setattr(tcb, "data_parallel_mesh", two_cpus)
    root = _classification_tree(tmp_path / "tree")
    config = tb.ClassificationDatasetConfig(base_path=root, data_parallel=True, **_CLS_CONFIG)
    result = tb.create_classification_dataset(config, device="cpu")
    assert lists == [[torch.device("cpu")]]  # every local device of the kind asked for
    _, want, want_files, _, _ = classification_builds["port"]
    assert result.num_samples == want.num_samples == 40
    assert _tree_files(config.output_path) == want_files


def test_builders_default_to_cuda_and_raise_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.create_classification_dataset(tb.ClassificationDatasetConfig(base_path=tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.create_localization_dataset(tb.LocalizationDatasetConfig(base_path=tmp_path))


def _localization_tree(root):
    """The JAX test's lumbar-coords tree (a JPG and a ``.npy`` source) and an
    RSNA tree: 2 studies x 2 series x 2 instances of 40x48 DICOM, two series
    of one study sharing a description, an axial series, a subarticular row,
    an invalid instance and a missing file."""
    base = root / "raw" / "Lumbar Coords"
    data = base / "data"
    (data / "processed_spider_jpgs").mkdir(parents=True)
    (data / "processed_lsd").mkdir(parents=True)
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 255, (64, 64), dtype=np.uint8)).save(
        data / "processed_spider_jpgs" / "img1.jpg")
    np.save(data / "processed_lsd" / "img2.npy", rng.normal(0, 1, (64, 64)))
    rows = [
        {"filename": "img1.jpg", "source": "spider", "level": "L1/L2",
         "relative_x": 0.5, "relative_y": 0.25},
        {"filename": "img2.jpg", "source": "lsd", "level": "L2/L3",
         "relative_x": 0.4, "relative_y": 0.35},
        {"filename": "img1.jpg", "source": "spider", "level": "L3/L4",
         "relative_x": 0.5, "relative_y": 0.45},
        {"filename": "img3.jpg", "source": "osf", "level": "L3/L4",
         "relative_x": 0.5, "relative_y": 0.45},  # missing
        {"filename": "img4.jpg", "source": "other", "level": "L3/L4",
         "relative_x": 0.5, "relative_y": 0.45},  # unknown source
    ]
    _write_csv(base / "coords_pretrain.csv", list(rows[0]), rows)

    rsna = root / "raw" / "RSNA"
    descriptions = [(10, 7, "Sagittal T2/STIR"), (10, 8, "Sagittal T2/STIR"),
                    (20, 7, "Sagittal T1"), (20, 9, "Axial T2")]
    _write_csv(rsna / "train_series_descriptions.csv",
               ["study_id", "series_id", "series_description"],
               [dict(zip(("study_id", "series_id", "series_description"), d))
                for d in descriptions])
    for study, series, _ in descriptions:
        vol = rng.normal(600, 150, (2, 40, 48)).clip(0, 4000).astype(np.int16)
        vol[1] = 100  # a constant slice keeps its raw values
        write_dicom_series(tio.MedicalImage(array=vol), rsna / "tmp")
        for k in (1, 2):
            target = rsna / "train_images" / str(study) / str(series) / f"{k}.dcm"
            target.parent.mkdir(parents=True, exist_ok=True)
            (rsna / "tmp" / f"slice_{k:04d}.dcm").rename(target)
    coords = []
    for study, series, condition, instance in (
            (10, 7, "Spinal Canal Stenosis", 1), (10, 8, "Spinal Canal Stenosis", 2),
            (10, 7, "Spinal Canal Stenosis", 1), (20, 7, "Left Neural Foraminal Narrowing", 1),
            (20, 7, "Right Subarticular Stenosis", 2), (20, 9, "Spinal Canal Stenosis", 1),
            (20, 7, "Left Neural Foraminal Narrowing", -1), (20, 7, "Spinal Canal Stenosis", 5),
            (30, 7, "Spinal Canal Stenosis", 1)):
        coords.append({"study_id": study, "series_id": series, "instance_number": instance,
                       "condition": condition, "level": "L4/L5", "relative_x": 0.45,
                       "relative_y": 0.625})
    _write_csv(base / "coords_rsna_improved.csv", list(coords[0]), coords)
    return root


@pytest.mark.parametrize("spinal_canal", [True, False])
def test_localization_build_matches_jax(tmp_path, spinal_canal):
    """Annotations CSV byte for byte; RSNA PNGs pixel for pixel; the JPG
    source copied byte for byte; the ``.npy`` source (listed as a ``.jpg``:
    the JAX package encodes it as a lossy JPEG, the port as a PNG) equal to
    the JAX package's normalisation."""
    builds = {}
    for name, pkg in (("port", tb), ("jax", jb)):
        root = _localization_tree(tmp_path / name)
        config = pkg.LocalizationDatasetConfig(base_path=root, include_spinal_canal=spinal_canal)
        result = (pkg.create_localization_dataset(config, device="cpu") if name == "port"
                  else pkg.create_localization_dataset(config))
        builds[name] = (root, config.output_path, result)
    (root, out, result), (jroot, jout, jresult) = builds["port"], builds["jax"]
    assert result.num_samples == jresult.num_samples == (7 if spinal_canal else 4)
    assert (out / "annotations.csv").read_bytes() == (jout / "annotations.csv").read_bytes()
    names = sorted(p.name for p in (out / "images").iterdir())
    assert names == sorted(p.name for p in (jout / "images").iterdir())
    assert ((out / "images" / "pretrain_spider_img1.jpg").read_bytes()
            == (root / "raw/Lumbar Coords/data/processed_spider_jpgs/img1.jpg").read_bytes())
    npy = np.load(root / "raw/Lumbar Coords/data/processed_lsd/img2.npy")
    np.testing.assert_array_equal(read_png(out / "images" / "pretrain_lsd_img2.jpg", "gray"),
                                  np.asarray(jax_normalize_to_uint8(npy)))
    rsna = [n for n in names if n.startswith("rsna_")]
    assert len(rsna) == (3 if spinal_canal else 1)
    for n in rsna:
        got = read_png(out / "images" / n, mode="gray")
        np.testing.assert_array_equal(got, np.asarray(Image.open(jout / "images" / n)))
    if spinal_canal:
        assert np.all(read_png(out / "images" / "rsna_10_8_2.png", mode="gray") == 100)


def test_rsna_series_mapping_keeps_duplicate_descriptions(tmp_path):
    csv_path = tmp_path / "train_series_descriptions.csv"
    csv_path.write_text(
        "study_id,series_id,series_description\n"
        "100,7,Sagittal T2/STIR\n"
        "100,8,Sagittal T2/STIR\n"
        "100,9,Sagittal T1\n"
        "200,7,Axial T2\n"
    )
    mapping = load_series_mapping(csv_path)
    assert mapping == jax_load_series_mapping(csv_path)
    for series, study, want in ((7, 100, "Sagittal T2/STIR"), (8, 100, "Sagittal T2/STIR"),
                                (9, 100, "Sagittal T1"), (7, 200, "Axial T2"),
                                (9, 999, None), (999, 100, None)):
        assert get_series_type(series, study, mapping) == want
        assert jax_get_series_type(series, study, mapping) == want


def test_localization_model_path_equals_series_crop_pipeline(tmp_path):
    """A tiny ConvNeXt saved with the port's ``save_checkpoint`` and loaded
    through ``localization_model_path`` crops as ``SeriesCropPipeline.run``
    with the saved model does, on ``prepare_series_slice`` of the same files
    in the builder's batches, bit for bit (both bf16 on the CPU)."""
    from spine_vision_torch.models.classifier import CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
    from spine_vision_torch.train.checkpoint import save_checkpoint
    from spine_vision_torch.train.state import TrainState

    root = _classification_tree(tmp_path / "tree")
    kw = {"dtype": torch.bfloat16, "device": "cpu", "use_pallas": False,
          "param_dtype": torch.float32}
    model = CoordinateRegressor("convnext_tiny", **kw)
    load_flax_variables(model, random_flax_variables(model, 3)[0])
    ckpt = tmp_path / "run" / "best_model"
    state = TrainState(model=model, optimizer=torch.optim.AdamW(model.parameters()),
                       schedule=lambda step: 1e-3, generator=torch.Generator())
    save_checkpoint(ckpt, state, {"epoch": 0})
    config = tb.ClassificationDatasetConfig(
        base_path=root, localization_model_path=ckpt, localization_backbone="convnext_tiny",
        include_phenikaa=False, **_CLS_CONFIG)
    result = tb.create_classification_dataset(config, device="cpu")
    assert result.num_samples == 20

    pipe = SeriesCropPipeline(model, config=StudyPipelineConfig(
        loc_image_size=(64, 64), crop_size=(32, 32), padded_hw=(256, 256)), device="cpu")
    series = (("t1", "sag_t1"), ("t2", "sag_t2"))
    for pid in (1, 2):  # the builder's batches: a patient's two series
        inputs = [prepare_series_slice(root / "raw" / "SPIDER" / "images" / f"{pid}_{suffix}.mha",
                                       device="cpu") for suffix, _ in series]
        _, _, crops = pipe.run([s for s, _ in inputs], [sp for _, sp in inputs])
        for (_, series_type), series_crops in zip(series, crops):
            for level in range(1, 6):
                name = f"spider_{pid}_{series_type}_L{level}.png"
                got = read_png(config.output_path / "images" / name, mode="gray")
                np.testing.assert_array_equal(got, series_crops[level - 1], err_msg=name)
