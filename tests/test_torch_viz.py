"""``spine_vision_torch/viz`` against ``spine_vision_tpu/viz``.

Every name of the JAX package's ``viz.__all__`` is called through both
packages on the same seeded inputs (the cases of ``tests/test_viz.py`` and
``tests/test_visualizer.py``); each figure is drawn on Agg at a fixed dpi
and the two RGBA buffers must be equal bit for bit. The visualizers write
the same file names in each output mode, the trackers the same records but
for ``time``, ``load_classification_original_images`` gives cv2's arrays,
and one-epoch CPU trainers with the plots and the tracker on write the same
files as the JAX trainers.
"""

import json
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import spine_vision_torch.viz as tviz  # noqa: E402
import spine_vision_tpu.viz as jviz  # noqa: E402

LEVELS = ["L1/L2", "L2/L3", "L3/L4", "L4/L5", "L5/S1"]
BINARY = ["herniation", "bulging", "narrowing"]
DPI = 40


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _images(rng, n, size=24, channels=0):
    shape = (size, size, channels) if channels else (size, size)
    return [rng.integers(0, 255, shape, dtype=np.uint8) for _ in range(n)]


def _loc(rng, n=6):
    return dict(images=_images(rng, n), preds=rng.uniform(0.2, 0.8, (n, 2)),
                targets=rng.uniform(0.2, 0.8, (n, 2)), levels=rng.integers(0, 5, n))


def _cls(rng, n=8):
    images = _images(rng, n, channels=3)
    preds = {"pfirrmann": rng.uniform(0, 1, (n, 5)), "herniation": rng.uniform(0, 1, (n, 1))}
    targets = {"pfirrmann": rng.integers(0, 5, n),
               "herniation": rng.integers(0, 2, (n, 1)).astype(np.float32)}
    return images, preds, targets, ["pfirrmann", "herniation"]


def _records(rng):
    return [{"level_idx": int(rng.integers(0, 5)), "pfirrmann": int(rng.integers(1, 6)),
             **{lab: int(rng.integers(0, 2)) for lab in BINARY}} for _ in range(40)]


def _distribution():
    distribution = {lab: {0: 20, 1: 5} for lab in BINARY}
    distribution["pfirrmann"] = {g: 10 for g in range(5)}
    return distribution


# Each case: (viz name, a function of (the package's viz module, a seeded
# Generator) returning a figure).
FIGURES = {
    "make_image_grid": lambda v, r: v.make_image_grid(
        _images(r, 5) + _images(r, 2, channels=3), titles=list("abcdefg"), cols=3),
    "plot_training_curves": lambda v, r: v.plot_training_curves(
        {"train_loss": [1.0, 0.5, 0.3], "val_loss": [0.9, 0.6, 0.4], "lr": [1e-3, 8e-4, 5e-4],
         "med": [0.2, 0.15, 0.12]}),
    "plot_localization_predictions": lambda v, r: (lambda d: v.plot_localization_predictions(
        d["images"], d["preds"], d["targets"], [{"level": lv} for lv in LEVELS]))(_loc(r)),
    "plot_error_distribution": lambda v, r: (lambda d: v.plot_error_distribution(
        d["preds"], d["targets"], d["levels"], LEVELS))(_loc(r)),
    "plot_error_distribution_no_levels": lambda v, r: (lambda d: v.plot_error_distribution(
        d["preds"], d["targets"]))(_loc(r)),
    "plot_per_level_metrics": lambda v, r: v.plot_per_level_metrics(
        {f"med_{name}": float(r.uniform(0, 0.2)) for name in LEVELS}, LEVELS),
    "visualize_sample": lambda v, r: v.visualize_sample(
        _images(r, 1)[0], r.uniform(0.2, 0.8, (5, 2)), np.array([1, 1, 0, 1, 1]), LEVELS),
    "plot_classification_predictions": lambda v, r: (lambda i, p, t, _: (
        v.plot_classification_predictions(i, p, t, [{"level": lv} for lv in LEVELS])))(*_cls(r)),
    "plot_classification_metrics": lambda v, r: v.plot_classification_metrics(
        {"pfirrmann_accuracy": 70.0, "pfirrmann_balanced_acc": 65.0,
         "herniation_accuracy": 80.0, "herniation_f1": 0.7}, ["pfirrmann", "herniation"]),
    "plot_confusion_matrix_with_samples": lambda v, r: (lambda i, p, t, _: (
        v.plot_confusion_matrix_with_samples("pfirrmann", i, p["pfirrmann"], t["pfirrmann"])))(
            *_cls(r)),
    "plot_test_samples_with_labels": lambda v, r: (lambda i, p, t, labels: (
        v.plot_test_samples_with_labels(i, p, t, labels)))(*_cls(r)),
    "plot_confusion_examples": lambda v, r: (lambda i, p, t, _: v.plot_confusion_examples(
        "herniation", i, p["herniation"], t["herniation"]))(*_cls(r)),
    "plot_confusion_summary": lambda v, r: (lambda i, p, t, labels: (
        v.plot_confusion_summary(p, t, labels)))(*_cls(r)),
    "plot_label_distribution": lambda v, r: v.plot_label_distribution(
        {split: {"pfirrmann": {g: int(r.integers(1, 9)) for g in range(5)},
                 "herniation": {0: 10, 1: 3}} for split in ("train", "val", "test")},
        ["pfirrmann", "herniation"]),
    "plot_dataset_statistics": lambda v, r: v.plot_dataset_statistics(
        {"levels": {name: int(r.integers(5, 15)) for name in LEVELS},
         "sources": {"spider": 30, "phenikaa": 20}, "series_types": {"sag_t1": 25, "sag_t2": 25},
         "num_samples": 50}),
    "plot_binary_label_distributions": lambda v, r: v.plot_binary_label_distributions(
        _distribution(), BINARY),
    "plot_label_cooccurrence": lambda v, r: v.plot_label_cooccurrence(_records(r), BINARY),
    "plot_pfirrmann_by_level": lambda v, r: v.plot_pfirrmann_by_level(_records(r)),
    "plot_samples_per_class": lambda v, r: v.plot_samples_per_class(
        _distribution(), BINARY + ["pfirrmann"]),
}


def _pixels(fig) -> np.ndarray:
    fig.set_dpi(DPI)
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


@pytest.mark.parametrize("name", list(FIGURES))
def test_figures_render_as_jax(name):
    got = _pixels(FIGURES[name](tviz, np.random.default_rng(len(name))))
    want = _pixels(FIGURES[name](jviz, np.random.default_rng(len(name))))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_every_jax_name_is_ported():
    assert tviz.__all__ == jviz.__all__
    covered = {n.replace("_no_levels", "") for n in FIGURES} | {
        "CONFUSION_COLORS", "SPLIT_COLORS", "extract_prediction_value", "save_figure",
        "load_classification_original_images", "ExperimentTracker", "BaseVisualizer",
        "TrainingVisualizer", "DatasetVisualizer"}
    assert covered == set(jviz.__all__)
    assert tviz.CONFUSION_COLORS == jviz.CONFUSION_COLORS
    assert tviz.SPLIT_COLORS == jviz.SPLIT_COLORS
    rng = np.random.default_rng(0)
    for pred in [0.3, 0.7, 3, np.array([0.2]), np.array([[0.9]]), rng.uniform(0, 1, 5), 2.0]:
        assert tviz.extract_prediction_value(pred) == jviz.extract_prediction_value(pred)


def test_tracker_only_loads_no_plotting():
    import subprocess

    code = ("import sys\nsys.modules['matplotlib'] = None\n"
            "from spine_vision_torch.viz import ExperimentTracker\n"
            "from spine_vision_torch.viz.tracker import ExperimentTracker as T\n"
            "assert ExperimentTracker is T\n"
            "try:\n    from spine_vision_torch.viz import save_figure\n"
            "except ImportError:\n    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


def test_visualize_predictions_without_matplotlib_raises(monkeypatch, tmp_path):
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for name in [m for m in sys.modules if m.startswith("spine_vision_torch.viz.")]:
        if not name.endswith(".tracker"):
            monkeypatch.delitem(sys.modules, name)
    cfg = LocalizationConfig(output_path=tmp_path, visualize_predictions=True, pretrained=False)
    with pytest.raises(ImportError, match="matplotlib.*visualize_predictions"):
        LocalizationTrainer(cfg, train_dataset=[], val_dataset=[], device="cpu")


def _tracked(pkg, tmp_path):
    tracker = pkg.ExperimentTracker("proj", "run", tmp_path)
    tracker.log_config({"lr": 1e-3, "path": tmp_path / "x", "sizes": (1, 2), "obj": object})
    tracker.log_metrics({"loss": 0.5, "arr": np.float32(0.25)}, step=0)
    tracker.log_metrics({"loss": 0.4})
    fig = tmp_path / "fig.png"
    fig.write_bytes(b"png")
    tracker.log_figure(fig)
    tracker.log_figure(fig, name="renamed.png")
    tracker.log_figure(tmp_path / "missing.png")
    tracker.finish()
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    for r in records:
        assert r.pop("time") >= 0
    config = json.loads((tmp_path / "tracker_config.json").read_text())
    config["config"]["path"] = config["config"]["path"].replace(str(tmp_path), "")
    return records, config, sorted(p.name for p in (tmp_path / "media").iterdir())


def test_tracker_records_match_jax(tmp_path):
    got = _tracked(tviz, tmp_path / "t")
    want = _tracked(jviz, tmp_path / "j")
    assert got[0] == want[0] and len(got[0]) == 3
    assert got[1:] == want[1:]


class _StubDataset:
    records = [{"level_idx": i % 5, "pfirrmann": (i % 5) + 1, "herniation": i % 2,
                "bulging": (i // 2) % 2, "upper_endplate": 0, "lower_endplate": 1,
                "spondylolisthesis": i % 2, "narrowing": 0} for i in range(20)]

    def get_stats(self):
        return {"levels": {name: 4 for name in LEVELS}, "sources": {"spider": 12, "phenikaa": 8},
                "series_types": {"sag_t1": 10, "sag_t2": 10}}

    def get_label_distribution(self):
        return {"pfirrmann": {g: 4 for g in range(1, 6)}, "herniation": {0: 10, 1: 10}}


def _visualized(pkg, out, mode):
    """The TrainingVisualizer methods ("image": every one; the other modes
    two) and DatasetVisualizer.generate_all in one output mode: the files
    written (the tracker's media included), the suite's file names and the
    HTML pages."""
    rng = np.random.default_rng(3)
    tracker = pkg.ExperimentTracker("p", "r", out / "logs")
    viz = pkg.TrainingVisualizer(out / "figs", output_mode=mode, tracker=tracker)
    viz.plot_training_curves({"train_loss": [1.0, 0.5], "val_loss": [0.9, 0.7], "lr": [1e-3, 5e-4]})
    viz.plot_per_level_metrics({f"med_{n}": 0.1 for n in LEVELS}, LEVELS)
    if mode == "image":
        d = _loc(rng, 3)
        images, preds, targets, labels = _cls(rng, 4)
        viz.plot_localization_predictions(d["images"], d["preds"], d["targets"])
        viz.plot_error_distribution(d["preds"], d["targets"], d["levels"], LEVELS)
        viz.plot_classification_metrics({"pfirrmann_accuracy": 50.0}, labels)
        viz.plot_classification_predictions(images, preds, targets)
        viz.plot_confusion_matrices_with_samples(images, preds, targets, labels + ["bulging"])
        viz.plot_confusion_examples("herniation", images, preds["herniation"],
                                    targets["herniation"])
        viz.plot_confusion_summary(preds, targets, labels)
        viz.plot_test_samples_with_labels(images, preds, targets, labels)
        viz.plot_label_distribution({"train": {"pfirrmann": {1: 3, 2: 4}}}, ["pfirrmann"])
    paths = pkg.DatasetVisualizer(out / "ds", output_mode=mode).generate_all(_StubDataset(), "ds")
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()
                   and p.suffix in (".png", ".html"))
    html = sorted(p.read_text() for p in out.rglob("*.html"))
    return files, [p.name for p in paths], html


@pytest.mark.parametrize("mode", ["image", "html", "browser"])
def test_visualizers_write_the_same_files(tmp_path, monkeypatch, mode):
    import webbrowser

    opened = []
    monkeypatch.setattr(webbrowser, "open", opened.append)
    got = _visualized(tviz, tmp_path / "t", mode)
    want = _visualized(jviz, tmp_path / "j", mode)
    assert got == want and len(got[1]) == 5
    assert len(opened) == (2 * len(got[2]) if mode == "browser" else 0)
    assert ("figs/training_curves.html" in got[0]) == (mode != "image")
    assert "logs/media/training_curves.png" in got[0]


def test_save_figure_modes_match_jax(tmp_path, monkeypatch):
    import webbrowser

    monkeypatch.setattr(webbrowser, "open", lambda uri: None)
    for mode in ("image", "html", "browser"):
        for pkg, sub in ((tviz, "t"), (jviz, "j")):
            fig, ax = plt.subplots(figsize=(2, 2))
            ax.plot([0, 1], [1, 0])
            path = pkg.save_figure(fig, tmp_path / sub / mode, "f", output_mode=mode, dpi=DPI)
            assert path == tmp_path / sub / mode / "f.png" and not plt.fignum_exists(fig.number)
        assert (sorted(p.name for p in (tmp_path / "t" / mode).iterdir())
                == sorted(p.name for p in (tmp_path / "j" / mode).iterdir()))
        assert (plt.imread(tmp_path / "t" / mode / "f.png")
                == plt.imread(tmp_path / "j" / mode / "f.png")).all()


def test_load_classification_original_images_matches_cv2(tmp_path):
    from spine_vision_torch.data.png import write_png

    rng = np.random.default_rng(5)
    (tmp_path / "images").mkdir()
    metadata = []
    for i, (h, w) in enumerate([(40, 52), (256, 256), (300, 199), (17, 9)]):
        meta = {"source": "spider", "patient_id": f"p{i}", "ivd": 1 + i}
        for series in ("t1", "t2") if i != 2 else ("t2",):
            write_png(tmp_path / "images" / f"spider_p{i}_sag_{series}_L{1 + i}.png",
                      rng.integers(0, 256, (h, w), dtype=np.uint8))
        metadata.append(meta)
    metadata.append({"source": "spider", "patient_id": "none", "ivd": 9})
    for size in ((256, 256), (64, 80), (301, 123)):
        got = tviz.load_classification_original_images(tmp_path, metadata, size)
        want = jviz.load_classification_original_images(tmp_path, metadata, size)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


def _loc_store(root):
    from spine_vision_torch.utils import parity

    return parity._build_loc_dataset(root, np.random.default_rng(1), 24)


def _cls_dir(root):
    from spine_vision_torch.data.png import write_png

    rng = np.random.default_rng(2)
    (root / "images").mkdir(parents=True)
    lines = ["image_path,patient_id,ivd_level,series_type,source,pfirrmann_grade,"
             "disc_herniation,disc_narrowing,disc_bulging,spondylolisthesis,modic,"
             "up_endplate,low_endplate"]
    for p in range(8):
        for level in range(1, 6):
            labels = [rng.integers(1, 6), *rng.integers(0, 2, 4), rng.integers(0, 4),
                      *rng.integers(0, 2, 2)]
            for series in ("sag_t1", "sag_t2"):
                name = f"images/synth_p{p}_{series}_L{level}.png"
                write_png(root / name, rng.integers(0, 256, (32, 32), dtype=np.uint8))
                lines.append(",".join(map(str, [name, f"p{p}", level, series, "synth",
                                                *labels])))
    (root / "annotations.csv").write_text("\n".join(lines) + "\n")
    return root


def _files(run):
    return sorted(str(p.relative_to(run)) for p in (run / "logs").rglob("*") if p.is_file())


@pytest.mark.parametrize("task", ["localization", "classification"])
def test_trainers_write_the_jax_files(tmp_path, task):
    """One epoch of a ResNet-18 at 32^2 (f32) with visualize_predictions and
    use_tracker: the same files under logs/ as the JAX trainer's, and the
    tracker's config snapshot with the same keys."""
    from spine_vision_torch.data import datasets as tds

    common = dict(backbone="resnet18", pretrained=False, batch_size=8, num_epochs=1,
                  mixed_precision=False, num_workers=0, seed=0, visualize_predictions=True,
                  use_tracker=True, run_id="run", num_visualization_samples=2)
    if task == "localization":
        from spine_vision_torch.train.localization import LocalizationConfig as TC
        from spine_vision_torch.train.localization import LocalizationTrainer as TT
        from spine_vision_tpu.train.localization import LocalizationConfig as JC
        from spine_vision_tpu.train.localization import LocalizationTrainer as JT

        store = _loc_store(tmp_path / "data")
        train, val = (tds.LocalizationDataset(tmp_path / "data", split=s, val_ratio=0.25,
                                              image_size=(32, 32), augment=False, seed=0,
                                              image_store=store) for s in ("train", "val"))
        common.update(image_size=(32, 32), data_path=tmp_path / "data")
        kw = {"train_dataset": train, "val_dataset": val}
    else:
        from spine_vision_torch.train.classification import ClassificationConfig as TC
        from spine_vision_torch.train.classification import ClassificationTrainer as TT
        from spine_vision_tpu.train.classification import ClassificationConfig as JC
        from spine_vision_tpu.train.classification import ClassificationTrainer as JT

        common.update(output_size=(32, 32), data_path=_cls_dir(tmp_path / "data"),
                      val_split=0.25, target_labels=["pfirrmann", "herniation"])
        kw = {}
    port = TT(TC(output_path=tmp_path / "t", **common), device="cpu", **kw)
    port.train()
    ref = JT(JC(output_path=tmp_path / "j", **common), **kw)
    ref.train()
    if task == "classification":
        port.evaluate(visualize=True)
        ref.evaluate(visualize=True)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert got == want and "logs/metrics.jsonl" in got and len(got) > 5
    snap = [json.loads((tmp_path / r / "logs" / "tracker_config.json").read_text())
            for r in ("t", "j")]
    assert snap[0]["config"].keys() == snap[1]["config"].keys()
    rows = [[json.loads(line).keys() for line in
             (tmp_path / r / "logs" / "metrics.jsonl").read_text().splitlines()] for r in "tj"]
    assert rows[0] == rows[1]
