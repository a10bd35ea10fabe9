"""The port's ``ClassificationTrainer`` on the CPU, on a tiny in-memory set.

Epochs, the run-dir layout, best-model gating on ``-macro_f1`` (or ``-f1``
for one task), the reload of the best model, resume from a checkpoint,
``evaluate``, freezing then unfreezing the backbone, the weighted loader and
the options that are not ported.
"""

import json

import numpy as np
import pytest
import torch

from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, get_task
from spine_vision_torch.models.convert import export_flax_variables
from spine_vision_torch.train.classification import ClassificationConfig, ClassificationTrainer
from spine_vision_torch.train.steps import to_device


class _Set:
    """In-memory classification samples: uint8 images and seeded labels."""

    def __init__(self, n, hw, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
        self.targets = {}
        for name in AVAILABLE_TASK_NAMES:
            task = get_task(name)
            self.targets[name] = rng.integers(0, task.num_classes if task.is_multiclass else 2, n)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i],
                "targets": {k: v[i] for k, v in self.targets.items()},
                "level_idx": i % 5, "metadata": {"image_path": f"{i}.png"}}

    def sample_label_values(self, label):
        return list(self.targets[label])


def _config(tmp_path, name, **kw):
    base = dict(output_size=(32, 32), batch_size=4, num_epochs=2, output_path=tmp_path / name,
                num_workers=2, seed=0, pretrained=False)
    return ClassificationConfig(**{**base, **kw})


def test_cpu_classification_trainer_layout_gating_reload_resume_evaluate(tmp_path):
    run = tmp_path / "run"
    trainer = ClassificationTrainer(_config(tmp_path, "run"), train_dataset=_Set(12, 32, 0),
                                    val_dataset=_Set(6, 32, 1), device="cpu")
    assert trainer.train_loader.sample_weights is not None  # weighted on pfirrmann
    result = trainer.train()
    for name in ("best_model/state.pt", "best_model.meta.json", "config.yaml", "logs"):
        assert (run / name).exists(), name
    assert 'backbone: "resnet18"' in (run / "config.yaml").read_text()
    history = result.history
    for key in ("train_loss", "val_loss", "lr", "macro_f1", "overall_accuracy",
                "pfirrmann_balanced_acc", "herniation_f1"):
        assert len(history[key]) == 2 and all(np.isfinite(history[key])), key
    best = int(np.argmax(history["macro_f1"]))
    assert result.best_metric == -history["macro_f1"][best]
    meta = json.loads((run / "best_model.meta.json").read_text())
    assert meta["epoch"] == best
    # The best model was reloaded: its weights and running statistics.
    saved = torch.load(run / "best_model" / "state.pt", weights_only=True)["model"]
    assert any(k.endswith("stem_bn.mean") for k in saved)
    for name, value in trainer.model.state_dict().items():
        torch.testing.assert_close(value, saved[name], rtol=0, atol=0)
    _, stats = export_flax_variables(trainer.model)
    assert stats["backbone"]["stem_bn"]["var"].shape == (64,)

    metrics = trainer.evaluate(test_dataset=_Set(7, 32, 2))
    assert {"macro_f1", "overall_accuracy", "macro_auc", "pfirrmann_accuracy"} <= set(metrics)
    assert trainer.evaluate(test_dataset=_Set(0, 32, 2)) == {}

    # Resume from the best checkpoint: the epochs after it.
    cfg2 = _config(tmp_path, "run2", num_epochs=3, checkpoint_path=run / "best_model")
    trainer2 = ClassificationTrainer(cfg2, train_dataset=_Set(12, 32, 0),
                                     val_dataset=_Set(6, 32, 1), device="cpu")
    result2 = trainer2.train()
    assert len(result2.history["train_loss"]) == 3
    assert result2.history["train_loss"][:best + 1] == history["train_loss"][:best + 1]


def test_single_task_gates_on_f1_and_frozen_backbone_unfreezes(tmp_path):
    """One target label gates on ``-f1``; the backbone is frozen in epoch 1
    (its weights stay, its BatchNorm statistics move) and trains in epoch 2."""
    cfg = _config(tmp_path, "one", target_labels=["herniation"], freeze_backbone_epochs=1,
                  use_weighted_sampling=False)
    trainer = ClassificationTrainer(cfg, train_dataset=_Set(8, 32, 3),
                                    val_dataset=_Set(4, 32, 4), device="cpu")
    assert [t.name for t in trainer.model.tasks] == ["herniation"]
    assert trainer._frozen
    backbone0 = {n: p.detach().clone() for n, p in trainer.model.backbone.named_parameters()}
    head0 = trainer.model.head_herniation.weight.detach().clone()
    mean0 = trainer.model.backbone.stem_bn.mean.clone()
    epochs = []

    def on_epoch_end(epoch, metrics):
        epochs.append(({n: p.detach().clone()
                        for n, p in trainer.model.backbone.named_parameters()},
                       trainer.model.head_herniation.weight.detach().clone(),
                       trainer.model.backbone.stem_bn.mean.clone()))

    trainer.on_epoch_end = on_epoch_end
    result = trainer.train()
    assert "f1" in result.history and "macro_f1" not in result.history
    assert not trainer._frozen
    frozen_backbone, frozen_head, frozen_mean = epochs[0]
    for n, value in frozen_backbone.items():
        assert torch.equal(value, backbone0[n]), n
    assert not torch.equal(frozen_head, head0) and not torch.equal(frozen_mean, mean0)
    assert any(not torch.equal(v, frozen_backbone[n]) for n, v in epochs[1][0].items())


def test_to_device_uploads_nested_targets():
    batch = {"image": np.zeros((2, 4, 4, 3), np.uint8),
             "targets": {"modic": np.array([1, 2], np.int32)}, "metadata": [{}, {}]}
    out = to_device(batch, torch.device("cpu"))
    assert isinstance(out["targets"]["modic"], torch.Tensor) and out["metadata"] == [{}, {}]


def _png_dir(root, n_patients, hw, seed):
    """A classification data directory: gray PNG crops (the port's encoder)
    for T1 and T2 of each patient and level, all 8 label columns."""
    from spine_vision_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    lines = ["image_path,patient_id,ivd_level,series_type,source,pfirrmann_grade,"
             "disc_herniation,disc_narrowing,disc_bulging,spondylolisthesis,modic,"
             "up_endplate,low_endplate"]
    for p in range(n_patients):
        for level in range(1, 6):
            labels = [rng.integers(1, 6), *rng.integers(0, 2, 4), rng.integers(0, 4),
                      *rng.integers(0, 2, 2)]
            for series in ("sag_t1", "sag_t2"):
                name = f"images/synth_p{p}_{series}_L{level}.png"
                write_png(root / name, rng.integers(0, 256, (hw, hw), dtype=np.uint8))
                lines.append(",".join(map(str, [name, f"p{p}", level, series, "synth",
                                                *labels])))
    (root / "annotations.csv").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize(
    "overrides,call",
    # Datasets and evaluate() from disk are ported: their cases check that
    # they read the data directory. The backbone zoo is ported: its cases
    # (Flax BatchNorm, the scatter-free pool, ResNet-50, EfficientNet-B0)
    # check that the trainer trains it.
    [({"visualize_predictions": True}, None), ({"norm_impl": "flax"}, None),
     ({"pool_impl": "tpu"}, None), ({"backbone": "resnet50"}, None),
     ({"backbone": "efficientnet_b0"}, None), ({}, "no_datasets"),
     ({}, "evaluate_visualize"), ({}, "evaluate_from_disk")],
)
def test_unported_classification_options_name_the_roadmap(tmp_path, overrides, call):
    if call is None and "visualize_predictions" not in overrides:
        # One f32 epoch of one step; the BatchNorms' running statistics move.
        trainer = ClassificationTrainer(
            _config(tmp_path, "zoo", num_epochs=1, mixed_precision=False, **overrides),
            train_dataset=_Set(4, 32, 0), val_dataset=_Set(2, 32, 1), device="cpu")
        norms = [m for m in trainer.model.backbone.modules() if hasattr(m, "var")]
        var0 = [m.var.clone() for m in norms]
        result = trainer.train()
        assert np.isfinite(result.history["train_loss"][0])
        assert norms and all(not torch.equal(m.var, v) for m, v in zip(norms, var0))
        if "norm_impl" in overrides:
            from spine_vision_torch.models.layers import FlaxBatchNorm

            assert all(isinstance(m, FlaxBatchNorm) for m in norms)
        return
    if call in ("no_datasets", "evaluate_from_disk"):
        from spine_vision_torch.data.datasets import ClassificationDataset, PngStore

        data = _png_dir(tmp_path / "data", 6, 32, seed=5)
        cfg = _config(tmp_path, "r", data_path=data, num_epochs=1, **overrides)
        if call == "no_datasets":
            trainer = ClassificationTrainer(cfg, device="cpu")
            for ds, split in ((trainer.train_dataset, "train"), (trainer.val_dataset, "val")):
                assert isinstance(ds, ClassificationDataset) and ds.split == split and len(ds)
                assert isinstance(ds.image_store, PngStore) and ds.image_store.mode == "gray"
            assert trainer.train_loader.sample_weights is not None
            result = trainer.train()
            assert len(result.history["macro_f1"]) == 1
            assert np.isfinite(result.history["train_loss"][0])
            return
        trainer = ClassificationTrainer(cfg, train_dataset=_Set(4, 32, 0),
                                        val_dataset=_Set(2, 32, 1), device="cpu")
        test = ClassificationDataset(data, split="test", val_ratio=0.2, output_size=(32, 32),
                                     augment=False, seed=0)
        assert len(test) > 0
        got = trainer.evaluate()
        assert "macro_f1" in got
        np.testing.assert_equal(got, trainer.evaluate(test_dataset=test))  # NaN == NaN
        return
    # The plots are ported: visualize_predictions draws the training curves
    # (the label distribution needs the test split on disk: it warns), and
    # evaluate(visualize=True) the test figures, with or without the option.
    cfg = _config(tmp_path, "r", num_epochs=1, mixed_precision=False, **overrides)
    trainer = ClassificationTrainer(cfg, train_dataset=_Set(4, 32, 0),
                                    val_dataset=_Set(2, 32, 1), device="cpu")
    logs = tmp_path / "r" / "logs"
    if call == "evaluate_visualize":
        metrics = trainer.evaluate(test_dataset=_Set(2, 32, 2), visualize=True)
        assert "macro_f1" in metrics
        want = {"test_metrics.png", "confusion_summary.png",
                *(f"confusion_matrix_samples_{t}.png" for t in AVAILABLE_TASK_NAMES)}
    else:
        assert np.isfinite(trainer.train().history["train_loss"][0])
        want = {"training_curves.png"}
    assert {p.name for p in logs.glob("*.png")} == want
