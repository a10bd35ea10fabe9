"""``StudyInferencePipeline.from_checkpoints`` over the port's run directories.

Port trainers on the CPU (ResNet-18 localization at 64², ResNet-18 grading
at 48², one epoch each on seeded in-memory sets) write their run
directories; ``from_checkpoints(device="cpu")`` must then give the JAX
``StudyInferencePipeline`` built from ``export_flax_variables`` of the same
weights within ``test_torch_pipeline.py``'s bounds, on 2 studies in both crop
modes, and a port pipeline over the trainers' in-memory models bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, get_task
from spine_vision_torch.infer import pipeline as tpipe
from spine_vision_torch.models.convert import export_flax_variables
from spine_vision_torch.parallel import data_parallel_mesh
from spine_vision_torch.train.checkpoint import load_model_state
from spine_vision_torch.train.classification import ClassificationConfig, ClassificationTrainer
from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer
from spine_vision_tpu.infer import StudyInferencePipeline, StudyInput, StudyPipelineConfig
from spine_vision_tpu.models import Classifier, CoordinateRegressor

CONFIG = {"loc_image_size": (64, 64), "crop_size": (48, 48), "padded_hw": (128, 128)}


class _Loc:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
        self.coords = rng.uniform(0.2, 0.8, (n, 5, 2)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "coords": self.coords[i],
                "mask": np.ones(5, np.float32), "series_type_idx": 0, "metadata": {}}


class _Cls:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 48, 48, 3), dtype=np.uint8)
        self.targets = {name: rng.integers(0, get_task(name).num_classes
                                           if get_task(name).is_multiclass else 2, n)
                        for name in AVAILABLE_TASK_NAMES}

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "targets": {k: v[i] for k, v in self.targets.items()},
                "level_idx": i % 5, "metadata": {}}

    def sample_label_values(self, label):
        return list(self.targets[label])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    common = {"batch_size": 4, "num_epochs": 1, "pretrained": False, "mixed_precision": False,
              "num_workers": 2, "seed": 0, "learning_rate": 1e-3}
    loc = LocalizationTrainer(
        LocalizationConfig(backbone="resnet18", image_size=(64, 64), output_path=root / "loc",
                           **common),
        train_dataset=_Loc(8, 0), val_dataset=_Loc(4, 1), device="cpu")
    loc.train()
    cls = ClassificationTrainer(
        ClassificationConfig(backbone="resnet18", output_size=(48, 48), output_path=root / "cls",
                             **common),
        train_dataset=_Cls(8, 2), val_dataset=_Cls(4, 3), device="cpu")
    cls.train()
    return root, loc.model, cls.model


def _studies(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        shapes = [(int(rng.integers(64, 128)), int(rng.integers(64, 128))) for _ in range(2)]
        out.append(dict(
            t1_slice=rng.normal(100, 30, shapes[0]).astype(np.float32),
            t2_slice=rng.normal(100, 30, shapes[1]).astype(np.float32),
            t1_spacing=(0.6, 0.6), t2_spacing=(0.7, 0.5), study_id=f"study{i}",
        ))
    return out


def _variables(model):
    params, stats = export_flax_variables(model)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def loaded(runs):
    root = runs[0]
    return tpipe.StudyInferencePipeline.from_checkpoints(
        root / "loc" / "best_model", root / "cls" / "best_model", loc_backbone="resnet18",
        config=tpipe.StudyPipelineConfig(**CONFIG), dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("mode", ["horizontal", "rotated"])
def test_from_checkpoints_matches_jax_on_the_same_weights(runs, loaded, mode):
    _, loc_model, cls_model = runs
    assert loaded.device.type == "cpu"
    cfg = tpipe.StudyPipelineConfig(crop_mode=mode, **CONFIG)
    pipe = tpipe.StudyInferencePipeline(loaded.loc_model, loaded.cls_model, config=cfg,
                                        device="cpu")
    ref = StudyInferencePipeline(
        CoordinateRegressor(backbone_name="resnet18", dtype=jnp.float32), _variables(loc_model),
        Classifier(backbone_name="resnet18", dtype=jnp.float32), _variables(cls_model),
        config=StudyPipelineConfig(crop_mode=mode, **CONFIG))
    studies = _studies(2, 0)
    got = pipe.run([tpipe.StudyInput(**s) for s in studies])
    want = ref.run([StudyInput(**s) for s in studies])
    for g, w in zip(got, want, strict=True):
        assert g.study_id == w.study_id
        np.testing.assert_allclose(g.coords, w.coords, atol=1e-4)
        np.testing.assert_allclose(g.angles, w.angles, atol=1e-2)
        diff = np.abs(g.crops.astype(int) - w.crops.astype(int))
        # Stated as in test_torch_pipeline.py: <= 1 level on <= 1% of pixels.
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01
        assert set(g.logits) == set(w.logits)
        for k in w.logits:
            np.testing.assert_allclose(g.logits[k], w.logits[k], atol=5e-3, err_msg=k)
            np.testing.assert_allclose(g.probabilities[k], w.probabilities[k], atol=5e-3)
            np.testing.assert_array_equal(g.predictions[k], w.predictions[k])

    # The trainers' in-memory models in a pipeline of their own: bit for bit.
    mem = tpipe.StudyInferencePipeline(loc_model, cls_model, config=cfg, device="cpu")
    for g, m in zip(got, mem.run([tpipe.StudyInput(**s) for s in studies]), strict=True):
        np.testing.assert_array_equal(g.coords, m.coords)
        np.testing.assert_array_equal(g.crops, m.crops)
        for k in m.logits:
            np.testing.assert_array_equal(g.logits[k], m.logits[k])


def test_from_checkpoints_loads_f32_masters_and_refuses_a_mesh(runs, loaded):
    root, loc_model, _ = runs
    pipe = tpipe.StudyInferencePipeline.from_checkpoints(
        root / "loc" / "best_model", root / "cls" / "best_model", loc_backbone="resnet18",
        config=tpipe.StudyPipelineConfig(**CONFIG), device="cpu")
    params = dict(pipe.loc_model.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    assert pipe.loc_model.backbone.dtype == torch.bfloat16  # computed in the default dtype
    for name, value in loc_model.state_dict().items():
        torch.testing.assert_close(pipe.loc_model.state_dict()[name], value, rtol=0, atol=0)
    assert len(pipe.tasks) == len(AVAILABLE_TASK_NAMES)
    # mesh=: both models replicated over the device list (two CPU entries),
    # 3 studies bucketed to 4 and split 2 + 2, against the one-device run:
    # the same rows in convolutions of another batch size (measured: coords
    # and crops equal, logits within 1e-6).
    meshed = tpipe.StudyInferencePipeline.from_checkpoints(
        root / "loc" / "best_model", root / "cls" / "best_model", loc_backbone="resnet18",
        config=tpipe.StudyPipelineConfig(**CONFIG), dtype=torch.float32,
        mesh=data_parallel_mesh(["cpu", "cpu"]))
    assert meshed.devices == (torch.device("cpu"),) * 2 and meshed.device.type == "cpu"
    studies = [tpipe.StudyInput(**s) for s in _studies(3, 4)]
    for g, w in zip(meshed.run(studies), loaded.run(studies), strict=True):
        np.testing.assert_allclose(g.coords, w.coords, atol=1e-6)
        np.testing.assert_array_equal(g.crops, w.crops)
        for k in w.logits:
            np.testing.assert_allclose(g.logits[k], w.logits[k], atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(g.predictions[k], w.predictions[k])
    # The classifier's checkpoint is not a regressor's: the keys it misses are named.
    with pytest.raises(RuntimeError, match="Missing key.*head_norm"):
        load_model_state(root / "cls" / "best_model", pipe.loc_model)
