"""The port's ``parallel/mesh.py``, the loader's process slicing and the
pipelines over a device list, in one process on the CPU.

Single-process counterparts of ``tests/test_parallel.py`` (``pad_to_multiple``
against the JAX function, ``make_mesh``'s refusals, ``initialize_distributed``
as a no-op); the loader's per-rank batches against the JAX ``DataLoader``'s
with the same ``process_index``/``process_count``; and the study and crop
pipelines over two CPU entries against the JAX pipeline on a 2-device CPU
mesh and against the port's ``mesh=None`` run.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from spine_vision_torch.data.loader import DataLoader as TDataLoader
from spine_vision_torch.infer import pipeline as tpipe
from spine_vision_torch.models import classifier as tcls
from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
from spine_vision_torch.parallel import (
    data_parallel_mesh,
    initialize_distributed,
    is_main_process,
    make_mesh,
    pad_to_multiple,
)
from spine_vision_tpu.data.loader import DataLoader as JDataLoader
from spine_vision_tpu.infer import StudyInferencePipeline, StudyInput, StudyPipelineConfig
from spine_vision_tpu.models import Classifier, CoordinateRegressor
from spine_vision_tpu.parallel import pad_to_multiple as j_pad_to_multiple

CPU2 = ("cpu", "cpu")
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as the suite's other processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,multiple", [(5, 8), (5, 5), (7, 2), (1, 4), (0, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    rng = np.random.default_rng(n)
    batch = {"x": rng.normal(size=(n, 3)).astype(np.float32),
             "t": {"a": np.arange(n, dtype=np.int32)}}
    got, got_n = pad_to_multiple(batch, multiple)
    want, want_n = j_pad_to_multiple(batch, multiple)
    assert got_n == want_n
    np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))
    np.testing.assert_array_equal(got["t"]["a"], np.asarray(want["t"]["a"]))
    assert pad_to_multiple({}, 4) == ({}, 0)


def test_make_mesh_raises_on_insufficient_devices():
    with pytest.raises(ValueError, match="num_devices=3"):
        make_mesh(num_devices=3, devices=CPU2)
    with pytest.raises(ValueError, match="model_parallel=2"):
        make_mesh(model_parallel=2, device="cpu")


def test_make_mesh_without_a_group(monkeypatch):
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    # More than one device needs that many processes: torchrun's message.
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_mesh(num_devices=2, device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert mesh.num_devices == mesh.data_axis_size == 1 and mesh.is_main
    assert make_mesh(num_devices=1, devices=CPU2).device == torch.device("cpu")
    # A LOCAL_RANK beyond the visible devices raises; it never wraps around.
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(ValueError, match="LOCAL_RANK=2"):
        make_mesh(devices=CPU2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert make_mesh(devices=("cpu", "meta")).device == torch.device("meta")
    # One process: its batch on its device, replicas as they are.
    batch = mesh.shard_batch({"x": np.ones((2, 3), np.float32), "meta": ["a", "b"]})
    assert batch["x"].device.type == "cpu" and batch["meta"] == ["a", "b"]
    rep = mesh.replicate({"w": np.arange(3.0), "v": [torch.ones(2)]})
    np.testing.assert_array_equal(rep["w"].numpy(), np.arange(3.0))
    t = torch.tensor([1.0, 2.0])
    assert mesh.all_sum(t) is t and is_main_process()


def test_initialize_distributed_noop_single_process(monkeypatch):
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed() is False  # idempotent
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rank"):
        initialize_distributed()


def test_data_parallel_mesh_lists_devices(monkeypatch):
    assert data_parallel_mesh(CPU2) == (torch.device("cpu"),) * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        data_parallel_mesh()


class _Indexed:
    """Samples that carry their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.asarray(i, np.int64)}


def _batches(loader):
    return [(b["idx"].tolist(), b.get("_n_valid"), b.get("_n_valid_global")) for b in loader]


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n", [32, 27])
@pytest.mark.parametrize("weighted", [False, True])
def test_loader_process_slices_match_jax(count, shuffle, n, weighted):
    """Every rank's batches: the same indices, ``_n_valid``,
    ``_n_valid_global`` and length as the JAX loader's."""
    weights = np.random.default_rng(n).uniform(0.1, 1.0, n) if weighted else None
    ranks = []
    for rank in range(count):
        kw = dict(batch_size=8, shuffle=shuffle, drop_last=False, seed=5,
                  sample_weights=weights, num_workers=1, process_index=rank,
                  process_count=count)
        got, want = TDataLoader(_Indexed(n), **kw), JDataLoader(_Indexed(n), **kw)
        got.set_epoch(1)
        want.set_epoch(1)
        assert len(got) == len(want) == -(-n // 8)
        ranks.append(_batches(got))
        assert ranks[-1] == _batches(want), rank
    # Each global batch is the ranks' slices in rank order, the trailing one
    # padded by repeating its last index.
    full = TDataLoader(_Indexed(n), batch_size=8, shuffle=shuffle, drop_last=False, seed=5,
                       sample_weights=weights, num_workers=1, process_index=0, process_count=1)
    full.set_epoch(1)
    for i, (idx, _, _) in enumerate(_batches(full)):
        joined = [j for r in ranks for j in r[i][0]]
        assert joined[: len(idx)] == idx and set(joined[len(idx):]) <= {idx[-1]}
    with pytest.raises(ValueError, match="process_count=3"):
        TDataLoader(_Indexed(n), batch_size=8, process_index=0, process_count=3)


# ---------------------------------------------------------------------------
# The pipelines over a device list
# ---------------------------------------------------------------------------

_CONFIG = {"loc_image_size": (64, 64), "crop_size": (32, 32), "padded_hw": (128, 128)}


@pytest.fixture(scope="module")
def models():
    """The seeded f32 ResNet-18 regressor and classifier: modules on the meta
    device (no initial draws), every parameter and statistic from a seeded
    Flax-layout tree."""
    with torch.device("meta"):
        loc = tcls.CoordinateRegressor("resnet18", dtype=torch.float32, device="meta")
        cls = tcls.Classifier("resnet18", dtype=torch.float32, device="meta")
    loc, cls = loc.to_empty(device="cpu"), cls.to_empty(device="cpu")
    trees = []
    for model, seed in ((loc, 0), (cls, 1)):
        params, stats = random_flax_variables(model, seed)
        load_flax_variables(model, params, stats)
        trees.append({"params": params, "batch_stats": stats})
    return loc, cls, trees


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


def _check_close(got, want):
    """``test_torch_pipeline.py``'s bounds."""
    assert [g.study_id for g in got] == [w.study_id for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.coords, w.coords, atol=1e-4)
        np.testing.assert_allclose(g.angles, w.angles, atol=1e-2)
        diff = np.abs(g.crops.astype(int) - w.crops.astype(int))
        assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01
        for k in w.logits:
            np.testing.assert_allclose(g.logits[k], w.logits[k], atol=5e-3, err_msg=k)
            np.testing.assert_allclose(g.probabilities[k], w.probabilities[k], atol=5e-3)
            np.testing.assert_array_equal(g.predictions[k], w.predictions[k])


@pytest.mark.parametrize("mode", ["horizontal", "rotated"])
def test_study_pipeline_over_two_devices_matches_jax_mesh(models, mode):
    """3 studies, bucketed to 4 and split 2 + 2, against the port's
    ``mesh=None`` run; in the horizontal mode (the default) also against
    the JAX pipeline on a 2-device mesh (one JAX compile: the suite's time
    is the budget; ``test_torch_pipeline.py`` holds both modes to JAX
    without a mesh)."""
    loc, cls, (loc_vars, cls_vars) = models
    cfg = tpipe.StudyPipelineConfig(crop_mode=mode, **_CONFIG)
    pipe = tpipe.StudyInferencePipeline(loc, cls, config=cfg, mesh=data_parallel_mesh(CPU2))
    assert len(pipe.devices) == 2 and pipe._replicas[1][0] is not loc
    studies = _studies(3, 0)
    got = pipe.run([tpipe.StudyInput(**s) for s in studies])
    if mode == "horizontal":
        ref = StudyInferencePipeline(
            CoordinateRegressor(backbone_name="resnet18", dtype=jnp.float32), loc_vars,
            Classifier(backbone_name="resnet18", dtype=jnp.float32), cls_vars,
            config=StudyPipelineConfig(crop_mode=mode, **_CONFIG),
            mesh=Mesh(np.asarray(jax.devices()[:2]), ("data",)))
        _check_close(got, ref.run([StudyInput(**s) for s in studies]))

    single = tpipe.StudyInferencePipeline(loc, cls, config=cfg, device="cpu")
    plain = single.run([tpipe.StudyInput(**s) for s in studies])
    for g, p in zip(got, plain, strict=True):
        # Two batches of 2 against one of 4: the same rows in convolutions of
        # another batch size. Measured: coords and crops equal, logits within
        # 9e-7, probabilities within 2e-7.
        np.testing.assert_allclose(g.coords, p.coords, atol=1e-6)
        np.testing.assert_array_equal(g.crops, p.crops)
        for k in p.logits:
            np.testing.assert_allclose(g.logits[k], p.logits[k], atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(g.predictions[k], p.predictions[k])


def test_series_crop_pipeline_over_two_devices(models):
    """5 slices bucketed to 8, 4 a device: the crops of ``mesh=None``."""
    loc = models[0]
    cfg = tpipe.StudyPipelineConfig(**_CONFIG)
    rng = np.random.default_rng(3)
    slices = [rng.normal(100, 30, (int(rng.integers(64, 128)), 90)).astype(np.float32)
              for _ in range(5)]
    spacings = [(0.6, 0.5)] * 5
    for model in (loc, None):
        got = tpipe.SeriesCropPipeline(model, config=cfg, mesh=data_parallel_mesh(CPU2)).run(
            slices, spacings)
        want = tpipe.SeriesCropPipeline(model, config=cfg, device="cpu").run(slices, spacings)
        assert got[2].shape == (5, 5, 32, 32)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_array_equal(got[2], want[2])


class _Samples:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        self.coords = rng.uniform(0.2, 0.8, (n, 5, 2)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "coords": self.coords[i],
                "mask": np.ones(5, np.float32), "series_type_idx": 0, "metadata": {}}


def test_trainer_distributed_without_a_group_trains_single_process(models, tmp_path,
                                                                   monkeypatch):
    from spine_vision_torch.parallel import MeshContext
    from spine_vision_torch.train.classification import ClassificationTrainer
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    kw = dict(backbone="resnet18", image_size=(32, 32), batch_size=4, num_epochs=1,
              pretrained=False, mixed_precision=False, num_workers=1, seed=0)
    cfg = LocalizationConfig(output_path=tmp_path / "run", distributed=True, **kw)
    trainer = LocalizationTrainer(cfg, model=copy.deepcopy(models[0]), device="cpu",
                                  train_dataset=_Samples(4, 0), val_dataset=_Samples(4, 1))
    assert trainer.mesh_ctx.world_size == 1 and trainer.state.replica is None
    assert not torch.distributed.is_initialized()
    result = trainer.train()
    assert len(result.history["train_loss"]) == 1 and "med" in result.history
    assert (tmp_path / "run" / "best_model" / "state.pt").exists()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        LocalizationTrainer(LocalizationConfig(output_path=tmp_path / "two", num_devices=2, **kw),
                            train_dataset=_Samples(8, 0), val_dataset=[], device="cpu")
    # More than one process: evaluate() is single-controller only, as in JAX.
    trainer.mesh_ctx = MeshContext(world_size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="single-controller"):
        trainer.evaluate(_Samples(4, 2))
    cls = ClassificationTrainer.__new__(ClassificationTrainer)
    cls.mesh_ctx = trainer.mesh_ctx
    with pytest.raises(NotImplementedError, match="single-controller"):
        cls.evaluate([])
