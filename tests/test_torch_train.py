"""Port of the localization training path against the JAX package's.

Losses, augmentation, schedules, the optimizer, the loader's index stream and
one full train step get the same seeded numpy inputs on both sides; the
trainer runs one CPU epoch on a tiny in-memory set. The JAX ConvNeXt under
``use_pallas="hybrid"`` runs its Pallas kernels in interpret mode; the port,
on the CPU, runs the kernels' plain versions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spine_vision_torch.data.loader import DataLoader as TDataLoader
from spine_vision_torch.models.classifier import CoordinateRegressor as TRegressor
from spine_vision_torch.models.convert import export_flax_variables, random_flax_variables
from spine_vision_torch.ops import augment as taug
from spine_vision_torch.ops import losses as tlosses
from spine_vision_torch.ops.image import imagenet_normalize as t_normalize
from spine_vision_torch.train import schedules as tsched
from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer
from spine_vision_torch.train.state import TrainState as TState
from spine_vision_torch.train.steps import train_step as t_train_step
from spine_vision_tpu.data.loader import DataLoader as JDataLoader
from spine_vision_tpu.models import CoordinateRegressor, make_coordinate_loss_fn
from spine_vision_tpu.ops import augment as jaug
from spine_vision_tpu.ops import losses as jlosses
from spine_vision_tpu.ops.image import imagenet_normalize as j_normalize
from spine_vision_tpu.train import schedules as jsched
from spine_vision_tpu.train.state import TrainState as JState
from spine_vision_tpu.train.steps import make_train_step


def _j(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("loss_type", ["mse", "smooth_l1", "huber"])
@pytest.mark.parametrize("mask_kind", ["none", "some", "all_masked"])
def test_coordinate_losses_match_jax(loss_type, mask_kind):
    rng = np.random.default_rng(0)
    pred = rng.uniform(size=(4, 5, 2)).astype(np.float32)
    target = (pred + rng.normal(size=pred.shape) * 0.3).astype(np.float32)
    mask = {
        "none": None,
        "some": (rng.uniform(size=(4, 5)) > 0.4).astype(np.float32),
        "all_masked": np.zeros((4, 5), np.float32),
    }[mask_kind]
    want = jlosses.masked_coordinate_loss(
        jnp.asarray(pred), jnp.asarray(target), None if mask is None else jnp.asarray(mask),
        loss_type,
    )
    got = tlosses.masked_coordinate_loss(
        torch.from_numpy(pred), torch.from_numpy(target),
        None if mask is None else torch.from_numpy(mask), loss_type,
    )
    # f32 sums of 40 terms: 1e-6.
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    if mask_kind == "all_masked":
        assert got.item() == 0.0


@pytest.mark.parametrize("name", ["bce", "bce_pos_weight", "focal", "softmax_ce"])
def test_classification_losses_match_jax(name):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(6, 4)) * 3).astype(np.float32)
    targets = (rng.uniform(size=(6, 4)) > 0.5).astype(np.float32)
    labels = rng.integers(0, 4, size=(6,))
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    jl, jt = jnp.asarray(logits), jnp.asarray(targets)
    if name == "bce":
        got, want = tlosses.binary_cross_entropy_with_logits(tl, tt), \
            jlosses.binary_cross_entropy_with_logits(jl, jt)
    elif name == "bce_pos_weight":
        got, want = tlosses.binary_cross_entropy_with_logits(tl, tt, 2.5), \
            jlosses.binary_cross_entropy_with_logits(jl, jt, 2.5)
    elif name == "focal":
        got = tlosses.focal_loss_with_logits(tl, tt, gamma=2.0, alpha=0.25, reduction="none")
        want = jlosses.focal_loss_with_logits(jl, jt, gamma=2.0, alpha=0.25, reduction="none")
    else:
        got = tlosses.softmax_cross_entropy(tl, torch.from_numpy(labels), label_smoothing=0.1)
        want = jlosses.softmax_cross_entropy(jl, jnp.asarray(labels), label_smoothing=0.1)
    # f32 log-sigmoid / log-softmax of two libraries: 1e-5.
    np.testing.assert_allclose(got.numpy(), _j(want), atol=1e-5)


@pytest.mark.parametrize("hw", [(24, 24), (20, 28)])
def test_augment_matches_jax_on_the_same_draws(hw):
    rng = np.random.default_rng(2)
    b = 3
    images = rng.uniform(size=(b, *hw, 3)).astype(np.float32)
    coords = rng.uniform(0.2, 0.8, size=(b, 5, 2)).astype(np.float32)
    cfg = jaug.AugmentConfig()
    key = jax.random.PRNGKey(7)
    draws = jaug._affine_params(key, b, cfg)
    want_img, want_coords = jaug.augment_batch(key, jnp.asarray(images), jnp.asarray(coords), cfg)
    p = taug.AffineParams(*(torch.from_numpy(np.array(d)) for d in draws))
    got_img, got_coords = taug.augment_with(
        torch.from_numpy(images), torch.from_numpy(coords), p, taug.AugmentConfig()
    )
    # Bilinear weights from f32 coordinates computed in another order: 1e-4
    # on values in [0, 1]; the coordinate map: 1e-5.
    np.testing.assert_allclose(got_img.numpy(), _j(want_img), atol=1e-4)
    np.testing.assert_allclose(got_coords.numpy(), _j(want_coords), atol=1e-5)


def test_augment_draws_lie_in_their_ranges():
    gen = torch.Generator().manual_seed(0)
    cfg = taug.AugmentConfig()
    p = taug.affine_params(gen, 4096, cfg, "cpu")
    deg = p.theta * 180 / np.pi
    assert deg.abs().max() <= cfg.degrees and p.tx.abs().max() <= cfg.translate
    assert cfg.scale_min <= p.scale.min() and p.scale.max() <= cfg.scale_max
    assert 0.45 < p.flip.float().mean() < 0.55  # hflip_prob 0.5
    images, coords = taug.augment_batch(
        gen, torch.rand(2, 16, 16, 3, generator=gen), torch.rand(2, 5, 2, generator=gen), cfg
    )
    assert images.shape == (2, 16, 16, 3) and 0 <= images.min() and images.max() <= 1
    assert coords.shape == (2, 5, 2)


@pytest.mark.parametrize(
    "kind,warmup", [("cosine", 0), ("cosine", 2), ("step", 0), ("plateau", 0), ("none", 0)]
)
def test_schedules_match_optax(kind, warmup):
    args = dict(scheduler_type=kind, learning_rate=3e-4, total_steps=50, steps_per_epoch=5,
                warmup_epochs=warmup, scheduler_step_size=3, scheduler_gamma=0.5)
    want = jsched.build_lr_schedule(**args)
    got = tsched.build_lr_schedule(**args)
    for count in (0, 1, 4, 9, 10, 11, 23, 37, 49, 50, 60):
        ref = float(want(count)) if callable(want) else float(want)
        # optax evaluates in f32: rel 1e-5.
        assert got(count) == pytest.approx(ref, rel=1e-5, abs=1e-12), count


@pytest.mark.parametrize("clip", [0.05, 100.0])  # clipping on, clipping off
def test_adamw_with_clipping_matches_optax(clip):
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (5,), (3, 3, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes] for _ in range(3)]
    lr, wd = 1e-2, 1e-2
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(lr, weight_decay=wd))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = tsched.build_optimizer(tp, lr, wd)
    for step_grads in grads:
        updates, opt_state = tx.update([jnp.asarray(g) for g in step_grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g.copy())
        tsched.clip_by_global_norm([p.grad for p in tp], clip)
        opt.step()
    for a, b in zip(tp, jp):
        # Three f32 Adam updates of size ~lr: 1e-6.
        np.testing.assert_allclose(a.detach().numpy(), _j(b), atol=1e-6)


class _Ints:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray([i])}


@pytest.mark.parametrize("shuffle,n,batch", [(True, 23, 4), (False, 23, 4), (True, 8, 8)])
def test_loader_index_stream_matches_jax(shuffle, n, batch):
    kw = dict(batch_size=batch, shuffle=shuffle, seed=5, num_workers=2)
    port = TDataLoader(_Ints(n), **kw)
    ref = JDataLoader(_Ints(n), process_index=0, process_count=1, **kw)
    assert len(port) == len(ref) and port.drop_last == ref.drop_last == shuffle
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = [b["i"].ravel().tolist() for b in port]
        want = [b["i"].ravel().tolist() for b in ref]
        assert got == want


def _batch(rng, n, hw):
    return {
        "image": rng.integers(0, 256, size=(n, hw, hw, 3), dtype=np.uint8),
        "coords": rng.uniform(0.1, 0.9, size=(n, 5, 2)).astype(np.float32),
        "mask": (rng.uniform(size=(n, 5)) > 0.2).astype(np.float32),
    }


def check_one_train_step_against_jax(use_pallas):
    """convnext_tiny CoordinateRegressor, f32, 32^2, dropout 0, no
    augmentation, the given ``use_pallas`` on both sides, the same weights
    and batch: the loss, every clipped gradient, and every parameter after
    one clipped AdamW step."""
    lr, wd, clip = 1e-3, 1e-5, 1.0
    port = TRegressor("convnext_tiny", dtype=torch.float32, device="cpu", dropout=0.0,
                      use_pallas=use_pallas, param_dtype=torch.float32)
    params, _ = random_flax_variables(port, seed=11)
    from spine_vision_torch.models.convert import load_flax_variables

    load_flax_variables(port, params)
    batch = _batch(np.random.default_rng(12), 2, 32)

    ref = CoordinateRegressor(backbone_name="convnext_tiny", dtype=jnp.float32,
                              use_pallas=use_pallas, dropout=0.0)
    coord_loss = make_coordinate_loss_fn("smooth_l1")

    def j_pre(b, key, train):
        return {**b, "image": j_normalize(b["image"].astype(jnp.float32) / 255.0)}

    step = make_train_step(
        ref.apply, lambda out, b: coord_loss(out, b["coords"], b["mask"]),
        has_batch_stats=False, preprocess=j_pre,
    )
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(lr, weight_decay=wd))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def j_loss(p):
        b = j_pre(jbatch, None, True)
        out = ref.apply({"params": p}, b["image"], train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        return coord_loss(out, b["coords"], b["mask"])

    jgrads, _ = optax.clip_by_global_norm(clip).update(jax.grad(j_loss)(jparams), None)
    jstate = JState.create(params=jparams, tx=tx)
    jstate, jloss = step(jstate, jbatch)

    def t_pre(b, gen, train):
        return {**b, "image": t_normalize(b["image"].float() / 255.0)}

    state = TState(
        model=port, optimizer=tsched.build_optimizer(port.parameters(), lr, wd),
        schedule=lambda count: lr, generator=torch.Generator().manual_seed(0), grad_clip=clip,
    )
    tloss = t_train_step(
        state, batch, lambda out, b: tlosses.masked_coordinate_loss(out, b["coords"], b["mask"]),
        t_pre,
    )
    # f32 forward through 18 blocks, sums in another order: rtol 1e-5.
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert state.step == 1

    def flat(tree):
        return dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(_j, tree))[0])

    got_g, want_g = flat(export_flax_variables(port, grads=True)[0]), flat(jgrads)
    assert got_g.keys() == want_g.keys()
    for path, w in want_g.items():
        # f32 gradients through 18 blocks, sums in another order: each
        # parameter's gradient within 1e-4 of its norm.
        err = np.linalg.norm(got_g[path] - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= 1e-4, (path, err)
    got, want = flat(export_flax_variables(port)[0]), flat(jstate.params)
    for path, w in want.items():
        # The first Adam update is about lr * g / |g|: it amplifies the
        # relative error of a gradient element near 0. A tenth of lr.
        np.testing.assert_allclose(got[path], w, atol=0.1 * lr, err_msg=str(path))


def test_one_train_step_matches_jax():
    """The hybrid block (``use_pallas="hybrid"``) on both sides."""
    check_one_train_step_against_jax("hybrid")


class _Set:
    """In-memory localization samples: uint8 images, coords, masks."""

    def __init__(self, n, hw, seed):
        rng = np.random.default_rng(seed)
        b = _batch(rng, n, hw)
        self.images, self.coords, self.mask = b["image"], b["coords"], b["mask"]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "coords": self.coords[i], "mask": self.mask[i],
                "series_type_idx": 0, "metadata": {"image_path": f"{i}.png"}}


def test_cpu_trainer_epoch_layout_reload_and_resume(tmp_path):
    run = tmp_path / "run"
    cfg = LocalizationConfig(backbone="convnext_tiny", image_size=(32, 32), batch_size=4,
                             num_epochs=1, output_path=run, num_workers=2, seed=0,
                             pretrained=False)
    trainer = LocalizationTrainer(cfg, train_dataset=_Set(8, 32, 0),
                                  val_dataset=_Set(5, 32, 1), device="cpu")
    result = trainer.train()
    assert (run / "best_model" / "state.pt").exists()
    assert (run / "best_model.meta.json").exists()
    assert (run / "config.yaml").exists() and (run / "logs").is_dir()
    assert "backbone: \"convnext_tiny\"" in (run / "config.yaml").read_text()
    history = result.history
    for key in ("train_loss", "val_loss", "lr", "med", "pck@0.05", "med_L1/L2"):
        assert len(history[key]) == 1 and np.isfinite(history[key][0]), key
    assert result.best_metric == history["med"][0]
    meta = json.loads((run / "best_model.meta.json").read_text())
    assert meta["epoch"] == 0 and meta["config"]["backbone"] == "convnext_tiny"
    # The best model was reloaded: the weights are those saved.
    saved = torch.load(run / "best_model" / "state.pt", weights_only=True)["model"]
    for name, value in trainer.model.state_dict().items():
        torch.testing.assert_close(value, saved[name], rtol=0, atol=0)
    assert trainer.state.step == 2

    # Resume from the checkpoint: the second epoch only.
    cfg2 = LocalizationConfig(backbone="convnext_tiny", image_size=(32, 32), batch_size=4,
                              num_epochs=2, output_path=tmp_path / "run2", num_workers=2,
                              seed=0, pretrained=False, checkpoint_path=run / "best_model")
    trainer2 = LocalizationTrainer(cfg2, train_dataset=_Set(8, 32, 0),
                                   val_dataset=_Set(5, 32, 1), device="cpu")
    result2 = trainer2.train()
    assert len(result2.history["train_loss"]) == 2
    assert result2.history["train_loss"][0] == history["train_loss"][0]
    assert trainer2.state.step == 4


def test_resnet18_regressor_trains_with_a_frozen_then_unfrozen_backbone(tmp_path):
    """A ResNet-18 CoordinateRegressor (training BatchNorm) for 2 epochs, the
    backbone frozen in the first: its weights stay while its running
    statistics move, then it trains."""
    cfg = LocalizationConfig(backbone="resnet18", image_size=(32, 32), batch_size=4,
                             num_epochs=2, output_path=tmp_path / "r18", num_workers=2, seed=0,
                             pretrained=False, freeze_backbone_epochs=1)
    trainer = LocalizationTrainer(cfg, train_dataset=_Set(8, 32, 0), val_dataset=_Set(4, 32, 1),
                                  device="cpu")
    backbone = trainer.model.backbone
    weights0 = {n: p.detach().clone() for n, p in backbone.named_parameters()}
    mean0 = backbone.stem_bn.mean.clone()
    after_first = {}
    trainer.on_epoch_end = lambda epoch, metrics: after_first or after_first.update(
        {n: p.detach().clone() for n, p in backbone.named_parameters()})
    result = trainer.train()
    assert all(np.isfinite(result.history["med"]))
    for n, value in after_first.items():
        assert torch.equal(value, weights0[n]), n
    assert not torch.equal(backbone.stem_bn.mean, mean0)
    assert not trainer._frozen
    state = torch.load(tmp_path / "r18" / "best_model" / "state.pt", weights_only=True)
    if result.best_epoch == 1:
        assert not torch.equal(state["model"]["backbone.stem_conv.weight"],
                               weights0["stem_conv.weight"])


@pytest.mark.parametrize(
    "overrides",
    # freeze_backbone_epochs and ResNet-18 train since training BatchNorm
    # was ported; a bottleneck ResNet and the scatter-free pool train since
    # the backbone zoo was ported. profile_trace, sample_cache_dir and the
    # zoo's cases check that the option works.
    [{"backbone": "resnet50"}, {"visualize_predictions": True},
     {"profile_trace": True}, {"sample_cache_dir": "cache"},
     {"backbone": "resnet18", "pool_impl": "tpu"}],
)
def test_unported_options_name_the_roadmap(tmp_path, overrides):
    zoo = overrides.get("backbone") == "resnet50" or "pool_impl" in overrides
    ported = {"profile_trace", "sample_cache_dir"} & set(overrides) or zoo
    # The ported options train a ResNet-18, a few seconds on a busy CPU.
    kw = {"backbone": "resnet18" if ported else "convnext_tiny", **overrides}
    if zoo:
        kw["mixed_precision"] = False  # f32: bf16 convolutions are slow on the CPU
    if "sample_cache_dir" in kw:
        kw["sample_cache_dir"] = tmp_path / kw["sample_cache_dir"]
    cfg = LocalizationConfig(output_path=tmp_path / "r", pretrained=False,
                             image_size=(32, 32), batch_size=2, num_epochs=1, num_workers=2,
                             seed=0, **kw)
    if not ported:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LocalizationTrainer(cfg, train_dataset=_Set(4, 32, 0), val_dataset=_Set(2, 32, 1),
                                device="cpu")
        return
    train_set, val_set = _Set(4, 32, 0), _Set(2, 32, 1)
    trainer = LocalizationTrainer(cfg, train_dataset=train_set, val_dataset=val_set,
                                  device="cpu")
    result = trainer.train()
    assert all(np.isfinite(result.history["train_loss"]))
    if zoo:
        assert trainer.model.backbone.pool_impl == overrides.get("pool_impl", "flax")
        assert type(trainer.model.backbone.stage1_block1).__name__ == (
            "BottleneckBlock" if kw["backbone"] == "resnet50" else "BasicBlock")
        return
    if "profile_trace" in overrides:
        trace = json.loads((tmp_path / "r" / "logs" / "profile" / "trace.json").read_text())
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any(n.startswith("aten::") for n in names)  # the epoch's operators
        return
    # The cache: packed once, its samples those of the dataset; a second
    # trainer with the same seed reuses it.
    for split, source in (("train", train_set), ("val", val_set)):
        assert (tmp_path / "cache" / split / "index.json").exists()
    assert type(trainer.train_dataset).__name__ == "PackedDataset"
    for i in range(len(train_set)):
        got, want = trainer.train_dataset[i], train_set[i]
        for key in ("image", "coords", "mask"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["metadata"] == want["metadata"]
    stamp = (tmp_path / "cache" / "train" / "image.npy").stat().st_mtime_ns
    again = LocalizationTrainer(cfg, train_dataset=_Set(4, 32, 0), val_dataset=_Set(2, 32, 1),
                                device="cpu")
    assert type(again.train_dataset).__name__ == "PackedDataset"
    assert (tmp_path / "cache" / "train" / "image.npy").stat().st_mtime_ns == stamp


@pytest.mark.parametrize("skip_first", [0, 1, 3])
def test_step_timer_summary_matches_jax(monkeypatch, skip_first):
    """``utils/profiling.py::StepTimer`` (the trainer's ``profile_steps``)
    against the JAX package's on the same clock readings."""
    import time

    from spine_vision_torch.utils import profiling as tprof
    from spine_vision_tpu.utils import profiling as jprof

    ticks = np.cumsum(np.random.default_rng(skip_first).uniform(0.01, 0.2, 24)).tolist()
    summaries = []
    for timer in (tprof.StepTimer(), jprof.StepTimer()):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        for _ in range(12):
            with timer.measure():
                pass
        monkeypatch.undo()
        assert len(timer) == 12
        summaries.append(timer.summary(skip_first=skip_first))
    assert summaries[0] == summaries[1] and summaries[0]["steps"] == 12 - skip_first
    empty = tprof.StepTimer()
    assert empty.summary() == jprof.StepTimer().summary() == {}
