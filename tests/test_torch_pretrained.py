"""Pretrained backbones in the port (``models/convert.py``, ``pretrained_path``).

Seeded state dicts under torchvision's ResNet-18 names and ConvNeXt-tiny's
two namings (facebookresearch's and timm's) convert to the JAX package's
trees leaf for leaf; the ``.npz`` artifact of either package loads in the
other; the port's models on the converted weights give the JAX models'
outputs; and ``pretrained_path`` starts a trainer from the weights, which
training then moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.models import classifier as tcls
from spine_vision_torch.models import convert as tconv
from spine_vision_torch.models.convnext import ConvNeXt, ConvNeXtConfig
from spine_vision_torch.train.classification import ClassificationConfig, ClassificationTrainer
from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer
from spine_vision_tpu.models import Classifier
from spine_vision_tpu.models import convert as jconv

CONVNEXT_TINY = ((3, 3, 9, 3), (96, 192, 384, 768))
# A ConvNeXt of ConvNeXt-tiny's layout at a few channels, so the tests keep
# to seconds on a busy CPU: the converters and the .npz do not depend on the
# widths, and a regressor built on it stands for a ConvNeXt-tiny one.
CONVNEXT_SMALL = ((1, 1, 2, 1), (8, 16, 24, 32))


def resnet18_state_dict(seed: int) -> dict[str, torch.Tensor]:
    """torchvision's ``resnet18().state_dict()`` names and shapes, seeded."""
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}

    def rand(*shape, scale=0.05):
        return torch.randn(*shape, generator=g) * scale

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = 1 + rand(c)
        sd[f"{prefix}.bias"] = rand(c)
        sd[f"{prefix}.running_mean"] = rand(c)
        sd[f"{prefix}.running_var"] = 1 + rand(c).abs()
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)

    sd["conv1.weight"] = rand(64, 3, 7, 7)
    bn("bn1", 64)
    cin = 64
    for s, c in enumerate((64, 128, 256, 512)):
        for b in range(2):
            p = f"layer{s + 1}.{b}"
            sd[f"{p}.conv1.weight"] = rand(c, cin if b == 0 else c, 3, 3)
            bn(f"{p}.bn1", c)
            sd[f"{p}.conv2.weight"] = rand(c, c, 3, 3)
            bn(f"{p}.bn2", c)
            if b == 0 and s > 0:
                sd[f"{p}.downsample.0.weight"] = rand(c, cin, 1, 1)
                bn(f"{p}.downsample.1", c)
        cin = c
    sd["fc.weight"], sd["fc.bias"] = rand(1000, 512), rand(1000)
    return sd


def convnext_state_dict(seed: int, naming: str, depths=CONVNEXT_TINY[0],
                        dims=CONVNEXT_TINY[1]) -> dict[str, torch.Tensor]:
    """A ConvNeXt v1 state dict under facebookresearch's (``"fb"``) or
    timm's (``"timm"``) names, seeded."""
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}

    def rand(*shape, scale=0.05, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    def ln(prefix, c):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = rand(c, shift=1.0), rand(c)

    timm = naming == "timm"
    stem = "stem" if timm else "downsample_layers.0"
    sd[f"{stem}.0.weight"], sd[f"{stem}.0.bias"] = rand(dims[0], 3, 4, 4), rand(dims[0])
    ln(f"{stem}.1", dims[0])
    for s, (depth, c) in enumerate(zip(depths, dims)):
        if s > 0:
            down = f"stages.{s}.downsample" if timm else f"downsample_layers.{s}"
            ln(f"{down}.0", dims[s - 1])
            sd[f"{down}.1.weight"], sd[f"{down}.1.bias"] = rand(c, dims[s - 1], 2, 2), rand(c)
        for b in range(depth):
            p = f"stages.{s}.blocks.{b}" if timm else f"stages.{s}.{b}"
            dw, fc1, fc2 = ("conv_dw", "mlp.fc1", "mlp.fc2") if timm else \
                ("dwconv", "pwconv1", "pwconv2")
            sd[f"{p}.{dw}.weight"], sd[f"{p}.{dw}.bias"] = rand(c, 1, 7, 7, scale=0.1), rand(c)
            ln(f"{p}.norm", c)
            sd[f"{p}.{fc1}.weight"], sd[f"{p}.{fc1}.bias"] = rand(4 * c, c), rand(4 * c)
            sd[f"{p}.{fc2}.weight"], sd[f"{p}.{fc2}.bias"] = rand(c, 4 * c), rand(c)
            sd[f"{p}.gamma"] = rand(c, scale=0.02, shift=0.1)
    head = "head.norm" if timm else "norm"
    ln(head, dims[-1])
    fc = "head.fc" if timm else "head"
    sd[f"{fc}.weight"], sd[f"{fc}.bias"] = rand(1000, dims[-1]), rand(1000)
    return sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch,naming", [("resnet18", None), ("convnext_tiny", "fb"),
                                         ("convnext_tiny", "timm")])
def test_converted_trees_equal_the_jax_package_leaf_for_leaf(tmp_path, arch, naming):
    sd = resnet18_state_dict(0) if naming is None else \
        convnext_state_dict(1, naming, *CONVNEXT_SMALL)
    torch.save(sd, tmp_path / "w.pth")
    got = tconv.load_torch_backbone(tmp_path / "w.pth", arch)
    want = jconv.load_torch_backbone(tmp_path / "w.pth", arch)
    for g, w in zip(got, want, strict=True):
        _assert_trees_equal(g, w)
    if naming is None:
        _assert_trees_equal(tconv.convert_resnet_state_dict(sd)[0],
                            jconv.convert_resnet_state_dict(sd)[0])
    else:
        _assert_trees_equal(tconv.convert_convnext_state_dict(sd),
                            jconv.convert_convnext_state_dict(sd))
        assert tconv._normalize_convnext_keys(sd) == jconv._normalize_convnext_keys(sd)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_artifact_of_either_package_loads_in_the_other(tmp_path, writer):
    torch.save(convnext_state_dict(2, "timm", *CONVNEXT_SMALL), tmp_path / "w.pth")
    write, read = (jconv, tconv) if writer == "jax" else (tconv, jconv)
    write.convert_checkpoint(tmp_path / "w.pth", "convnext_tiny", tmp_path / "w.npz")
    got = read.load_backbone_npz(tmp_path / "w.npz")
    want = write.load_backbone_npz(tmp_path / "w.npz")
    assert got[2] == want[2] == "convnext_tiny"
    for g, w in zip(got[:2], want[:2], strict=True):
        _assert_trees_equal(g, w)
    params, stats = read.load_pretrained_backbone(tmp_path / "w.npz", "convnext_tiny")
    _assert_trees_equal(params, want[0])
    assert stats == {}


def _small_convnext_regressor(monkeypatch) -> tcls.CoordinateRegressor:
    """A regressor on a ConvNeXt of ``CONVNEXT_SMALL``'s layout (the factory
    is bypassed: it builds the registered sizes only)."""
    def small(name, dtype, device, generator, **kw):
        cfg = ConvNeXtConfig(*CONVNEXT_SMALL)
        return ConvNeXt(cfg, dtype=dtype, device=device, generator=generator), cfg.dims[-1]

    monkeypatch.setattr(tcls, "create_backbone", small)
    return tcls.CoordinateRegressor("convnext_tiny", dtype=torch.float32, device="cpu",
                                    generator=torch.Generator().manual_seed(0))


def _loc_config(tmp_path, name, path):
    return LocalizationConfig(backbone="convnext_tiny", image_size=(32, 32), batch_size=4,
                              num_epochs=1, learning_rate=1e-3, pretrained=False,
                              output_path=tmp_path / name, pretrained_path=path,
                              num_workers=2, seed=0)


def test_arch_mismatch_and_unported_families_raise(tmp_path, monkeypatch):
    sd = resnet18_state_dict(3)
    torch.save(sd, tmp_path / "r18.pth")
    params, stats = tconv.convert_resnet_state_dict({k: v[:1] if v.ndim else v
                                                     for k, v in sd.items()})
    tconv.save_backbone_npz(params, stats, tmp_path / "r18.npz", arch="resnet18")
    with pytest.raises(ValueError, match="converted for 'resnet18', not 'convnext_tiny'"):
        tconv.load_pretrained_backbone(tmp_path / "r18.npz", "convnext_tiny")
    # Every family converts since the backbone zoo was ported: a ResNet
    # checkpoint named as a ViT leaves the ViT converter empty-handed.
    with pytest.raises(ValueError, match="ViT conversion consumed no tensors"):
        tconv.load_torch_backbone(tmp_path / "r18.pth", "vit_tiny")
    with pytest.raises(ValueError, match="No converter"):
        tconv.load_torch_backbone(tmp_path / "r18.pth", "alexnet")
    cfg = _loc_config(tmp_path, "a", tmp_path / "r18.npz")
    with pytest.raises(ValueError, match="converted for 'resnet18', not 'convnext_tiny'"):
        LocalizationTrainer(cfg, model=_small_convnext_regressor(monkeypatch), train_dataset=_Loc(2),
                            val_dataset=_Loc(2), device="cpu")
    # A leaf short: the leaf-by-leaf check refuses the weights.
    short = convnext_state_dict(4, "timm", *CONVNEXT_SMALL)
    del short["stages.3.blocks.0.mlp.fc2.weight"]
    torch.save(short, tmp_path / "short.pth")
    cfg = _loc_config(tmp_path, "b", tmp_path / "short.pth")
    with pytest.raises(KeyError, match="stage4_block1/pwconv2/kernel missing"):
        LocalizationTrainer(cfg, model=_small_convnext_regressor(monkeypatch), train_dataset=_Loc(2),
                            val_dataset=_Loc(2), device="cpu")


def test_classifier_on_converted_weights_matches_jax(tmp_path):
    """f32 forwards of one model in two libraries: 1e-4 on the logits, as
    ``test_torch_models.py`` states for f32. (ConvNeXt's converted layout is
    the one ``test_torch_models.py`` carries; its conversion is held leaf
    for leaf above.)"""
    arch = "resnet18"
    torch.save(resnet18_state_dict(4), tmp_path / "w.pth")
    backbone, stats = tconv.load_pretrained_backbone(tmp_path / "w.pth", arch)
    port = tcls.Classifier(arch, dtype=torch.float32, device="cpu")
    params, _ = tconv.random_flax_variables(port, 6)  # the heads
    params["backbone"] = backbone
    batch_stats = {"backbone": stats} if stats else {}
    tconv.load_flax_variables(port, params, batch_stats)
    ref = Classifier(backbone_name=arch, dtype=jnp.float32, use_pallas=False)
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = {"params": params, **({"batch_stats": batch_stats} if stats else {})}
    want = jax.jit(lambda v, x: ref.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for name, logits in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(logits), atol=1e-4,
                                   err_msg=name)


class _Loc:
    def __init__(self, n):
        rng = np.random.default_rng(n)
        self.images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        self.coords = rng.uniform(0.2, 0.8, (n, 5, 2)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "coords": self.coords[i],
                "mask": np.ones(5, np.float32), "series_type_idx": 0, "metadata": {}}


class _Cls:
    def __init__(self, n):
        self.images = np.random.default_rng(n).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "targets": {"pfirrmann": np.int32(i % 5)},
                "level_idx": i % 5, "metadata": {}}


@pytest.mark.parametrize("case", ["convnext_timm_npz_localization",
                                  "resnet18_pth_classification"])
def test_pretrained_path_starts_training_from_the_weights(tmp_path, monkeypatch, case):
    """The counterpart of ``tests/test_pretrained_e2e.py``'s chain: the
    backbone equals the converted weights (and BatchNorm statistics) when the
    trainer is built, and training moves them. Localization goes through the
    ``.npz`` artifact of timm-named weights, classification converts a
    torchvision-named ``.pth`` on the fly."""
    if case.startswith("convnext"):
        torch.save(convnext_state_dict(9, "timm", *CONVNEXT_SMALL), tmp_path / "w.pth")
        path = tconv.convert_checkpoint(tmp_path / "w.pth", "convnext_tiny", tmp_path / "w.npz")
        trainer = LocalizationTrainer(_loc_config(tmp_path, "run", path),
                                      model=_small_convnext_regressor(monkeypatch), train_dataset=_Loc(8),
                                      val_dataset=_Loc(4), device="cpu")
        arch = "convnext_tiny"
    else:
        torch.save(resnet18_state_dict(8), tmp_path / "w.pth")
        path = tmp_path / "w.pth"
        cfg = ClassificationConfig(
            backbone="resnet18", target_labels=["pfirrmann"], output_size=(32, 32),
            batch_size=4, num_epochs=1, learning_rate=1e-3, use_weighted_sampling=False,
            pretrained=False, output_path=tmp_path / "run", pretrained_path=path,
            num_workers=2, seed=0)
        trainer = ClassificationTrainer(cfg, train_dataset=_Cls(8), val_dataset=_Cls(4),
                                        device="cpu")
        arch = "resnet18"
    want_params, want_stats = tconv.load_pretrained_backbone(path, arch)
    params, stats = tconv.export_flax_variables(trainer.model.backbone)
    _assert_trees_equal(params, want_params)
    _assert_trees_equal(stats, want_stats)
    trainer.train()
    assert np.isfinite(trainer.history["train_loss"][-1])
    after, _ = tconv.export_flax_variables(trainer.model.backbone)
    assert not np.allclose(after["stem_conv"]["kernel"], want_params["stem_conv"]["kernel"])
