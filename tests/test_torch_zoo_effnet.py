"""The port's EfficientNet v1/v2 and MobileNetV3 against the JAX package's.

Small configurations from each family's own dataclasses: an EfficientNet v1
(a ``dsconv`` stage and a 5x5 ``mbconv`` stage with SE, stride 2), a v2 (a
``fused`` stage with and without expansion, then an ``mbconv`` stage), and a
MobileNetV3 with ReLU and hard-swish blocks, SE with hard-sigmoid gates,
residual and strided blocks and the ``head_fc`` Dense after the pool. Each
runs in eval mode at f32 and bf16 and in training mode at f32 (the output
and the running statistics against JAX's ``mutable=["batch_stats"]``
apply), then one classification train step. The configuration tables of
the full-size names are compared field for field.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch
from torch_zoo_helpers import (
    carry,
    check_stats,
    check_step,
    forward_pair,
    images,
    rel_err,
    train_step_pair,
)

from spine_vision_torch.models import efficientnet as te
from spine_vision_tpu.models import efficientnet as je

V1 = (("dsconv", 1, 16, 1, 3, 1, 0.25), ("mbconv", 6, 24, 2, 5, 2, 0.25))
V2 = (("fused", 1, 16, 1, 3, 1), ("fused", 4, 24, 2, 3, 2), ("mbconv", 4, 32, 1, 3, 2, 0.25))
MNV3 = ((16, 16, 3, 2, True, "relu"), (64, 24, 3, 2, False, "relu"),
        (72, 24, 5, 1, True, "hswish"), (96, 40, 5, 2, True, "hswish"))


def _models(case, dtype):
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    if case == "mobilenetv3":
        return (te.MobileNetV3(te.MobileNetV3Config(MNV3, 96), dtype=td),
                je.MobileNetV3(config=je.MobileNetV3Config(MNV3, 96), dtype=jd), 96)
    blocks = V1 if case == "v1" else V2
    tcfg = te.EfficientNetConfig(tuple(te.BlockSpec(*b) for b in blocks), 16, 64)
    jcfg = je.EfficientNetConfig(tuple(je.BlockSpec(*b) for b in blocks), 16, 64)
    return te.EfficientNet(tcfg, dtype=td), je.EfficientNet(config=jcfg, dtype=jd), 64


# f32 within 1e-4 of the features' largest magnitude (measured 2.6e-7 to
# 2.8e-7). bf16 within 5e-2, test_torch_models.py's ResNet-18 bound for
# convolution nets (measured 4.4e-3 to 6.2e-3).
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("case", ["v1", "v2", "mobilenetv3"])
def test_efficientnet_family_forward_matches_jax(case, dtype, bound):
    port, ref, dim = _models(case, dtype)
    variables = carry(port, ref, (1, 32, 32, 3), seed=5, train=False)
    got, want, _ = forward_pair(port, ref, images(6, (2, 32, 32, 3)), variables)
    assert got.dtype == torch.float32 and got.shape == (2, dim)
    assert rel_err(got.numpy(), want) <= bound


@pytest.mark.parametrize("case", ["v1", "v2", "mobilenetv3"])
def test_efficientnet_family_training_mode_matches_jax(case):
    """Batch statistics in the forward (within 1e-5 of the largest feature,
    measured 5.8e-7 to 1.1e-6) and the running averages at epsilon 1e-3
    (within 1e-5)."""
    port, ref, _ = _models(case, "float32")
    variables = carry(port, ref, (1, 32, 32, 3), seed=7, train=False)
    got, want, upd = forward_pair(port, ref, images(8, (4, 32, 32, 3)), variables, train=True)
    assert rel_err(got.numpy(), want) <= 1e-5
    check_stats(port, upd)


@pytest.mark.parametrize("case", ["v2", "mobilenetv3"])
def test_efficientnet_family_train_step_matches_jax(monkeypatch, case):
    tloss, jloss, port, state, jstate = train_step_pair(
        monkeypatch, lambda: _models(case, "float32")[0], lambda: _models(case, "float32")[1],
        96 if case == "mobilenetv3" else 64, seed=13)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    check_step(port, state, jstate)


def test_configuration_tables_match_jax():
    """Every full-size name's configuration, built by the port's own copy
    of the scaling rules, equals the JAX table's, field for field."""
    assert te.EFFICIENTNET_CONFIGS.keys() == je.EFFICIENTNET_CONFIGS.keys()
    for name, cfg in je.EFFICIENTNET_CONFIGS.items():
        got = te.EFFICIENTNET_CONFIGS[name]
        assert [dataclasses.astuple(b) for b in got.blocks] == \
            [dataclasses.astuple(b) for b in cfg.blocks], name
        assert (got.stem_filters, got.head_filters) == (cfg.stem_filters, cfg.head_filters)
    assert te.MOBILENETV3_CONFIGS.keys() == je.MOBILENETV3_CONFIGS.keys()
    for name, cfg in je.MOBILENETV3_CONFIGS.items():
        assert dataclasses.astuple(te.MOBILENETV3_CONFIGS[name]) == dataclasses.astuple(cfg)
    for f in (3, 16, 40, 72, 1280):
        for m in (0.25, 1.1, 1.4):
            assert te._scale_filters(f, m) == je._scale_filters(f, m)
