"""Full-size zoo models: the port's variable trees and tables against the
JAX package's.

One name per distinct architecture is built on the meta device and its
Flax-layout variables (names and shapes) compared with ``jax.eval_shape``
of the JAX model's init. All 46 names of ``BACKBONES`` resolve alike in
both packages, with the same feature dims and configuration fields; none
raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch_zoo_helpers import port_shapes as _port_shapes
from torch_zoo_helpers import shapes

from spine_vision_torch.models import backbone as tb
from spine_vision_torch.models.convert import _entries
from spine_vision_tpu.models import backbone as jb

DISTINCT = ["resnet50", "resnext50", "wide_resnet50", "resnetrs50", "vit_base", "swin_tiny",
            "efficientnet_b0", "efficientnetv2_s", "mobilenetv3_large"]


@pytest.mark.parametrize("name", DISTINCT)
def test_full_size_variable_tree_matches_jax(name):
    with torch.device("meta"):
        port, dim = tb.create_backbone(name, dtype=torch.float32)
    ref, ref_dim = jb.BackboneFactory.create(name, dtype=jnp.float32)
    assert dim == ref_dim
    init = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                           train=False))
    got = _port_shapes(port)
    assert got["params"] == shapes(init["params"])
    assert got["batch_stats"] == shapes(init.get("batch_stats", {}))
    # Every parameter and buffer is a Flax variable: a load leaves none unset.
    carried = sum(e.target.numel() for e in _entries(port))
    assert carried == sum(t.numel() for t in (*port.parameters(), *port.buffers()))


def test_every_backbone_name_resolves_as_in_jax():
    assert tb.BACKBONES == jb.BACKBONES and len(tb.BACKBONES) == 46
    assert tb.list_backbones() == jb.list_backbones()
    for family in ("resnet", "vit", "swin", "efficientnet", "mobilenet", "convnext", "deit"):
        assert tb.list_backbones(family) == jb.list_backbones(family), family
    for name in jb.BACKBONES:
        family, variant = jb.BACKBONES[name].split(":")
        table = {"resnet": "RESNET_CONFIGS", "convnext": "CONVNEXT_CONFIGS",
                 "vit": "VIT_CONFIGS", "swin": "SWIN_CONFIGS",
                 "efficientnet": "EFFICIENTNET_CONFIGS",
                 "mobilenet": "MOBILENETV3_CONFIGS"}[family]
        jmod = {"resnet": "resnet", "convnext": "convnext", "vit": "vit", "swin": "swin",
                "efficientnet": "efficientnet", "mobilenet": "efficientnet"}[family]
        jcfg = getattr(__import__(f"spine_vision_tpu.models.{jmod}", fromlist=[table]),
                       table)[variant]
        t_family, tcfg = tb.backbone_config(name)
        assert t_family == family, name
        assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg), name
        assert tb.get_feature_dim(name) == jb.BackboneFactory.get_feature_dim(name), name
    with pytest.raises(ValueError, match="Unknown backbone"):
        tb.create_backbone("alexnet", device="cpu")


def test_resnet50_recipes_share_its_architecture():
    with torch.device("meta"):
        trees = [_port_shapes(tb.create_backbone(n, dtype=torch.float32)[0])
                 for n in ("resnet50", "resnet50_a2", "resnet50_b", "resnet50_c", "resnet50_d")]
    assert all(t == trees[0] for t in trees[1:])
