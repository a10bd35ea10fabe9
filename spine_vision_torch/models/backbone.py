"""Backbone registry and factory: name -> (module, feature_dim).

Counterpart of ``spine_vision_tpu/models/backbone.py``: the 46 names of
``BACKBONES`` over the ResNet, ConvNeXt, ViT/DeiT, Swin, EfficientNet and
MobileNetV3 families (the ``resnet50_a2/b/c/d`` recipes share ResNet-50's
architecture). Each module maps ``[B, H, W, 3]`` images to ``[B,
feature_dim]`` f32 pooled features.
"""

from __future__ import annotations

import torch
from torch import nn

from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS, ConvNeXt
from spine_vision_torch.models.efficientnet import (
    EFFICIENTNET_CONFIGS,
    MOBILENETV3_CONFIGS,
    EfficientNet,
    MobileNetV3,
)
from spine_vision_torch.models.resnet import RESNET_CONFIGS, ResNet
from spine_vision_torch.models.swin import SWIN_CONFIGS, SwinTransformer
from spine_vision_torch.models.vit import VIT_CONFIGS, ViT

_FAMILIES = {
    "resnet": RESNET_CONFIGS,
    "convnext": CONVNEXT_CONFIGS,
    "vit": VIT_CONFIGS,
    "swin": SWIN_CONFIGS,
    "efficientnet": EFFICIENTNET_CONFIGS,
    "mobilenet": MOBILENETV3_CONFIGS,
}

BACKBONES: dict[str, str] = {
    **{name: f"resnet:{name}" for name in RESNET_CONFIGS},
    **{name: "resnet:resnet50" for name in ("resnet50_a2", "resnet50_b", "resnet50_c",
                                             "resnet50_d")},
    **{name: f"convnext:{name}" for name in CONVNEXT_CONFIGS},
    **{name: f"vit:{name}" for name in VIT_CONFIGS},
    **{name: f"swin:{name}" for name in SWIN_CONFIGS},
    **{name: f"efficientnet:{name}" for name in EFFICIENTNET_CONFIGS},
    **{name: f"mobilenet:{name}" for name in MOBILENETV3_CONFIGS},
}


def backbone_config(name: str):
    """``(family, config)`` of a backbone name; an unknown name raises."""
    if name not in BACKBONES:
        raise ValueError(f"Unknown backbone: {name}. Available: {', '.join(sorted(BACKBONES))}")
    family, variant = BACKBONES[name].split(":")
    return family, _FAMILIES[family][variant]


def create_backbone(
    name: str, dtype=torch.bfloat16, device=None, generator: torch.Generator | None = None,
    use_pallas: bool | str = True, param_dtype=None, norm_impl: str = "tpu",
    pool_impl: str = "flax",
) -> tuple[nn.Module, int]:
    """Build a backbone mapping ``[B, H, W, 3]`` images to ``[B, dim]`` features.

    ``use_pallas`` picks the ConvNeXt kernels as in the JAX factory: ``True``
    (the inference kernels, trainable: the all-kernel block), ``"mlp"`` (the
    LN-fused MLP kernels), ``"hybrid"`` (the hybrid training block),
    ``"block"`` (the whole-block training kernel) or ``False`` (plain ops);
    the other families have none. ``param_dtype`` keeps the weights in
    another dtype than the compute one, f32 masters for training.
    ``norm_impl`` ("tpu" or "flax") and ``pool_impl`` ("flax" or "tpu")
    choose the ResNet family's BatchNorm and stem pool.
    """
    family, cfg = backbone_config(name)
    kw = {"dtype": dtype, "device": device, "generator": generator, "param_dtype": param_dtype}
    if family == "resnet":
        model = ResNet(cfg, norm_impl=norm_impl, pool_impl=pool_impl, **kw)
    elif family == "convnext":
        model = ConvNeXt(cfg, use_pallas=use_pallas, **kw)
    elif family == "vit":
        model = ViT(cfg, **kw)
    elif family == "swin":
        model = SwinTransformer(cfg, **kw)
    elif family == "efficientnet":
        model = EfficientNet(cfg, **kw)
    else:
        model = MobileNetV3(cfg, **kw)
    return model, cfg.num_features


def get_feature_dim(name: str) -> int:
    """Feature dimension of a backbone, without building it."""
    return backbone_config(name)[1].num_features


def list_backbones(family: str | None = None) -> list[str]:
    """Backbone names, optionally those starting with ``family``."""
    if family is None:
        return sorted(BACKBONES)
    return sorted(n for n in BACKBONES if n.startswith(family.lower()))


class BackboneFactory:
    """The JAX package's factory surface over :func:`create_backbone`."""

    @staticmethod
    def create(name: str, pretrained: bool = False, **kwargs) -> tuple[nn.Module, int]:
        """``pretrained`` is accepted for the JAX signature; weights load
        through ``pretrained_path`` (``models/convert.py``)."""
        return create_backbone(name, **kwargs)

    get_feature_dim = staticmethod(get_feature_dim)
    list_backbones = staticmethod(list_backbones)
