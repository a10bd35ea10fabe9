"""Backbone factory: name -> (module, feature_dim).

Counterpart of ``spine_vision_tpu/models/backbone.py`` for the families this
slice ports: basic-block ResNets and ConvNeXt v1/v2. Every other name the JAX
package knows raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS, ConvNeXt
from spine_vision_torch.models.resnet import RESNET_CONFIGS, ResNet

_NOT_PORTED = {
    **{n: "resnet" for n in (
        "resnet50", "resnet101", "resnet152", "resnet50_a2", "resnet50_b",
        "resnet50_c", "resnet50_d", "resnext50", "resnext101", "wide_resnet50",
        "wide_resnet101", "resnetrs50", "resnetrs101", "resnetrs152",
    )},
    **{n: "vit" for n in (
        "vit_tiny", "vit_small", "vit_base", "vit_large", "deit_tiny",
        "deit_small", "deit_base",
    )},
    **{n: "swin" for n in ("swin_tiny", "swin_small", "swin_base")},
    **{n: "efficientnet" for n in (
        "efficientnet_b0", "efficientnet_b1", "efficientnet_b2", "efficientnet_b3",
        "efficientnet_b4", "efficientnetv2_s", "efficientnetv2_m", "efficientnetv2_l",
    )},
    **{n: "mobilenet" for n in ("mobilenetv3_small", "mobilenetv3_large")},
}


def create_backbone(
    name: str, dtype=torch.bfloat16, device=None, generator: torch.Generator | None = None,
    use_pallas: bool | str = True, param_dtype=None,
) -> tuple[nn.Module, int]:
    """Build a backbone mapping ``[B, H, W, 3]`` images to ``[B, dim]`` features.

    ``use_pallas`` picks the ConvNeXt kernels as in the JAX factory: ``True``
    (inference kernels), ``"hybrid"`` (the training block) or ``False``
    (plain ops); ResNets have none. ``param_dtype`` (ConvNeXt only) keeps the
    weights in another dtype than the compute one, f32 masters for training.
    """
    if name in RESNET_CONFIGS:
        cfg = RESNET_CONFIGS[name]
        return ResNet(cfg, dtype=dtype, device=device, generator=generator), cfg.num_features
    if name in CONVNEXT_CONFIGS:
        cn = CONVNEXT_CONFIGS[name]
        model = ConvNeXt(
            cn, dtype=dtype, device=device, generator=generator,
            use_pallas=use_pallas, param_dtype=param_dtype,
        )
        return model, cn.num_features
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backbone {name!r} ({_NOT_PORTED[name]} family) is not ported yet: "
            "ROADMAP.md, Queue 1 item 12 (the rest of the backbone zoo)"
        )
    raise ValueError(f"Unknown backbone: {name}")
