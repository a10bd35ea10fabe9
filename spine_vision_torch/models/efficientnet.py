"""EfficientNet v1/v2 and MobileNetV3 backbones, NHWC.

Counterpart of ``spine_vision_tpu/models/efficientnet.py``, with its
configuration tables built by the same scaling rules (``_scale_filters``,
``_scale_repeats``, ``_effnet_v1``) and its variable names:

- ``InvertedResidual`` in three kinds: ``mbconv`` (1x1 expansion unless the
  ratio is 1, depthwise kxk, SE, 1x1 projection), ``fused`` (one dense kxk
  convolution in place of expansion and depthwise, EfficientNetV2) and
  ``dsconv`` (EfficientNet's first stage, an ``mbconv`` of ratio 1);
- convolutions padded symmetrically by ``k // 2`` at every stride (not TF's
  "SAME");
- SE sized as timm's: from the block's input channels times ``se_ratio``
  with the block's activation (EfficientNet), or ``make_divisible(mid / 4,
  8)`` with ReLU and a hard-sigmoid gate (MobileNetV3);
- every BatchNorm is ``ops/batchnorm.py``'s (the JAX ``TpuBatchNorm``) at
  epsilon 1e-3 and momentum 0.9, following ``self.training``, so the
  trainer syncs it across ranks;
- MobileNetV3's head: a 1x1 convolution, BatchNorm and hard-swish, the
  spatial mean, then the ``head_fc`` Dense and hard-swish.

hard-swish and hard-sigmoid are JAX's ``relu6(x + 3) / 6`` forms.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.models.layers import Conv, Dense
from spine_vision_torch.models.resnet import ACTIVATIONS, SqueezeExcite, hard_swish
from spine_vision_torch.ops.batchnorm import BatchNorm


@dataclass(frozen=True)
class BlockSpec:
    """One stage of inverted-residual blocks."""

    kind: str  # "mbconv" | "fused" | "dsconv"
    expand: float
    filters: int
    num_blocks: int
    kernel: int
    strides: int
    se_ratio: float = 0.0
    activation: str = "silu"  # "silu" | "hswish" | "relu"


@dataclass(frozen=True)
class EfficientNetConfig:
    """Scaled EfficientNet architecture."""

    blocks: tuple[BlockSpec, ...]
    stem_filters: int
    head_filters: int

    @property
    def num_features(self) -> int:
        return self.head_filters


def _scale_filters(filters: int, multiplier: float, divisor: int = 8) -> int:
    filters *= multiplier
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def _scale_repeats(repeats: int, multiplier: float) -> int:
    return int(math.ceil(multiplier * repeats))


def _effnet_v1(width: float, depth: float) -> EfficientNetConfig:
    base = [
        BlockSpec("dsconv", 1, 16, 1, 3, 1, 0.25),
        BlockSpec("mbconv", 6, 24, 2, 3, 2, 0.25),
        BlockSpec("mbconv", 6, 40, 2, 5, 2, 0.25),
        BlockSpec("mbconv", 6, 80, 3, 3, 2, 0.25),
        BlockSpec("mbconv", 6, 112, 3, 5, 1, 0.25),
        BlockSpec("mbconv", 6, 192, 4, 5, 2, 0.25),
        BlockSpec("mbconv", 6, 320, 1, 3, 1, 0.25),
    ]
    blocks = tuple(
        BlockSpec(b.kind, b.expand, _scale_filters(b.filters, width),
                  _scale_repeats(b.num_blocks, depth), b.kernel, b.strides, b.se_ratio)
        for b in base
    )
    return EfficientNetConfig(
        blocks=blocks,
        stem_filters=_scale_filters(32, width),
        head_filters=_scale_filters(1280, max(width, 1.0)),
    )


EFFICIENTNET_CONFIGS: dict[str, EfficientNetConfig] = {
    "efficientnet_b0": _effnet_v1(1.0, 1.0),
    "efficientnet_b1": _effnet_v1(1.0, 1.1),
    "efficientnet_b2": _effnet_v1(1.1, 1.2),
    "efficientnet_b3": _effnet_v1(1.2, 1.4),
    "efficientnet_b4": _effnet_v1(1.4, 1.8),
    "efficientnetv2_s": EfficientNetConfig(
        blocks=(
            BlockSpec("fused", 1, 24, 2, 3, 1),
            BlockSpec("fused", 4, 48, 4, 3, 2),
            BlockSpec("fused", 4, 64, 4, 3, 2),
            BlockSpec("mbconv", 4, 128, 6, 3, 2, 0.25),
            BlockSpec("mbconv", 6, 160, 9, 3, 1, 0.25),
            BlockSpec("mbconv", 6, 256, 15, 3, 2, 0.25),
        ),
        stem_filters=24,
        head_filters=1280,
    ),
    "efficientnetv2_m": EfficientNetConfig(
        blocks=(
            BlockSpec("fused", 1, 24, 3, 3, 1),
            BlockSpec("fused", 4, 48, 5, 3, 2),
            BlockSpec("fused", 4, 80, 5, 3, 2),
            BlockSpec("mbconv", 4, 160, 7, 3, 2, 0.25),
            BlockSpec("mbconv", 6, 176, 14, 3, 1, 0.25),
            BlockSpec("mbconv", 6, 304, 18, 3, 2, 0.25),
            BlockSpec("mbconv", 6, 512, 5, 3, 1, 0.25),
        ),
        stem_filters=24,
        head_filters=1280,
    ),
    "efficientnetv2_l": EfficientNetConfig(
        blocks=(
            BlockSpec("fused", 1, 32, 4, 3, 1),
            BlockSpec("fused", 4, 64, 7, 3, 2),
            BlockSpec("fused", 4, 96, 7, 3, 2),
            BlockSpec("mbconv", 4, 192, 10, 3, 2, 0.25),
            BlockSpec("mbconv", 6, 224, 19, 3, 1, 0.25),
            BlockSpec("mbconv", 6, 384, 25, 3, 2, 0.25),
            BlockSpec("mbconv", 6, 640, 7, 3, 1, 0.25),
        ),
        stem_filters=32,
        head_filters=1280,
    ),
}


def _norm(c: int, device) -> BatchNorm:
    return BatchNorm(c, eps=1e-3, device=device)


class InvertedResidual(nn.Module):
    """MBConv / FusedMBConv / depthwise-separable block (``spec_kind``
    "mbconv" or "fused"; "dsconv" is an "mbconv" of expansion 1)."""

    def __init__(
        self, in_ch: int, spec_kind: str, expand: float, filters: int, kernel: int,
        strides: int, se_ratio: float, activation: str, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        expanded = int(in_ch * expand)
        pad = kernel // 2
        self.act = ACTIVATIONS[activation]
        self.fused = spec_kind == "fused"
        self.residual = strides == 1 and in_ch == filters
        if self.fused:
            self.fused_conv = Conv(in_ch, expanded, kernel, strides, padding=pad, bias=False, **kw)
            self.fused_bn = _norm(expanded, device)
        else:
            if expand != 1:
                self.expand_conv = Conv(in_ch, expanded, 1, bias=False, **kw)
                self.expand_bn = _norm(expanded, device)
            else:
                self.expand_conv = None
            self.dwconv = Conv(expanded, expanded, kernel, strides, padding=pad,
                               groups=expanded, bias=False, **kw)
            self.dw_bn = _norm(expanded, device)
        self.se = (SqueezeExcite(expanded, hidden=max(1, int(in_ch * se_ratio)),
                                 act=activation, **kw) if se_ratio > 0 else None)
        self.project_conv = Conv(expanded, filters, 1, bias=False, **kw)
        self.project_bn = _norm(filters, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            y = self.act(self.fused_bn(self.fused_conv(x)))
        else:
            y = x
            if self.expand_conv is not None:
                y = self.act(self.expand_bn(self.expand_conv(y)))
            y = self.act(self.dw_bn(self.dwconv(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.project_bn(self.project_conv(y))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """``[B, H, W, 3]`` -> ``[B, head_filters]`` f32 pooled features."""

    def __init__(
        self, config: EfficientNetConfig, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.stem_conv = Conv(3, config.stem_filters, 3, 2, padding=1, bias=False, **kw)
        self.stem_bn = _norm(config.stem_filters, device)
        in_ch = config.stem_filters
        for s, spec in enumerate(config.blocks):
            for b in range(spec.num_blocks):
                self.add_module(f"stage{s + 1}_block{b + 1}", InvertedResidual(
                    in_ch, "mbconv" if spec.kind == "dsconv" else spec.kind, spec.expand,
                    spec.filters, spec.kernel, spec.strides if b == 0 else 1, spec.se_ratio,
                    spec.activation, **kw,
                ))
                in_ch = spec.filters
        self.head_conv = Conv(in_ch, config.head_filters, 1, bias=False, **kw)
        self.head_bn = _norm(config.head_filters, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.stem_bn(self.stem_conv(x.to(self.dtype))))
        for s, spec in enumerate(self.config.blocks):
            for b in range(spec.num_blocks):
                x = getattr(self, f"stage{s + 1}_block{b + 1}")(x)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return x.mean(dim=(1, 2)).float()


@dataclass(frozen=True)
class MobileNetV3Config:
    """MobileNetV3 stage list: (expand_filters, out_filters, kernel, strides,
    se, activation) per block."""

    blocks: tuple[tuple[int, int, int, int, bool, str], ...]
    head_filters: int

    @property
    def num_features(self) -> int:
        return self.head_filters


MOBILENETV3_CONFIGS: dict[str, MobileNetV3Config] = {
    "mobilenetv3_large": MobileNetV3Config(
        blocks=(
            (16, 16, 3, 1, False, "relu"),
            (64, 24, 3, 2, False, "relu"),
            (72, 24, 3, 1, False, "relu"),
            (72, 40, 5, 2, True, "relu"),
            (120, 40, 5, 1, True, "relu"),
            (120, 40, 5, 1, True, "relu"),
            (240, 80, 3, 2, False, "hswish"),
            (200, 80, 3, 1, False, "hswish"),
            (184, 80, 3, 1, False, "hswish"),
            (184, 80, 3, 1, False, "hswish"),
            (480, 112, 3, 1, True, "hswish"),
            (672, 112, 3, 1, True, "hswish"),
            (672, 160, 5, 2, True, "hswish"),
            (960, 160, 5, 1, True, "hswish"),
            (960, 160, 5, 1, True, "hswish"),
        ),
        head_filters=1280,
    ),
    "mobilenetv3_small": MobileNetV3Config(
        blocks=(
            (16, 16, 3, 2, True, "relu"),
            (72, 24, 3, 2, False, "relu"),
            (88, 24, 3, 1, False, "relu"),
            (96, 40, 5, 2, True, "hswish"),
            (240, 40, 5, 1, True, "hswish"),
            (240, 40, 5, 1, True, "hswish"),
            (120, 48, 5, 1, True, "hswish"),
            (144, 48, 5, 1, True, "hswish"),
            (288, 96, 5, 2, True, "hswish"),
            (576, 96, 5, 1, True, "hswish"),
            (576, 96, 5, 1, True, "hswish"),
        ),
        head_filters=1024,
    ),
}


class MobileNetV3(nn.Module):
    """``[B, H, W, 3]`` -> ``[B, head_filters]`` f32 features."""

    def __init__(
        self, config: MobileNetV3Config, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.stem_conv = Conv(3, 16, 3, 2, padding=1, bias=False, **kw)
        self.stem_bn = _norm(16, device)
        in_f = 16
        for i, (expand_f, out_f, kernel, strides, use_se, _) in enumerate(config.blocks):
            name = f"block{i + 1}"
            if expand_f != in_f:
                setattr(self, f"{name}_expand", Conv(in_f, expand_f, 1, bias=False, **kw))
                setattr(self, f"{name}_expand_bn", _norm(expand_f, device))
            setattr(self, f"{name}_dw", Conv(expand_f, expand_f, kernel, strides,
                                             padding=kernel // 2, groups=expand_f,
                                             bias=False, **kw))
            setattr(self, f"{name}_dw_bn", _norm(expand_f, device))
            if use_se:
                setattr(self, f"{name}_se", SqueezeExcite(
                    expand_f, hidden=_scale_filters(expand_f, 0.25), act="relu",
                    gate="hard_sigmoid", **kw))
            setattr(self, f"{name}_project", Conv(expand_f, out_f, 1, bias=False, **kw))
            setattr(self, f"{name}_project_bn", _norm(out_f, device))
            in_f = out_f
        last_conv = config.blocks[-1][0]
        self.head_conv = Conv(in_f, last_conv, 1, bias=False, **kw)
        self.head_bn = _norm(last_conv, device)
        self.head_fc = Dense(last_conv, config.head_filters, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = hard_swish(self.stem_bn(self.stem_conv(x.to(self.dtype))))
        for i, (expand_f, out_f, _, strides, use_se, act_name) in enumerate(self.config.blocks):
            name, act = f"block{i + 1}", ACTIVATIONS[act_name]
            in_f = x.shape[-1]
            y = x
            if expand_f != in_f:
                y = act(getattr(self, f"{name}_expand_bn")(getattr(self, f"{name}_expand")(y)))
            y = act(getattr(self, f"{name}_dw_bn")(getattr(self, f"{name}_dw")(y)))
            if use_se:
                y = getattr(self, f"{name}_se")(y)
            y = getattr(self, f"{name}_project_bn")(getattr(self, f"{name}_project")(y))
            x = y + x if strides == 1 and in_f == out_f else y
        x = hard_swish(self.head_bn(self.head_conv(x)))
        return hard_swish(self.head_fc(x.mean(dim=(1, 2)))).float()
