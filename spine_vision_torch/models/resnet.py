"""ResNet backbones with basic blocks (ResNet-18/34), inference, NHWC.

Counterpart of ``spine_vision_tpu/models/resnet.py`` with its defaults
(``norm_impl="tpu"``: BatchNorm folded to one scale-shift pass;
``pool_impl="flax"``: the stem max pool pads with -inf). The stem pools
before its ReLU, which is exact. Bottleneck, ResNeXt, wide and ResNet-RS
variants wait (ROADMAP, Queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.models.layers import Conv
from spine_vision_torch.ops.batchnorm import BatchNorm


@dataclass(frozen=True)
class ResNetConfig:
    """Architecture hyperparameters of a basic-block ResNet."""

    stage_sizes: tuple[int, ...]
    num_features: int = 512


RESNET_CONFIGS: dict[str, ResNetConfig] = {
    "resnet18": ResNetConfig((2, 2, 2, 2)),
    "resnet34": ResNetConfig((3, 4, 6, 3)),
}


class BasicBlock(nn.Module):
    """3x3-3x3 residual block."""

    def __init__(
        self, in_ch: int, filters: int, stride: int, dtype=torch.float32,
        device=None, generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        kw = {"dtype": dtype, "device": device, "generator": generator}
        self.conv1 = Conv(in_ch, filters, 3, stride, padding=1, bias=False, **kw)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, 1, padding=1, bias=False, **kw)
        self.bn2 = BatchNorm(filters, device=device)
        if in_ch != filters or stride != 1:
            self.downsample_conv = Conv(in_ch, filters, 1, stride, bias=False, **kw)
            self.downsample_bn = BatchNorm(filters, device=device)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """``[B, H, W, 3]`` -> ``[B, num_features]`` f32 pooled features."""

    def __init__(
        self, config: ResNetConfig, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        kw = {"dtype": dtype, "device": device, "generator": generator}
        self.stem_conv = Conv(3, 64, 7, 2, padding=3, bias=False, **kw)
        self.stem_bn = BatchNorm(64, device=device)
        in_ch = 64
        for s, n in enumerate(config.stage_sizes):
            filters = 64 * 2**s
            for b in range(n):
                stride = 2 if s > 0 and b == 0 else 1
                self.add_module(
                    f"stage{s + 1}_block{b + 1}", BasicBlock(in_ch, filters, stride, **kw)
                )
                in_ch = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_bn(self.stem_conv(x.to(self.dtype)))
        # 3x3/2 max pool with -inf padding, before the ReLU (exact).
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        x = torch.relu(x)
        for s, n in enumerate(self.config.stage_sizes):
            for b in range(n):
                x = getattr(self, f"stage{s + 1}_block{b + 1}")(x)
        return x.mean(dim=(1, 2)).float()
