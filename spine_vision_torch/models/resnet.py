"""ResNet backbones with basic blocks (ResNet-18/34), NHWC.

Counterpart of ``spine_vision_tpu/models/resnet.py`` with its defaults
(``norm_impl="tpu"``: ``ops/batchnorm.py``; ``pool_impl="flax"``: the stem
max pool pads with -inf). The BatchNorms follow ``self.training``: batch
statistics and a running update in training mode, the folded running
statistics in eval mode (the JAX ``use_running_average=not train``). The
convolutions keep their weights in ``param_dtype`` (f32 masters under bf16
compute for training, as Flax's ``Conv(dtype=bf16)``), the BatchNorms
theirs in f32.

The stem pools before its ReLU, which is exact forward; backward, the pool
routes each window's gradient to its first maximum in row-major order, as
JAX's ``select_and_scatter`` with ``ge`` does
(``tests/test_torch_batchnorm_train.py`` holds ties). Bottleneck, ResNeXt,
wide and ResNet-RS variants, ``norm_impl="flax"`` and ``pool_impl="tpu"``
wait (ROADMAP, Queue 1 item 12).
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


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool of NHWC ``x``, padded with -inf (Flax ``nn.max_pool``
    with padding 1). Its gradient goes to each window's first maximum."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    """3x3-3x3 residual block; its last BatchNorm's scale starts at 0."""

    def __init__(
        self, in_ch: int, filters: int, stride: int, dtype=torch.float32,
        device=None, generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.conv1 = Conv(in_ch, filters, 3, stride, padding=1, bias=False, **kw)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, 1, padding=1, bias=False, **kw)
        self.bn2 = BatchNorm(filters, scale_init=0.0, device=device)
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
        generator: torch.Generator | None = None, param_dtype=None,
        norm_impl: str = "tpu", pool_impl: str = "flax",
    ) -> None:
        super().__init__()
        for option, value, ported in (("norm_impl", norm_impl, "tpu"),
                                      ("pool_impl", pool_impl, "flax")):
            if value != ported:
                raise NotImplementedError(
                    f"{option}={value!r} is not ported yet (only {ported!r}): ROADMAP.md, "
                    "Queue 1 item 12 (ops/pool.py and the other ResNet variants)"
                )
        self.config, self.dtype = config, dtype
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
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
        x = torch.relu(stem_pool(x))  # pooling before the ReLU is exact
        for s, n in enumerate(self.config.stage_sizes):
            for b in range(n):
                x = getattr(self, f"stage{s + 1}_block{b + 1}")(x)
        return x.mean(dim=(1, 2)).float()
