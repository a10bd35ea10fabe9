"""ResNet family backbones (ResNet, ResNeXt, WideResNet, ResNet-RS), NHWC.

Counterpart of ``spine_vision_tpu/models/resnet.py``: basic blocks
(ResNet-18/34), bottleneck blocks with groups (ResNeXt's inner width
``int(base * base_width / 64) * cardinality``), a widened 3x3 (WideResNet)
and squeeze-excitation, the 7x7 stem or ResNet-RS's deep stem of three 3x3
convolutions. The 7x7 stem pools before its ReLU (exact: the ReLU is
monotonic and the pool pads with -inf); the deep stem pools after its last
ReLU, as in the JAX module.

The BatchNorms follow ``self.training``: batch statistics and a running
update in training mode, the running statistics in eval mode (the JAX
``use_running_average=not train``), at momentum 0.9 and epsilon 1e-5.
``norm_impl="tpu"`` (the default) is ``ops/batchnorm.py``, the JAX
``TpuBatchNorm``; ``"flax"`` is Flax's ``nn.BatchNorm(dtype=dtype)``
(``models/layers.py::FlaxBatchNorm``), which normalises in f32 and casts
to the model's dtype. Both keep the same variables.

``pool_impl="flax"`` (the default) pools with ``F.max_pool2d``, whose
gradient goes to each window's first maximum in row-major order, as JAX's
``select_and_scatter`` with ``ge`` does (``tests/test_torch_batchnorm_train.py``
holds ties); ``"tpu"`` is ``ops/pool.py``'s scatter-free pool, whose
gradient goes to every maximum.

The convolutions keep their weights in ``param_dtype`` (f32 masters under
bf16 compute for training, as Flax's ``Conv(dtype=bf16)``), the BatchNorms
theirs in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.models.layers import Conv, Dense, FlaxBatchNorm
from spine_vision_torch.ops.batchnorm import BatchNorm
from spine_vision_torch.ops.pool import max_pool


@dataclass(frozen=True)
class ResNetConfig:
    """Architecture hyperparameters for a ResNet-family backbone."""

    stage_sizes: tuple[int, ...]
    block_type: str  # "basic" | "bottleneck"
    width_factor: int = 1  # widens the bottleneck 3x3 (WideResNet)
    cardinality: int = 1  # grouped 3x3 conv (ResNeXt)
    base_width: int = 64  # per-group width base
    deep_stem: bool = False  # ResNet-RS three-conv stem
    use_se: bool = False  # squeeze-excitation (ResNet-RS)
    num_features: int = 512


RESNET_CONFIGS: dict[str, ResNetConfig] = {
    "resnet18": ResNetConfig((2, 2, 2, 2), "basic", num_features=512),
    "resnet34": ResNetConfig((3, 4, 6, 3), "basic", num_features=512),
    "resnet50": ResNetConfig((3, 4, 6, 3), "bottleneck", num_features=2048),
    "resnet101": ResNetConfig((3, 4, 23, 3), "bottleneck", num_features=2048),
    "resnet152": ResNetConfig((3, 8, 36, 3), "bottleneck", num_features=2048),
    "resnext50": ResNetConfig(
        (3, 4, 6, 3), "bottleneck", cardinality=32, base_width=4, num_features=2048
    ),
    "resnext101": ResNetConfig(
        (3, 4, 23, 3), "bottleneck", cardinality=32, base_width=8, num_features=2048
    ),
    "wide_resnet50": ResNetConfig((3, 4, 6, 3), "bottleneck", width_factor=2, num_features=2048),
    "wide_resnet101": ResNetConfig(
        (3, 4, 23, 3), "bottleneck", width_factor=2, num_features=2048
    ),
    "resnetrs50": ResNetConfig(
        (3, 4, 6, 3), "bottleneck", deep_stem=True, use_se=True, num_features=2048
    ),
    "resnetrs101": ResNetConfig(
        (3, 4, 23, 3), "bottleneck", deep_stem=True, use_se=True, num_features=2048
    ),
    "resnetrs152": ResNetConfig(
        (3, 8, 36, 3), "bottleneck", deep_stem=True, use_se=True, num_features=2048
    ),
}


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool of NHWC ``x``, padded with -inf (Flax ``nn.max_pool``
    with padding 1). Its gradient goes to each window's first maximum."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_sigmoid``: ``relu6(x + 3) / 6``."""
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_swish``: ``x * hard_sigmoid(x)``."""
    return x * hard_sigmoid(x)


ACTIVATIONS = {"relu": torch.relu, "silu": F.silu, "hswish": hard_swish}


class SqueezeExcite(nn.Module):
    """Squeeze-and-excitation: the spatial mean, Dense ``fc1`` to ``hidden``
    (``max(channels // reduction, 8)`` unless given), ``act``, Dense ``fc2``
    back to ``channels``, then the ``gate`` ("sigmoid" or "hard_sigmoid")
    scales ``x``. The defaults are ResNet-RS's; EfficientNet and MobileNetV3
    pass timm's widths and activations."""

    def __init__(
        self, channels: int, reduction: int = 16, hidden: int | None = None,
        act: str = "relu", gate: str = "sigmoid", dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        hidden = hidden if hidden is not None else max(channels // reduction, 8)
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.fc1 = Dense(channels, hidden, **kw)
        self.fc2 = Dense(hidden, channels, **kw)
        self.act = F.silu if act == "silu" else torch.relu
        self.gate = hard_sigmoid if gate == "hard_sigmoid" else torch.sigmoid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.gate(self.fc2(self.act(self.fc1(x.mean(dim=(1, 2))))))
        return x * s[:, None, None, :]


def make_norm(norm_impl: str, dtype, device):
    """``norm(features, scale_init=1.0)`` of the chosen implementation at
    momentum 0.9, epsilon 1e-5."""
    if norm_impl == "tpu":
        return lambda c, scale_init=1.0: BatchNorm(c, scale_init=scale_init, device=device)
    if norm_impl == "flax":
        # .train(): in the mode of a new module, as its siblings, until the
        # model's train() or eval() switches them all.
        return lambda c, scale_init=1.0: FlaxBatchNorm(
            c, scale_init=scale_init, device=device, momentum=0.9, dtype=dtype,
            round_grads=dtype == torch.bfloat16,
        ).train()
    raise ValueError(f"Unknown norm_impl: {norm_impl!r} (expected 'tpu' or 'flax')")


class BasicBlock(nn.Module):
    """3x3-3x3 residual block; its last BatchNorm's scale starts at 0."""

    def __init__(
        self, in_ch: int, filters: int, stride: int, dtype=torch.float32,
        device=None, generator: torch.Generator | None = None, param_dtype=None,
        norm=None, use_se: bool = False,
    ) -> None:
        super().__init__()
        norm = norm or make_norm("tpu", dtype, device)
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.conv1 = Conv(in_ch, filters, 3, stride, padding=1, bias=False, **kw)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, 3, 1, padding=1, bias=False, **kw)
        self.bn2 = norm(filters, scale_init=0.0)
        self.se = SqueezeExcite(filters, **kw) if use_se else None
        if in_ch != filters or stride != 1:
            self.downsample_conv = Conv(in_ch, filters, 1, stride, bias=False, **kw)
            self.downsample_bn = norm(filters)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.se is not None:
            y = self.se(y)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1-3x3-1x1 bottleneck: ``filters`` inner width, ``groups`` on the
    3x3, ``out_ch`` output width; ``bn3``'s scale starts at 0."""

    def __init__(
        self, in_ch: int, filters: int, out_ch: int, stride: int, groups: int = 1,
        use_se: bool = False, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None, norm=None,
    ) -> None:
        super().__init__()
        norm = norm or make_norm("tpu", dtype, device)
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.conv1 = Conv(in_ch, filters, 1, bias=False, **kw)
        self.bn1 = norm(filters)
        self.conv2 = Conv(filters, filters, 3, stride, padding=1, groups=groups, bias=False,
                          **kw)
        self.bn2 = norm(filters)
        self.conv3 = Conv(filters, out_ch, 1, bias=False, **kw)
        self.bn3 = norm(out_ch, scale_init=0.0)
        self.se = SqueezeExcite(out_ch, **kw) if use_se else None
        if in_ch != out_ch or stride != 1:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride, bias=False, **kw)
            self.downsample_bn = norm(out_ch)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
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
        if pool_impl not in ("flax", "tpu"):
            raise ValueError(f"Unknown pool_impl: {pool_impl!r} (expected 'flax' or 'tpu')")
        self.config, self.dtype, self.pool_impl = config, dtype, pool_impl
        norm = make_norm(norm_impl, dtype, device)
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        if config.deep_stem:
            in_ch = 3
            for i, f in enumerate((32, 32, 64)):
                self.add_module(f"stem_conv{i + 1}", Conv(
                    in_ch, f, 3, 2 if i == 0 else 1, padding=1, bias=False, **kw))
                self.add_module(f"stem_bn{i + 1}", norm(f))
                in_ch = f
        else:
            self.stem_conv = Conv(3, 64, 7, 2, padding=3, bias=False, **kw)
            self.stem_bn = norm(64)
        in_ch = 64
        for s, n in enumerate(config.stage_sizes):
            base = 64 * 2**s
            for b in range(n):
                stride = 2 if s > 0 and b == 0 else 1
                if config.block_type == "basic":
                    filters = base * config.width_factor
                    block = BasicBlock(in_ch, filters, stride, norm=norm, use_se=config.use_se,
                                       **kw)
                else:
                    if config.cardinality > 1:
                        inner = int(base * config.base_width / 64.0) * config.cardinality
                    else:
                        inner = base * config.width_factor
                    filters = base * 4
                    block = BottleneckBlock(in_ch, inner, filters, stride,
                                            groups=config.cardinality, use_se=config.use_se,
                                            norm=norm, **kw)
                self.add_module(f"stage{s + 1}_block{b + 1}", block)
                in_ch = filters

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x) if self.pool_impl == "tpu" else stem_pool(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.config.deep_stem:
            for i in range(1, 4):
                x = getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x))
                x = torch.relu(x)
            x = self._pool(x)
        else:
            x = self.stem_bn(self.stem_conv(x))
            x = torch.relu(self._pool(x))  # pooling before the ReLU is exact
        for s, n in enumerate(self.config.stage_sizes):
            for b in range(n):
                x = getattr(self, f"stage{s + 1}_block{b + 1}")(x)
        return x.mean(dim=(1, 2)).float()
