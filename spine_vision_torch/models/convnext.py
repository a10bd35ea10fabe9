"""ConvNeXt v1/v2 backbones, NHWC, for inference and training.

Counterpart of ``spine_vision_tpu/models/convnext.py``. Each block picks one
route (``ConvNeXtBlock.route``, named in brackets) as the JAX model does for
its ``use_pallas`` setting, the first that applies in the JAX order:

1. [``"hybrid"``, ``"block"``] ``use_pallas="hybrid"`` or ``"block"``
   (training), v1 blocks of width <= ``MAX_FUSED_DIM`` with LayerScale: the
   hybrid block (the block kernel emitting ``t`` forward, the LN+MLP backward
   kernel) or the whole-block training block (the block kernel forward, the
   whole-block backward kernel); both in ``ops/block_train.py``;
2. [``"fused"``] ``use_pallas=True`` (inference, and training with
   ``use_pallas_dwconv``), v1 blocks of width <= ``MAX_FUSED_DIM``: the
   whole-block kernel (``ops/convnext_block.py::convnext_block_fused``, whose
   backward is the dwconv+LN recompute, the MLP backward and the dwconv+LN
   backward kernels);
3. [``"dw_ln"``] ``use_pallas=True``, wider blocks and v2 (GRN) blocks: the
   dwconv+LayerNorm kernel (``ops/dwconv.py::depthwise_conv7x7_ln``, forward
   and backward kernels), then the plain MLP;
4. [``"ln_mlp"``] ``use_pallas="mlp"`` or ``"hybrid"`` otherwise, v1 blocks
   of width <= ``MAX_FUSED_DIM`` with LayerScale: a plain depthwise conv,
   then the LN-fused MLP (``ops/fused_mlp.py::fused_ln_mlp``: forward kernel
   #7, backward #8/#9; the ``"mlp"`` mode);
5. [``"mlp"``] the same blocks without LayerScale: a plain depthwise conv and
   LayerNorm, then the fused MLP with the residual (``fused_mlp``: forward
   kernel #5, backward #6);
6. [``"plain"``] every other block, ``use_pallas=False`` and ``gelu="erf"``
   (exact GELU parity): plain PyTorch ops (grouped ``F.conv2d``, f32
   LayerNorm, Dense in the compute dtype), the JAX package's own route for
   them.

The stem and downsample convolutions and the plain MLP's products are
``F.conv2d`` / ``torch.matmul``, as the JAX package leaves them to XLA.
Weights live in ``param_dtype`` (f32 masters for training) and are cast to
the compute dtype in ``forward``, as Flax does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.models.layers import Conv, LayerNorm, _lecun_normal, _param
from spine_vision_torch.ops.block_train import convnext_block_hybrid, convnext_block_train
from spine_vision_torch.ops.convnext_block import convnext_block_fused
from spine_vision_torch.ops.dwconv import KERNEL_SIZE, PAD, depthwise_conv7x7_ln
from spine_vision_torch.ops.fused_mlp import MAX_FUSED_DIM, fused_ln_mlp, fused_mlp

USE_PALLAS_MODES = (True, "mlp", "hybrid", "block", False)


@dataclass(frozen=True)
class ConvNeXtConfig:
    """Architecture hyperparameters for a ConvNeXt backbone."""

    depths: tuple[int, ...]
    dims: tuple[int, ...]
    use_grn: bool = False  # v2
    layer_scale_init: float = 1e-6  # v1 LayerScale (ignored when use_grn)

    @property
    def num_features(self) -> int:
        return self.dims[-1]


CONVNEXT_CONFIGS: dict[str, ConvNeXtConfig] = {
    "convnext_tiny": ConvNeXtConfig((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ConvNeXtConfig((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ConvNeXtConfig((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ConvNeXtConfig((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ConvNeXtConfig((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnextv2_tiny": ConvNeXtConfig((3, 3, 9, 3), (96, 192, 384, 768), use_grn=True),
    "convnextv2_small": ConvNeXtConfig((3, 3, 27, 3), (96, 192, 384, 768), use_grn=True),
    "convnextv2_base": ConvNeXtConfig((3, 3, 27, 3), (128, 256, 512, 1024), use_grn=True),
    "convnextv2_large": ConvNeXtConfig((3, 3, 27, 3), (192, 384, 768, 1536), use_grn=True),
    "convnextv2_huge": ConvNeXtConfig((3, 3, 27, 3), (352, 704, 1408, 2816), use_grn=True),
}


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXt-V2), in f32."""

    def __init__(self, dim: int, device=None) -> None:
        super().__init__()
        self.gamma = _param(torch.zeros(dim), torch.float32, device)
        self.beta = _param(torch.zeros(dim), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        gx = torch.sqrt((xf * xf).sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (xf * nx) + self.beta + xf).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 -> LN -> pwconv(4x) -> GELU -> [GRN] -> pwconv + residual.

    Weights live in the layouts the kernels read: ``dw_kernel [49, C]`` and
    ``pw{1,2}_weight [out, in]`` in ``param_dtype`` (default: the compute
    dtype); biases, LayerNorm and ``gamma`` in f32.
    """

    def __init__(
        self, dim: int, use_grn: bool, layer_scale_init: float,
        dtype=torch.float32, gelu: str = "tanh", device=None,
        generator: torch.Generator | None = None, use_pallas: bool | str = True,
        param_dtype=None,
    ) -> None:
        super().__init__()
        if use_pallas not in USE_PALLAS_MODES:
            raise ValueError(f"use_pallas={use_pallas!r}: the modes are {USE_PALLAS_MODES}")
        self.dim, self.use_grn, self.gelu, self.dtype = dim, use_grn, gelu, dtype
        f32 = torch.float32
        param_dtype = param_dtype or dtype
        taps = KERNEL_SIZE * KERNEL_SIZE
        self.dw_kernel = _param(_lecun_normal((taps, dim), taps, generator), param_dtype, device)
        self.dw_bias = _param(torch.zeros(dim), f32, device)
        self.norm_scale = _param(torch.ones(dim), f32, device)
        self.norm_bias = _param(torch.zeros(dim), f32, device)
        self.pw1_weight = _param(
            _lecun_normal((4 * dim, dim), dim, generator), param_dtype, device
        )
        self.pw1_bias = _param(torch.zeros(4 * dim), f32, device)
        self.pw2_weight = _param(
            _lecun_normal((dim, 4 * dim), 4 * dim, generator), param_dtype, device
        )
        self.pw2_bias = _param(torch.zeros(dim), f32, device)
        self.grn = GRN(4 * dim, device=device) if use_grn else None
        has_gamma = not use_grn and layer_scale_init > 0
        self.gamma = (
            _param(torch.full((dim,), float(layer_scale_init)), f32, device)
            if has_gamma else None
        )
        fits = not use_grn and dim <= MAX_FUSED_DIM
        # The route of the module docstring: the first of its list that applies.
        if use_pallas is False or gelu == "erf":
            self.route = "plain"
        elif use_pallas in ("hybrid", "block") and fits and has_gamma:
            self.route = use_pallas
        elif use_pallas is True:
            self.route = "fused" if fits else "dw_ln"
        elif use_pallas in ("mlp", "hybrid") and fits:
            self.route = "ln_mlp" if has_gamma else "mlp"
        else:
            self.route = "plain"
        if self.route == "fused" and self.gamma is None:
            # The whole-block kernel always applies a scale (ones here, a
            # buffer, so its gradient is dropped).
            self.register_buffer("_ones", torch.ones(dim, dtype=f32, device=device))

    def _weights(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        d = self.dtype
        return self.dw_kernel.to(d), self.pw1_weight.to(d), self.pw2_weight.to(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        x = x.to(dtype).contiguous()
        k49, w1t, w2t = self._weights()
        route = self.route
        if route in ("hybrid", "block"):
            block = convnext_block_hybrid if route == "hybrid" else convnext_block_train
            return block(
                x, k49, self.dw_bias, self.norm_scale, self.norm_bias,
                w1t, self.pw1_bias, w2t, self.pw2_bias, self.gamma,
            )
        if route == "fused":
            gamma = self.gamma if self.gamma is not None else self._ones
            return convnext_block_fused(
                x, k49, self.dw_bias, self.norm_scale, self.norm_bias,
                w1t, self.pw1_bias, w2t, self.pw2_bias, gamma,
            )
        if route == "dw_ln":
            y = depthwise_conv7x7_ln(x, k49, self.dw_bias, self.norm_scale, self.norm_bias)
        else:
            weight = k49.t().reshape(self.dim, 1, KERNEL_SIZE, KERNEL_SIZE)
            t = F.conv2d(
                x.permute(0, 3, 1, 2), weight, self.dw_bias.to(dtype),
                padding=PAD, groups=self.dim,
            ).permute(0, 2, 3, 1)
            if route == "ln_mlp":
                return fused_ln_mlp(
                    t.contiguous(), self.norm_scale, self.norm_bias, w1t, self.pw1_bias,
                    w2t, self.pw2_bias, self.gamma, x,
                )
            y = F.layer_norm(
                t.float(), (self.dim,), self.norm_scale, self.norm_bias, 1e-6
            ).to(dtype)
        if route == "mlp":
            return fused_mlp(y.contiguous(), w1t, self.pw1_bias, w2t, self.pw2_bias, residual=x)
        # Plain MLP in the compute dtype, as flax.linen.Dense(dtype=...).
        y = torch.matmul(y, w1t.t()) + self.pw1_bias.to(dtype)
        y = F.gelu(y, approximate="none" if self.gelu == "erf" else "tanh")
        if self.grn is not None:
            y = self.grn(y)
        y = torch.matmul(y, w2t.t()) + self.pw2_bias.to(dtype)
        if self.gamma is not None:
            y = y * self.gamma.to(dtype)
        return x + y


class ConvNeXt(nn.Module):
    """ConvNeXt feature extractor: ``[B, H, W, 3]`` -> ``[B, C]`` f32 (global
    mean pool, then ``head_norm``)."""

    def __init__(
        self, config: ConvNeXtConfig, dtype=torch.float32, gelu: str = "tanh",
        device=None, generator: torch.Generator | None = None,
        use_pallas: bool | str = True, param_dtype=None,
    ) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        dims = config.dims
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.stem_conv = Conv(3, dims[0], 4, 4, padding="SAME", **kw)
        self.stem_norm = LayerNorm(dims[0], device=device)
        for s, (depth, dim) in enumerate(zip(config.depths, dims)):
            if s > 0:
                self.add_module(f"downsample{s}_norm", LayerNorm(dims[s - 1], device=device))
                self.add_module(
                    f"downsample{s}_conv", Conv(dims[s - 1], dim, 2, 2, padding="SAME", **kw)
                )
            for b in range(depth):
                self.add_module(
                    f"stage{s + 1}_block{b + 1}",
                    ConvNeXtBlock(
                        dim, config.use_grn, config.layer_scale_init, gelu=gelu,
                        use_pallas=use_pallas, **kw,
                    ),
                )
        self.head_norm = LayerNorm(dims[-1], device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.stem_conv(x.to(self.dtype))
        x = self.stem_norm(x).to(self.dtype)
        for s, depth in enumerate(cfg.depths):
            if s > 0:
                x = getattr(self, f"downsample{s}_norm")(x).to(self.dtype)
                x = getattr(self, f"downsample{s}_conv")(x)
            x = x.contiguous()
            for b in range(depth):
                x = getattr(self, f"stage{s + 1}_block{b + 1}")(x)
        x = x.mean(dim=(1, 2))
        return self.head_norm(x)
