"""Vision Transformer backbones (ViT and DeiT), NHWC input.

Counterpart of ``spine_vision_tpu/models/vit.py``: a patch-embedding
convolution, a class token, learned position embeddings for the 224² grid
(14x14 at patch 16), pre-LN encoder blocks (LayerNorm epsilon 1e-6 in f32,
Flax's ``MultiHeadDotProductAttention`` as ``models/layers.py`` holds it,
an erf-GELU MLP), a final LayerNorm, and the class token as the features.

At another grid the grid's position embeddings are resized as
``jax.image.resize(..., "bilinear")`` resizes them: a separable triangle
filter with half-pixel centres whose support widens by the scale when the
grid shrinks (antialiasing), the weights normalised over the taps inside
the grid. Growing (14 -> 16, 14 -> 32) that is a plain bilinear resize;
shrinking (14 -> 8) it is not, so the weights are built here, in the JAX
function's arithmetic (:func:`resize_weights`), and applied as two
products.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.models.layers import Conv, Dense, LayerNorm, MultiHeadDotProductAttention


@dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters for a ViT backbone."""

    patch_size: int
    hidden_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0

    @property
    def num_features(self) -> int:
        return self.hidden_dim


VIT_CONFIGS: dict[str, ViTConfig] = {
    "vit_tiny": ViTConfig(16, 192, 12, 3),
    "vit_small": ViTConfig(16, 384, 12, 6),
    "vit_base": ViTConfig(16, 768, 12, 12),
    "vit_large": ViTConfig(16, 1024, 24, 16),
    "deit_tiny": ViTConfig(16, 384, 12, 6),  # the JAX package maps deit_tiny to deit3_small
    "deit_small": ViTConfig(16, 384, 12, 6),
    "deit_base": ViTConfig(16, 768, 12, 12),
}


@lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in, out]`` f32 weights of ``jax.image.resize``'s bilinear (triangle)
    filter along one axis, antialiased (``compute_weight_mat`` with
    ``antialias=True``)."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_grid(grid: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``[1, h, w, C]`` -> ``[1, oh, ow, C]`` as ``jax.image.resize(grid,
    (1, oh, ow, C), "bilinear")``."""
    _, h, w, _ = grid.shape
    kw = {"dtype": grid.dtype, "device": grid.device}
    out = grid
    if h != out_hw[0]:
        out = torch.einsum("bhwc,hy->bywc", out, torch.as_tensor(resize_weights(h, out_hw[0]), **kw))
    if w != out_hw[1]:
        out = torch.einsum("bhwc,wx->bhxc", out, torch.as_tensor(resize_weights(w, out_hw[1]), **kw))
    return out


class TransformerBlock(nn.Module):
    """Pre-LN encoder block: LN -> attention -> residual, LN -> Dense ->
    erf-GELU -> Dense -> residual, the stream in the model's dtype."""

    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = MultiHeadDotProductAttention(
            dim, num_heads, device=device, generator=generator,
            param_dtype=param_dtype or dtype, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Dense(dim, hidden, **kw)
        self.fc2 = Dense(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x).to(self.dtype)).to(self.dtype)
        y = F.gelu(self.fc1(self.norm2(x).to(self.dtype)), approximate="none")
        return x + self.fc2(y)


class ViT(nn.Module):
    """``[B, H, W, 3]`` -> ``[B, hidden_dim]`` f32 class-token features."""

    def __init__(
        self, config: ViTConfig, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None, pos_embed_grid: int = 14,
    ) -> None:
        super().__init__()
        self.config, self.dtype, self.pos_embed_grid = config, dtype, pos_embed_grid
        d, p = config.hidden_dim, config.patch_size
        self.patch_embed = Conv(3, d, p, p, dtype=dtype, device=device, generator=generator,
                                param_dtype=param_dtype)
        f32 = {"dtype": param_dtype or dtype, "device": device}
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, **f32))
        pos = torch.randn(1, pos_embed_grid**2 + 1, d, generator=generator) * 0.02
        self.pos_embed = nn.Parameter(pos.to(**f32))
        for i in range(config.depth):
            self.add_module(f"block{i + 1}", TransformerBlock(
                d, config.num_heads, config.mlp_ratio, dtype=dtype, device=device,
                generator=generator, param_dtype=param_dtype))
        self.norm = LayerNorm(d, eps=1e-6, device=device)

    def position_embeddings(self, gh: int, gw: int) -> torch.Tensor:
        """``[1, 1 + gh * gw, D]``: the class token's embedding and the grid's,
        resized from the training grid when it differs."""
        g = self.pos_embed_grid
        pos = self.pos_embed
        if (gh, gw) == (g, g):
            return pos
        d = pos.shape[-1]
        grid = resize_grid(pos[:, 1:].reshape(1, g, g, d), (gh, gw))
        return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, d)], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = x.to(self.dtype)
        b, h, w, _ = x.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        x = self.patch_embed(x).reshape(b, gh * gw, cfg.hidden_dim)
        cls = self.cls_token.to(self.dtype).expand(b, 1, cfg.hidden_dim)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings(gh, gw).to(self.dtype)
        for i in range(cfg.depth):
            x = getattr(self, f"block{i + 1}")(x)
        return self.norm(x)[:, 0, :].float()
