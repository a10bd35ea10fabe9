"""Swin Transformer backbones (tiny, small, base), NHWC.

Counterpart of ``spine_vision_tpu/models/swin.py``, with its arithmetic and
its quirks kept:

- window attention with the relative-position bias table and index of the
  JAX module, the shifted windows' additive -100 mask, and the softmax in
  f32, cast back to the model's dtype;
- a feature map whose sides are not multiples of the window is zero-padded
  after ``norm1`` and cropped after the attention; the padded tokens are not
  masked out of the attention (at 256² the stage grids 64/32/16/8 pad to
  70/35/21/14);
- the shift is 0 when the padded grid is no larger than the window;
- ``PatchMerging`` concatenates each 2x2 neighbourhood in the JAX reshape's
  order ((0, 0), (0, 1), (1, 0), (1, 1)), an odd side padded with zeros.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.models.layers import Conv, Dense, LayerNorm


@dataclass(frozen=True)
class SwinConfig:
    """Architecture hyperparameters for a Swin backbone."""

    embed_dim: int
    depths: tuple[int, ...]
    num_heads: tuple[int, ...]
    window_size: int = 7

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


SWIN_CONFIGS: dict[str, SwinConfig] = {
    "swin_tiny": SwinConfig(96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "swin_small": SwinConfig(96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "swin_base": SwinConfig(128, (2, 2, 18, 2), (4, 8, 16, 32)),
}


@lru_cache(maxsize=8)
def relative_position_index(window_size: int) -> np.ndarray:
    """``[ws*ws, ws*ws]`` index into the relative bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    relative = (coords_flat[:, :, None] - coords_flat[:, None, :]).transpose(1, 2, 0)
    relative[:, :, 0] += ws - 1
    relative[:, :, 1] += ws - 1
    relative[:, :, 0] *= 2 * ws - 1
    return relative.sum(-1)


@lru_cache(maxsize=32)
def attention_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Shifted-window mask ``[nW, ws*ws, ws*ws]``: -100 between tokens of
    different regions, else 0."""
    img_mask = np.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    windows = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    windows = windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B * nH * nW, ws*ws, C]``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    c = windows.shape[-1]
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class WindowAttention(nn.Module):
    """Multi-head window attention with a relative position bias: the
    ``qkv`` and ``proj`` Denses and the ``relative_position_bias_table``
    ``[(2 ws - 1)², heads]`` (f32, or ``param_dtype``)."""

    def __init__(
        self, dim: int, num_heads: int, window_size: int, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        self.dim, self.num_heads, self.window_size, self.dtype = dim, num_heads, window_size, dtype
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.qkv = Dense(dim, dim * 3, **kw)
        self.proj = Dense(dim, dim, **kw)
        table = torch.nn.init.trunc_normal_(
            torch.empty((2 * window_size - 1) ** 2, num_heads), 0.0, 0.02, -0.04, 0.04,
            generator=generator)
        self.relative_position_bias_table = nn.Parameter(
            table.to(dtype=param_dtype or torch.float32, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        bw, n, c = x.shape
        heads = self.num_heads
        hd = self.dim // heads
        qkv = self.qkv(x).reshape(bw, n, 3, heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("bnhd,bmhd->bhnm", q * hd**-0.5, k)
        index = torch.as_tensor(relative_position_index(self.window_size).reshape(-1),
                                device=x.device)
        bias = self.relative_position_bias_table[index].reshape(n, n, heads)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(bw, heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """(Shifted-)window attention and an erf-GELU MLP, pre-LN, residual."""

    def __init__(
        self, dim: int, num_heads: int, window_size: int, shift: int, dtype=torch.float32,
        device=None, generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        self.window_size, self.shift, self.dtype = window_size, shift, dtype
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn = WindowAttention(dim, num_heads, window_size, **kw)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.fc1 = Dense(dim, dim * 4, **kw)
        self.fc2 = Dense(dim * 4, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        ws = self.window_size
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        hp, wp = h + pad_h, w + pad_w
        shift = self.shift if min(hp, wp) > ws else 0
        y = self.norm1(x).to(self.dtype)
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = torch.as_tensor(attention_mask(hp, wp, ws, shift), device=x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, b, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        y = F.gelu(self.fc1(self.norm2(x).to(self.dtype)), approximate="none")
        return x + self.fc2(y)


class PatchMerging(nn.Module):
    """2x downsampling: the 2x2 neighbourhood concatenated -> LayerNorm ->
    Dense(2 * dim) without bias (Flax's auto-named ``LayerNorm_0`` and
    ``Dense_0``)."""

    def __init__(
        self, dim: int, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(4 * dim, eps=1e-5, device=device)
        self.Dense_0 = Dense(4 * dim, 2 * dim, dtype=dtype, device=device, generator=generator,
                             param_dtype=param_dtype, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            h, w = h + h % 2, w + w % 2
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // 2, w // 2, 4 * c)
        return self.Dense_0(self.LayerNorm_0(x).to(self.dtype))


class SwinTransformer(nn.Module):
    """``[B, H, W, 3]`` -> ``[B, num_features]`` f32 pooled features."""

    def __init__(
        self, config: SwinConfig, dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__()
        self.config, self.dtype = config, dtype
        kw = {"dtype": dtype, "device": device, "generator": generator,
              "param_dtype": param_dtype}
        self.patch_embed = Conv(3, config.embed_dim, 4, 4, **kw)
        self.patch_norm = LayerNorm(config.embed_dim, eps=1e-5, device=device)
        for s, (depth, heads) in enumerate(zip(config.depths, config.num_heads)):
            dim = config.embed_dim * 2**s
            if s > 0:
                self.add_module(f"merge{s}", PatchMerging(dim // 2, **kw))
            for b in range(depth):
                shift = 0 if b % 2 == 0 else config.window_size // 2
                self.add_module(f"stage{s + 1}_block{b + 1}", SwinBlock(
                    dim, heads, config.window_size, shift, **kw))
        self.norm = LayerNorm(config.num_features, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_norm(self.patch_embed(x.to(self.dtype))).to(self.dtype)
        for s, depth in enumerate(self.config.depths):
            if s > 0:
                x = getattr(self, f"merge{s}")(x)
            for b in range(depth):
                x = getattr(self, f"stage{s + 1}_block{b + 1}")(x)
        return self.norm(x).mean(dim=(1, 2)).float()
