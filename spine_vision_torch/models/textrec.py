"""Text recognition network (conv + transformer encoder + CTC) for report OCR.

Counterpart of ``spine_vision_tpu/models/textrec.py``: a conv stack pools a
32-row patch to one row, a small pre-LN transformer encoder contextualises
the sequence, and a dense head gives per-step charset + blank logits, decoded
greedily on the host. The charset is this module's own copy of the JAX
package's.

The Flax net's bf16 arithmetic is computed as XLA runs it, each value in
f32 and rounded to bf16 (``bf16_round``) where XLA rounds it. XLA computes
every bf16 operation in f32 and rounds its result, except where the model
casts that result up to f32 (excess precision, XLA's default): so the
convolutions' sums (which the f32 BatchNorm takes) and the bias adds that
end the attention and the MLP (which the f32 residual stream takes) stay in
f32, while the dense products, the other bias adds and each step of the
tanh-GELU are rounded. The values the model casts to bf16 are rounded: the
input, each convolution's and dense layer's input, the positional embedding;
kernels and biases are stored in bf16.

Variables carry the Flax names (``Conv_<i>``, ``BatchNorm_<i>``,
``LayerNorm_<i>``, ``MultiHeadDotProductAttention_<i>``, ``Dense_<i>``,
``pos_embedding``), so ``models/convert.py`` fills the net from the JAX
package's trees and from its shipped ``.npz`` weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from spine_vision_torch.core.registry import register_model
from spine_vision_torch.models.layers import (
    Conv,
    Dense,
    FlaxBatchNorm,
    LayerNorm,
    MultiHeadDotProductAttention,
    bf16_input,
    bf16_round,
)

# Vietnamese charset: digits, ASCII letters, accented vowels + đ, punctuation.
_VIETNAMESE_EXTRA = (
    "àáảãạăằắẳẵặâầấẩẫậèéẻẽẹêềếểễệìíỉĩịòóỏõọôồốổỗộơờớởỡợ"
    "ùúủũụưừứửữựỳýỷỹỵđ"
)
VIETNAMESE_CHARSET = (
    "0123456789"
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    + _VIETNAMESE_EXTRA
    + _VIETNAMESE_EXTRA.upper()
    + " .,:;/-()%&+*'\"!?#@_="
)
BLANK_ID = 0  # CTC blank; character i maps to logit index i + 1.


def charset_size() -> int:
    return len(VIETNAMESE_CHARSET) + 1


def _dense_bf16(dense: Dense, x: torch.Tensor) -> torch.Tensor:
    """Flax ``Dense(dtype=bfloat16)`` as XLA runs it: the bf16-rounded input
    times the bf16 kernel summed in f32 and rounded, plus the bf16 bias; the
    sum is returned in f32 (the caller rounds it where XLA does)."""
    y = bf16_round(torch.matmul(bf16_round(x), bf16_round(dense.weight).t()))
    return y + bf16_round(dense.bias)


def _gelu_tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` on a bf16 ``x``, each operation
    rounded to bf16: ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 *
    x**3)))`` in ``jax.nn.gelu``'s order, with its constants in bf16."""
    x = x.to(torch.bfloat16)
    c = {v: torch.tensor(v, dtype=torch.bfloat16, device=x.device)
         for v in (math.sqrt(2 / math.pi), 0.044715, 0.5, 1.0)}
    inner = c[math.sqrt(2 / math.pi)] * (x + c[0.044715] * (x * x * x))
    return (x * (c[0.5] * (c[1.0] + torch.tanh(inner)))).float()


@register_model("text_recognition")
class TextRecognitionNet(nn.Module):
    """CRNN-style recognizer: ``[B, 32, W, 1]`` f32 -> CTC logits
    ``[B, W/4, charset_size()]`` f32.

    Five conv + BatchNorm + ReLU layers (strides (2, 2), (2, 2), then (2, 1)
    three times) pool the height 32 -> 1 and the width by 4; the positional
    embedding, rounded to bf16, is added; ``num_layers`` pre-LN encoder
    layers (LayerNorm -> attention -> residual, LayerNorm -> Dense 2C ->
    tanh-GELU -> Dense C -> residual) run on the f32 residual stream; a final
    LayerNorm and an f32 Dense give the logits. ``patch_width`` fixes the
    embedding's length W/4. ``param_dtype=torch.float32`` keeps f32 master
    variables for training (Flax's default; they are rounded to bf16 where
    the Flax net casts them), and ``forward(x, train=True)`` is Flax's
    ``apply(..., train=True)``: the BatchNorms use and update the batch
    statistics.
    """

    def __init__(self, width: int = 64, num_layers: int = 2, num_heads: int = 4,
                 patch_width: int = 256, device=None,
                 generator: torch.Generator | None = None,
                 param_dtype=torch.bfloat16) -> None:
        super().__init__()
        self.num_layers = num_layers
        w = width
        kw = {"device": device, "generator": generator}
        bf16 = {"param_dtype": param_dtype, **kw}
        convs = ((1, w, (2, 2)), (w, 2 * w, (2, 2)), (2 * w, 4 * w, (2, 1)),
                 (4 * w, 4 * w, (2, 1)), (4 * w, 4 * w, (2, 1)))
        for i, (cin, cout, stride) in enumerate(convs):
            setattr(self, f"Conv_{i}", Conv(cin, cout, 3, stride, padding="SAME", bias=False,
                                            bf16_kernel=True, **bf16))
            setattr(self, f"BatchNorm_{i}", FlaxBatchNorm(cout, device=device))
        c = 4 * w
        self.pos_embedding = nn.Parameter(
            0.02 * torch.randn(1, patch_width // 4, c, generator=generator).to(device)
        )
        for i in range(num_layers):
            setattr(self, f"LayerNorm_{2 * i}", LayerNorm(c, device=device))
            setattr(self, f"MultiHeadDotProductAttention_{i}",
                    MultiHeadDotProductAttention(c, num_heads, param_dtype=param_dtype, **kw))
            setattr(self, f"LayerNorm_{2 * i + 1}", LayerNorm(c, device=device))
            setattr(self, f"Dense_{2 * i}", Dense(c, 2 * c, **bf16))
            setattr(self, f"Dense_{2 * i + 1}", Dense(2 * c, c, **bf16))
        setattr(self, f"LayerNorm_{2 * num_layers}", LayerNorm(c, device=device))
        setattr(self, f"Dense_{2 * num_layers}", Dense(c, charset_size(), **kw))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(5):
            conv = getattr(self, f"Conv_{i}")(bf16_input(x))
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(conv, train))
        seq = x[:, 0] + bf16_round(self.pos_embedding)
        for i in range(self.num_layers):
            attn_in = getattr(self, f"LayerNorm_{2 * i}")(seq)
            seq = seq + getattr(self, f"MultiHeadDotProductAttention_{i}")(attn_in)
            mlp_in = getattr(self, f"LayerNorm_{2 * i + 1}")(seq)
            mlp = _gelu_tanh_bf16(_dense_bf16(getattr(self, f"Dense_{2 * i}"), mlp_in))
            seq = seq + _dense_bf16(getattr(self, f"Dense_{2 * i + 1}"), mlp)
        seq = getattr(self, f"LayerNorm_{2 * self.num_layers}")(seq)
        return getattr(self, f"Dense_{2 * self.num_layers}")(seq)


def ctc_greedy_decode(logits: np.ndarray) -> list[str]:
    """Greedy CTC decode: argmax, collapse repeats, drop blanks.

    Args:
        logits: ``[B, T, C]`` CTC logits (host numpy).

    Returns:
        One decoded string per batch row.
    """
    ids = np.argmax(logits, axis=-1)  # [B, T]
    texts = []
    for row in ids:
        chars = []
        previous = -1
        for token in row:
            if token != previous and token != BLANK_ID:
                chars.append(VIETNAMESE_CHARSET[token - 1])
            previous = token
        texts.append("".join(chars))
    return texts
