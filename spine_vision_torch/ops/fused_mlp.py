"""The two constants of ``spine_vision_tpu/ops/fused_mlp.py`` that the ConvNeXt
block dispatch needs. The fused MLP kernels themselves are not ported yet
(ROADMAP, Queue 2)."""

from __future__ import annotations

import math

import torch

# Widest block whose MLP runs inside the whole-block kernel; wider blocks run
# the dwconv+LN kernel followed by a plain MLP.
MAX_FUSED_DIM = 512

_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, the ConvNeXt block MLP's activation (the same
    formula as the kernels; ``torch.nn.GELU()`` defaults to erf)."""
    u = _GELU_C * (x + _GELU_A * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))
