"""Configurable heads: ``[B, in_features]`` -> ``[B, out_features]``.

Counterpart of ``spine_vision_tpu/models/heads.py``: ``HeadConfig``, the
linear, MLP, self-attention, residual-MLP and 1x1-convolution heads under
the Flax modules' variable names (``LayerNorm_0``, ``Dense_<i>``,
``MultiHeadDotProductAttention_0``, ``input_proj``, ``block<i>_fc1`` ...),
``HeadFactory`` with custom registration, ``create_head`` and
``MultiTaskHead``.

A torch module needs its input width when it is built, so every head takes
``in_features`` (a keyword of :func:`create_head` and
``HeadFactory.create``). The heads compute in ``dtype`` (the model's, as
the JAX ``create_head(config, out, self.dtype)``), their LayerNorms in f32.
Dropout acts in training mode only, through ``models/classifier.py``'s
``dropout``, its masks drawn from the generator passed to ``forward``
(``shard``: this rank's rows of the global batch's, ``ops/draws.py``). ``ConvHead``'s BatchNorm is Flax's ``nn.BatchNorm`` at
its default momentum 0.99, in the head's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Literal

import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.models.layers import (
    Dense,
    FlaxBatchNorm,
    LayerNorm,
    MultiHeadDotProductAttention,
)

HeadType = Literal["mlp", "linear", "attention", "conv", "residual"]


@dataclass(frozen=True)
class HeadConfig:
    """Configuration for model heads."""

    head_type: HeadType = "mlp"
    hidden_dims: tuple[int, ...] = (256,)
    dropout: float = 0.2
    activation: str = "gelu"
    use_layer_norm: bool = True
    num_attention_heads: int = 4
    output_activation: str = "none"


_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "none": lambda x: x,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation function by name."""
    key = name.lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {name}. Available: {list(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]


class _Head(nn.Module):
    """Shared construction: the Dense keywords and the dropout helper."""

    def __init__(self, dtype, device, generator, param_dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self._kw = {"dtype": dtype, "device": device, "generator": generator,
                    "param_dtype": param_dtype}

    def _dense(self, in_dim: int, out_dim: int) -> Dense:
        return Dense(in_dim, out_dim, **self._kw)

    def _drop(self, x, rate, generator, shard):
        # The classifier's dropout (imported here: classifier.py imports this
        # module), so that every dropout of a model draws alike.
        from spine_vision_torch.models.classifier import dropout

        return dropout(x, rate, generator, shard) if self.training else x


class LinearHead(_Head):
    """[LN] -> [dropout] -> Dense -> output activation."""

    def __init__(
        self, in_features: int, out_features: int, dropout: float = 0.0,
        use_layer_norm: bool = False, output_activation: str = "none", dtype=torch.float32,
        device=None, generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__(dtype, device, generator, param_dtype)
        self.rate, self.out_act = dropout, get_activation(output_activation)
        self.LayerNorm_0 = LayerNorm(in_features, device=device) if use_layer_norm else None
        self.Dense_0 = self._dense(in_features, out_features)

    def forward(self, x, generator=None, shard=None):
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x)
        x = self._drop(x, self.rate, generator, shard)
        return self.out_act(self.Dense_0(x))


class MLPHead(_Head):
    """[LN] -> (dropout -> Dense -> act) per hidden layer -> dropout -> Dense
    -> output activation; the dropout rate is full before the first hidden
    layer and half after."""

    def __init__(
        self, in_features: int, out_features: int, hidden_dims: tuple[int, ...] = (256,),
        dropout: float = 0.2, activation: str = "gelu", use_layer_norm: bool = True,
        output_activation: str = "none", dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__(dtype, device, generator, param_dtype)
        self.rate, self.act = dropout, get_activation(activation)
        self.out_act = get_activation(output_activation)
        self.LayerNorm_0 = LayerNorm(in_features, device=device) if use_layer_norm else None
        self.n_hidden = len(hidden_dims)
        dims = (in_features, *hidden_dims, out_features)
        for i in range(len(dims) - 1):
            setattr(self, f"Dense_{i}", self._dense(dims[i], dims[i + 1]))

    def forward(self, x, generator=None, shard=None):
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x)
        for i in range(self.n_hidden):
            x = self._drop(x, self.rate if i == 0 else self.rate / 2, generator, shard)
            x = self.act(getattr(self, f"Dense_{i}")(x))
        x = self._drop(x, self.rate / 2, generator, shard)
        return self.out_act(getattr(self, f"Dense_{self.n_hidden}")(x))


class AttentionHead(_Head):
    """Self-attention pooling: the features as a length-1 sequence, [LN],
    multi-head attention (attention-weight dropout) and dropout added
    residually, the sequence mean, Dense."""

    def __init__(
        self, in_features: int, out_features: int, num_heads: int = 4, dropout: float = 0.2,
        use_layer_norm: bool = True, output_activation: str = "none", dtype=torch.float32,
        device=None, generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__(dtype, device, generator, param_dtype)
        self.rate, self.out_act = dropout, get_activation(output_activation)
        self.LayerNorm_0 = LayerNorm(in_features, device=device) if use_layer_norm else None
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            in_features, num_heads, device=device, generator=generator,
            param_dtype=param_dtype or dtype, dtype=dtype, dropout_rate=dropout)
        self.Dense_0 = self._dense(in_features, out_features)

    def forward(self, x, generator=None, shard=None):
        if x.ndim == 2:
            x = x[:, None, :]
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x).to(self.dtype)
        attn = self.MultiHeadDotProductAttention_0(x, generator, shard).to(self.dtype)
        x = x + self._drop(attn, self.rate, generator, shard)
        return self.out_act(self.Dense_0(x.mean(dim=1)))


class ResidualHead(_Head):
    """[LN] -> ``input_proj`` -> residual MLP blocks ([LN] -> dropout ->
    ``fc1`` -> act -> dropout/2 -> ``fc2``) -> [LN] -> dropout -> ``output_fc``."""

    def __init__(
        self, in_features: int, out_features: int, hidden_dims: tuple[int, ...] = (256,),
        dropout: float = 0.2, activation: str = "gelu", use_layer_norm: bool = True,
        output_activation: str = "none", dtype=torch.float32, device=None,
        generator: torch.Generator | None = None, param_dtype=None,
    ) -> None:
        super().__init__(dtype, device, generator, param_dtype)
        self.rate, self.act = dropout, get_activation(activation)
        self.out_act = get_activation(output_activation)
        self.hidden_dims, self.use_layer_norm = tuple(hidden_dims), use_layer_norm
        width = hidden_dims[0]
        if use_layer_norm:
            self.LayerNorm_0 = LayerNorm(in_features, device=device)
        self.input_proj = self._dense(in_features, width)
        for i, hidden in enumerate(hidden_dims):
            if use_layer_norm:
                setattr(self, f"block{i}_norm", LayerNorm(width, device=device))
            setattr(self, f"block{i}_fc1", self._dense(width, hidden))
            setattr(self, f"block{i}_fc2", self._dense(hidden, width))
        if use_layer_norm:
            self.output_norm = LayerNorm(width, device=device)
        self.output_fc = self._dense(width, out_features)

    def forward(self, x, generator=None, shard=None):
        if self.use_layer_norm:
            x = self.LayerNorm_0(x)
        x = self.input_proj(x)
        for i in range(len(self.hidden_dims)):
            y = getattr(self, f"block{i}_norm")(x) if self.use_layer_norm else x
            y = self._drop(y, self.rate, generator, shard)
            y = self.act(getattr(self, f"block{i}_fc1")(y))
            y = self._drop(y, self.rate / 2, generator, shard)
            x = x + getattr(self, f"block{i}_fc2")(y)
        if self.use_layer_norm:
            x = self.output_norm(x)
        x = self._drop(x, self.rate, generator, shard)
        return self.out_act(self.output_fc(x))


class ConvHead(_Head):
    """1x1 convolutions over the feature channels, as Denses: (``conv<i>`` ->
    Flax BatchNorm ``bn<i>`` -> act -> dropout) per hidden layer, then
    ``conv_out``."""

    def __init__(
        self, in_features: int, out_features: int, hidden_dims: tuple[int, ...] = (256,),
        dropout: float = 0.2, activation: str = "gelu", output_activation: str = "none",
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
        param_dtype=None,
    ) -> None:
        super().__init__(dtype, device, generator, param_dtype)
        self.rate, self.act = dropout, get_activation(activation)
        self.out_act = get_activation(output_activation)
        self.n_hidden = len(hidden_dims)
        width = in_features
        for i, hidden in enumerate(hidden_dims):
            setattr(self, f"conv{i}", self._dense(width, hidden))
            setattr(self, f"bn{i}", FlaxBatchNorm(hidden, device=device, dtype=dtype,
                                                  round_grads=dtype == torch.bfloat16).train())
            width = hidden
        self.conv_out = self._dense(width, out_features)

    def forward(self, x, generator=None, shard=None):
        for i in range(self.n_hidden):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = self._drop(self.act(x), self.rate, generator, shard)
        return self.out_act(self.conv_out(x))


class HeadFactory:
    """Head classes by type name, with custom-type registration."""

    _heads: dict[str, type[nn.Module]] = {
        "linear": LinearHead,
        "mlp": MLPHead,
        "attention": AttentionHead,
        "residual": ResidualHead,
        "conv": ConvHead,
    }

    @classmethod
    def register(cls, name: str) -> Callable[[type[nn.Module]], type[nn.Module]]:
        def decorator(head_cls: type[nn.Module]) -> type[nn.Module]:
            cls._heads[name] = head_cls
            return head_cls

        return decorator

    @classmethod
    def create(cls, head_type: str, out_features: int, **kwargs: Any) -> nn.Module:
        """``kwargs`` include the head's ``in_features``."""
        if head_type not in cls._heads:
            available = ", ".join(cls._heads)
            raise KeyError(f"Unknown head type: {head_type}. Available: {available}")
        return cls._heads[head_type](out_features=out_features, **kwargs)

    @classmethod
    def list_heads(cls) -> list[str]:
        return list(cls._heads)


def create_head(
    config: HeadConfig, out_features: int, dtype=torch.float32, *, in_features: int,
    device=None, generator: torch.Generator | None = None, param_dtype=None,
) -> nn.Module:
    """A head from its configuration, computing in ``dtype``."""
    kwargs: dict[str, Any] = {
        "in_features": in_features, "dropout": config.dropout,
        "output_activation": config.output_activation, "dtype": dtype, "device": device,
        "generator": generator, "param_dtype": param_dtype,
    }
    if config.head_type in ("mlp", "residual", "conv"):
        kwargs["hidden_dims"] = tuple(config.hidden_dims)
        kwargs["activation"] = config.activation
    if config.head_type in ("mlp", "linear", "residual", "attention"):
        kwargs["use_layer_norm"] = config.use_layer_norm
    if config.head_type == "attention":
        kwargs["num_heads"] = config.num_attention_heads
    return HeadFactory.create(config.head_type, out_features, **kwargs)


class MultiTaskHead(nn.Module):
    """One head per task (Flax's ``heads_<task>``): features -> ``{task:
    logits}``."""

    def __init__(
        self, task_configs: dict[str, tuple[int, HeadConfig]], in_features: int,
        dtype=torch.float32, device=None, generator: torch.Generator | None = None,
        param_dtype=None,
    ) -> None:
        super().__init__()
        self.task_configs = dict(task_configs)
        for name, (out_features, head_config) in self.task_configs.items():
            self.add_module(f"heads_{name}", create_head(
                head_config, out_features, dtype, in_features=in_features, device=device,
                generator=generator, param_dtype=param_dtype))

    def forward(self, x, generator=None, shard=None) -> dict[str, torch.Tensor]:
        return {name: getattr(self, f"heads_{name}")(x, generator, shard)
                for name in self.task_configs}

    @property
    def task_names(self) -> list[str]:
        return list(self.task_configs)
