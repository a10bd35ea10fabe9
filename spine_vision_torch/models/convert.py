"""Carry Flax variable trees into the port's modules.

:func:`load_flax_variables` takes the JAX package's variables as nested dicts
of numpy arrays, under the JAX package's names
(``backbone/stage1_block1/dwconv/kernel``, ``head_fc1/kernel``,
``batch_stats/.../stem_bn/mean`` ...), and fills the port's modules, changing
each layout once, at load time:

- convolution kernels HWIO -> OIHW (``F.conv2d``);
- depthwise ConvNeXt kernels ``[7, 7, 1, C]`` -> tap-major ``[49, C]``;
- Dense kernels ``[in, out]`` -> ``[out, in]`` (the layout the block kernel and
  ``torch.matmul(x, W.t())`` read).

:func:`random_flax_variables` builds such a tree from a seed with numpy, for
a module's own shapes: a run without JAX can carry weights exactly as a
checkpoint would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch import nn

from spine_vision_torch.models.convnext import GRN, ConvNeXtBlock
from spine_vision_torch.models.layers import Conv, Dense, LayerNorm
from spine_vision_torch.ops.batchnorm import BatchNorm

Tree = dict[str, Any]


@dataclass
class _Entry:
    collection: str  # "params" | "batch_stats"
    path: tuple[str, ...]
    flax_shape: tuple[int, ...]
    target: torch.Tensor
    to_torch: Callable[[np.ndarray], np.ndarray]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _entries_of(name: str, mod: nn.Module) -> Iterator[_Entry]:
    p = tuple(name.split(".")) if name else ()
    if isinstance(mod, Conv):
        o, i, kh, kw = mod.weight.shape
        yield _Entry("params", p + ("kernel",), (kh, kw, i, o), mod.weight, _hwio_to_oihw)
        if mod.bias is not None:
            yield _Entry("params", p + ("bias",), (o,), mod.bias, _same)
    elif isinstance(mod, Dense):
        o, i = mod.weight.shape
        yield _Entry("params", p + ("kernel",), (i, o), mod.weight, _transpose)
        yield _Entry("params", p + ("bias",), (o,), mod.bias, _same)
    elif isinstance(mod, LayerNorm):
        c = mod.scale.shape[0]
        yield _Entry("params", p + ("scale",), (c,), mod.scale, _same)
        yield _Entry("params", p + ("bias",), (c,), mod.bias, _same)
    elif isinstance(mod, BatchNorm):
        c = mod.scale.shape[0]
        yield _Entry("params", p + ("scale",), (c,), mod.scale, _same)
        yield _Entry("params", p + ("bias",), (c,), mod.bias, _same)
        yield _Entry("batch_stats", p + ("mean",), (c,), mod.mean, _same)
        yield _Entry("batch_stats", p + ("var",), (c,), mod.var, _same)
    elif isinstance(mod, GRN):
        c = mod.gamma.shape[0]
        yield _Entry("params", p + ("gamma",), (c,), mod.gamma, _same)
        yield _Entry("params", p + ("beta",), (c,), mod.beta, _same)
    elif isinstance(mod, ConvNeXtBlock):
        c = mod.dim
        yield _Entry(
            "params", p + ("dwconv", "kernel"), (7, 7, 1, c), mod.dw_kernel,
            lambda a: a.reshape(49, a.shape[-1]),
        )
        yield _Entry("params", p + ("dwconv", "bias"), (c,), mod.dw_bias, _same)
        yield _Entry("params", p + ("norm", "scale"), (c,), mod.norm_scale, _same)
        yield _Entry("params", p + ("norm", "bias"), (c,), mod.norm_bias, _same)
        yield _Entry("params", p + ("pwconv1", "kernel"), (c, 4 * c), mod.pw1_weight, _transpose)
        yield _Entry("params", p + ("pwconv1", "bias"), (4 * c,), mod.pw1_bias, _same)
        yield _Entry("params", p + ("pwconv2", "kernel"), (4 * c, c), mod.pw2_weight, _transpose)
        yield _Entry("params", p + ("pwconv2", "bias"), (c,), mod.pw2_bias, _same)
        if mod.gamma is not None:
            yield _Entry("params", p + ("gamma",), (c,), mod.gamma, _same)


def _entries(module: nn.Module) -> list[_Entry]:
    return [e for name, mod in module.named_modules() for e in _entries_of(name, mod)]


def _leaves(tree: Tree, prefix: tuple[str, ...] = ()) -> Iterator[tuple[str, ...]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,)


def load_flax_variables(
    module: nn.Module, params: Tree, batch_stats: Tree | None = None
) -> nn.Module:
    """Fill ``module`` in place from Flax ``params`` (and ``batch_stats``).

    Every variable of the module must be in the trees with the Flax shape,
    and every leaf of the trees must be used; anything else raises.
    """
    trees = {"params": params, "batch_stats": batch_stats or {}}
    used: set[tuple[str, ...]] = set()
    for e in _entries(module):
        node: Any = trees[e.collection]
        for key in e.path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"{e.collection}/{'/'.join(e.path)} missing from the Flax tree")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != e.flax_shape:
            raise ValueError(
                f"{e.collection}/{'/'.join(e.path)}: Flax shape {arr.shape}, "
                f"expected {e.flax_shape}"
            )
        value = torch.from_numpy(np.ascontiguousarray(e.to_torch(arr.astype(np.float32))))
        with torch.no_grad():
            e.target.copy_(value.to(dtype=e.target.dtype))
        used.add((e.collection,) + e.path)
    for collection, tree in trees.items():
        unused = [p for p in _leaves(tree) if (collection,) + p not in used]
        if unused:
            raise KeyError(f"unused {collection} leaves: {['/'.join(p) for p in unused[:5]]}")
    return module


def _random_leaf(rng: np.random.Generator, e: _Entry) -> np.ndarray:
    shape, leaf = e.flax_shape, e.path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(size=shape) / np.sqrt(fan_in)
    if leaf == "var":
        return rng.uniform(0.5, 1.5, size=shape)
    if leaf == "scale":
        return 1.0 + 0.1 * rng.normal(size=shape)
    if leaf == "gamma" and len(e.path) > 1 and e.path[-2] != "grn":
        return 0.1 + 0.05 * rng.normal(size=shape)  # LayerScale, active enough to test
    return 0.05 * rng.normal(size=shape)


def random_flax_variables(module: nn.Module, seed: int) -> tuple[Tree, Tree]:
    """Seeded numpy ``(params, batch_stats)`` trees in the Flax layout of
    ``module``'s variables."""
    rng = np.random.default_rng(seed)
    trees: dict[str, Tree] = {"params": {}, "batch_stats": {}}
    for e in _entries(module):
        node = trees[e.collection]
        for key in e.path[:-1]:
            node = node.setdefault(key, {})
        node[e.path[-1]] = _random_leaf(rng, e).astype(np.float32)
    return trees["params"], trees["batch_stats"]
