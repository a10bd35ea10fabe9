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
checkpoint would. :func:`export_flax_variables` is the inverse of the load:
the port's variables (f32 master weights after training steps, say) back as a
Flax-layout numpy tree.

The OCR nets (``models/textdet.py``, ``models/textrec.py``) load the same
way: their attention's ``[C, heads, d]`` kernels and ``pos_embedding`` keep
the Flax layout, :func:`load_variables_npz` reads the JAX package's flat
``.npz`` of them (the shipped OCR weights), and :func:`save_variables_npz`
writes trained nets' trees (:func:`export_flax_variables`) in that format.

Grouped and depthwise convolution kernels (``[kh, kw, in/groups, out]``)
take the plain convolution's transpose; the zoo's other leaves keep their
Flax layout: ViT's ``cls_token`` and ``pos_embed``, Swin's
``relative_position_bias_table``, the attention's ``[C, heads, d]`` kernels.

The pretrained-weights half is the JAX module's own: a torchvision or timm
state-dict file (``.pth``/``.pt``) of any backbone family is rewritten into
Flax-layout ``(params, batch_stats)`` trees (:func:`convert_resnet_state_dict`,
:func:`convert_convnext_state_dict` in both ConvNeXt namings,
:func:`convert_vit_state_dict`, :func:`convert_swin_state_dict` with timm's
2x2 merge order permuted to the JAX reshape's,
:func:`convert_efficientnet_state_dict`,
:func:`convert_mobilenetv3_state_dict`), kept as a flat ``.npz`` artifact
whose keys and ``__meta__/arch`` are the JAX package's
(:func:`convert_checkpoint`, :func:`save_backbone_npz`,
:func:`load_backbone_npz`), and loaded from either form
(:func:`load_pretrained_backbone`). A trainer carries the trees into its
backbone with :func:`load_flax_variables`. The converters read plain
mappings of tensors or arrays; timm is not needed.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from spine_vision_torch.models.convnext import GRN, ConvNeXtBlock
from spine_vision_torch.models.layers import Conv, Dense, LayerNorm, MultiHeadDotProductAttention
from spine_vision_torch.models.swin import WindowAttention
from spine_vision_torch.models.textrec import TextRecognitionNet
from spine_vision_torch.models.vit import VIT_CONFIGS, ViT
from spine_vision_torch.ops.batchnorm import BatchNorm

Tree = dict[str, Any]

logger = logging.getLogger("spine_vision_torch")


@dataclass
class _Entry:
    collection: str  # "params" | "batch_stats"
    path: tuple[str, ...]
    flax_shape: tuple[int, ...]
    target: torch.Tensor
    to_torch: Callable[[np.ndarray], np.ndarray]
    to_flax: Callable[[np.ndarray], np.ndarray]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0)


def _taps_to_hwio(a: np.ndarray) -> np.ndarray:
    return a.reshape(7, 7, 1, a.shape[-1])


def _hwio_to_taps(a: np.ndarray) -> np.ndarray:
    return a.reshape(49, a.shape[-1])


def _entries_of(name: str, mod: nn.Module) -> Iterator[_Entry]:
    p = tuple(name.split(".")) if name else ()
    if isinstance(mod, Conv):
        o, i, kh, kw = mod.weight.shape
        yield _Entry(
            "params", p + ("kernel",), (kh, kw, i, o), mod.weight, _hwio_to_oihw, _oihw_to_hwio
        )
        if mod.bias is not None:
            yield _Entry("params", p + ("bias",), (o,), mod.bias, _same, _same)
    elif isinstance(mod, Dense):
        o, i = mod.weight.shape
        yield _Entry("params", p + ("kernel",), (i, o), mod.weight, _transpose, _transpose)
        if mod.bias is not None:
            yield _Entry("params", p + ("bias",), (o,), mod.bias, _same, _same)
    elif isinstance(mod, LayerNorm):
        c = mod.scale.shape[0]
        yield _Entry("params", p + ("scale",), (c,), mod.scale, _same, _same)
        yield _Entry("params", p + ("bias",), (c,), mod.bias, _same, _same)
    elif isinstance(mod, BatchNorm):
        c = mod.scale.shape[0]
        yield _Entry("params", p + ("scale",), (c,), mod.scale, _same, _same)
        yield _Entry("params", p + ("bias",), (c,), mod.bias, _same, _same)
        yield _Entry("batch_stats", p + ("mean",), (c,), mod.mean, _same, _same)
        yield _Entry("batch_stats", p + ("var",), (c,), mod.var, _same, _same)
    elif isinstance(mod, GRN):
        c = mod.gamma.shape[0]
        yield _Entry("params", p + ("gamma",), (c,), mod.gamma, _same, _same)
        yield _Entry("params", p + ("beta",), (c,), mod.beta, _same, _same)
    elif isinstance(mod, ConvNeXtBlock):
        c = mod.dim
        yield _Entry(
            "params", p + ("dwconv", "kernel"), (7, 7, 1, c), mod.dw_kernel,
            _hwio_to_taps, _taps_to_hwio,
        )
        yield _Entry("params", p + ("dwconv", "bias"), (c,), mod.dw_bias, _same, _same)
        yield _Entry("params", p + ("norm", "scale"), (c,), mod.norm_scale, _same, _same)
        yield _Entry("params", p + ("norm", "bias"), (c,), mod.norm_bias, _same, _same)
        yield _Entry(
            "params", p + ("pwconv1", "kernel"), (c, 4 * c), mod.pw1_weight, _transpose, _transpose
        )
        yield _Entry("params", p + ("pwconv1", "bias"), (4 * c,), mod.pw1_bias, _same, _same)
        yield _Entry(
            "params", p + ("pwconv2", "kernel"), (4 * c, c), mod.pw2_weight, _transpose, _transpose
        )
        yield _Entry("params", p + ("pwconv2", "bias"), (c,), mod.pw2_bias, _same, _same)
        if mod.gamma is not None:
            yield _Entry("params", p + ("gamma",), (c,), mod.gamma, _same, _same)
    elif isinstance(mod, MultiHeadDotProductAttention):
        for name in ("query", "key", "value", "out"):
            kernel, bias = getattr(mod, f"{name}_kernel"), getattr(mod, f"{name}_bias")
            yield _Entry("params", p + (name, "kernel"), tuple(kernel.shape), kernel, _same, _same)
            yield _Entry("params", p + (name, "bias"), tuple(bias.shape), bias, _same, _same)
    elif isinstance(mod, TextRecognitionNet):
        pos = mod.pos_embedding
        yield _Entry("params", p + ("pos_embedding",), tuple(pos.shape), pos, _same, _same)
    elif isinstance(mod, ViT):
        for leaf in ("cls_token", "pos_embed"):
            t = getattr(mod, leaf)
            yield _Entry("params", p + (leaf,), tuple(t.shape), t, _same, _same)
    elif isinstance(mod, WindowAttention):
        t = mod.relative_position_bias_table
        yield _Entry("params", p + ("relative_position_bias_table",), tuple(t.shape), t, _same,
                     _same)


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


def export_flax_variables(module: nn.Module, grads: bool = False) -> tuple[Tree, Tree]:
    """The module's variables as f32 numpy ``(params, batch_stats)`` trees in
    the Flax layout and names (the inverse of :func:`load_flax_variables`).
    With ``grads``, the parameters' ``.grad`` instead (zeros where a
    parameter has none), in the same layout."""
    trees: dict[str, Tree] = {"params": {}, "batch_stats": {}}
    for e in _entries(module):
        node = trees[e.collection]
        for key in e.path[:-1]:
            node = node.setdefault(key, {})
        source = e.target
        if grads:
            source = e.target.grad if e.target.grad is not None else torch.zeros_like(e.target)
        value = source.detach().float().cpu().numpy()
        node[e.path[-1]] = np.ascontiguousarray(e.to_flax(value))
    return trees["params"], trees["batch_stats"]


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


# ---------------------------------------------------------------------------
# Pretrained torch checkpoints -> Flax-layout trees (the JAX package's
# conversions: OIHW -> HWIO, depthwise (C,1,kh,kw) -> (kh,kw,1,C), linear
# (out,in) -> (in,out), BatchNorm weight/bias/running stats -> scale/bias +
# batch_stats, LayerNorm weight/bias -> scale/bias).
# ---------------------------------------------------------------------------


def _np(tensor: Any) -> np.ndarray:
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def _conv(tensor: Any) -> np.ndarray:
    return _np(tensor).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _dwconv(tensor: Any) -> np.ndarray:
    return _np(tensor).transpose(2, 3, 1, 0)  # (C,1,kh,kw) -> (kh,kw,1,C)


def _linear(tensor: Any) -> np.ndarray:
    return _np(tensor).transpose(1, 0)  # (out,in) -> (in,out)


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def convert_resnet_state_dict(
    state_dict: Mapping[str, Any],
) -> tuple[dict, dict]:
    """torchvision/timm ResNet state dict -> (params, batch_stats) trees.

    Torch names: ``conv1/bn1`` stem, ``layer{1-4}.{i}.conv{n}/bn{n}`` blocks,
    ``layer{s}.{i}.downsample.0/1`` projections. The classifier ``fc`` is
    dropped (backbones are created with num_classes=0 in the reference).
    """
    params: dict = {}
    stats: dict = {}
    consumed = 0

    def put_bn(prefix: tuple[str, ...], torch_key: str) -> None:
        nonlocal consumed
        _set(params, prefix + ("scale",), _np(state_dict[f"{torch_key}.weight"]))
        _set(params, prefix + ("bias",), _np(state_dict[f"{torch_key}.bias"]))
        _set(stats, prefix + ("mean",), _np(state_dict[f"{torch_key}.running_mean"]))
        _set(stats, prefix + ("var",), _np(state_dict[f"{torch_key}.running_var"]))
        consumed += 4

    _set(params, ("stem_conv", "kernel"), _conv(state_dict["conv1.weight"]))
    consumed += 1
    put_bn(("stem_bn",), "bn1")

    for torch_key in state_dict:
        if not torch_key.startswith("layer"):
            continue
        parts = torch_key.split(".")
        stage = int(parts[0][len("layer") :])
        block = int(parts[1]) + 1
        prefix = (f"stage{stage}_block{block}",)
        rest = parts[2:]
        if rest[0].startswith("conv") and rest[1] == "weight":
            _set(params, prefix + (rest[0], "kernel"), _conv(state_dict[torch_key]))
            consumed += 1
        elif rest[0].startswith("bn") and rest[1] == "weight":
            put_bn(prefix + (rest[0],), f"{parts[0]}.{parts[1]}.{rest[0]}")
        elif rest[0] == "downsample" and rest[1] == "0" and rest[2] == "weight":
            _set(
                params,
                prefix + ("downsample_conv", "kernel"),
                _conv(state_dict[torch_key]),
            )
            consumed += 1
        elif rest[0] == "downsample" and rest[1] == "1" and rest[2] == "weight":
            put_bn(
                prefix + ("downsample_bn",), f"{parts[0]}.{parts[1]}.downsample.1"
            )

    total = len(
        [
            k
            for k in state_dict
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")
        ]
    )
    if consumed != total:
        logger.warning(
            "ResNet conversion consumed %d of %d non-classifier tensors",
            consumed,
            total,
        )
    return params, stats


def _normalize_convnext_keys(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Rewrite timm ConvNeXt naming to the facebookresearch layout.

    timm: ``stem.{0,1}``, ``stages.{s}.blocks.{b}.{conv_dw,norm,mlp.fc1,
    mlp.fc2,gamma}``, ``stages.{s}.downsample.{0,1}`` (s>=1), ``head.norm``.
    fb:   ``downsample_layers.0.{0,1}``, ``stages.{s}.{b}.{dwconv,norm,
    pwconv1,pwconv2,gamma}``, ``downsample_layers.{s}.{0,1}``, ``norm``.
    """
    out: dict[str, Any] = {}
    for key, value in state_dict.items():
        new = key
        if new.startswith("stem.0."):
            new = new.replace("stem.0.", "downsample_layers.0.0.", 1)
        elif new.startswith("stem.1."):
            new = new.replace("stem.1.", "downsample_layers.0.1.", 1)
        elif ".downsample." in new and new.startswith("stages."):
            stage = new.split(".")[1]
            new = new.replace(
                f"stages.{stage}.downsample.", f"downsample_layers.{stage}.", 1
            )
        if ".blocks." in new:
            new = new.replace(".blocks.", ".", 1)
        new = (
            new.replace(".conv_dw.", ".dwconv.")
            .replace(".mlp.fc1.", ".pwconv1.")
            .replace(".mlp.fc2.", ".pwconv2.")
        )
        if new.startswith("head.norm."):
            new = new.replace("head.norm.", "norm.", 1)
        out[new] = value
    return out


def convert_convnext_state_dict(
    state_dict: Mapping[str, Any],
) -> dict:
    """timm or facebookresearch ConvNeXt state dict -> params tree.

    facebookresearch names: ``downsample_layers.0.{0,1}`` stem conv+LN,
    ``downsample_layers.{s}.{0,1}`` LN+conv, ``stages.{s}.{b}.*`` blocks
    (dwconv, norm, pwconv1/2, [gamma|grn]), final ``norm``; timm naming is
    rewritten to this layout first. The classifier ``head`` is dropped.
    A conversion that consumes no tensors raises instead of returning an
    empty tree.
    """
    if any(".blocks." in k or k.startswith("stem.") for k in state_dict):
        state_dict = _normalize_convnext_keys(state_dict)
    params: dict = {}
    consumed = 0

    def put(path: tuple[str, ...], value: np.ndarray) -> None:
        nonlocal consumed
        _set(params, path, value)
        consumed += 1

    for key, tensor in state_dict.items():
        parts = key.split(".")
        if parts[0] == "head" or parts[0] == "fc":
            continue
        if parts[0] == "downsample_layers":
            stage = int(parts[1])
            sub = parts[2]
            kind = "weight" if parts[3] == "weight" else "bias"
            if stage == 0:
                if sub == "0":  # stem conv
                    if kind == "weight":
                        put(("stem_conv", "kernel"), _conv(tensor))
                    else:
                        put(("stem_conv", "bias"), _np(tensor))
                else:  # stem LN
                    put(
                        ("stem_norm", "scale" if kind == "weight" else "bias"),
                        _np(tensor),
                    )
            else:
                if sub == "0":  # LN before downsample conv
                    put(
                        (
                            f"downsample{stage}_norm",
                            "scale" if kind == "weight" else "bias",
                        ),
                        _np(tensor),
                    )
                else:
                    if kind == "weight":
                        put((f"downsample{stage}_conv", "kernel"), _conv(tensor))
                    else:
                        put((f"downsample{stage}_conv", "bias"), _np(tensor))
        elif parts[0] == "stages":
            stage = int(parts[1]) + 1
            block = int(parts[2]) + 1
            prefix = (f"stage{stage}_block{block}",)
            leaf = parts[3]
            if leaf == "dwconv":
                if parts[4] == "weight":
                    put(prefix + ("dwconv", "kernel"), _dwconv(tensor))
                else:
                    put(prefix + ("dwconv", "bias"), _np(tensor))
            elif leaf == "norm":
                put(
                    prefix + ("norm", "scale" if parts[4] == "weight" else "bias"),
                    _np(tensor),
                )
            elif leaf in ("pwconv1", "pwconv2"):
                if parts[4] == "weight":
                    put(prefix + (leaf, "kernel"), _linear(tensor))
                else:
                    put(prefix + (leaf, "bias"), _np(tensor))
            elif leaf == "gamma":
                put(prefix + ("gamma",), _np(tensor))
            elif leaf == "grn":
                put(
                    prefix + ("grn", parts[4]),
                    _np(tensor).reshape(-1),
                )
        elif parts[0] == "norm":
            put(("head_norm", "scale" if parts[1] == "weight" else "bias"), _np(tensor))

    total = len(
        [k for k in state_dict if not (k.startswith("head") or k.startswith("fc"))]
    )
    if consumed == 0:
        raise ValueError(
            "ConvNeXt conversion consumed no tensors — unrecognized naming "
            f"scheme (sample keys: {sorted(state_dict)[:4]})"
        )
    if consumed != total:
        logger.warning(
            "ConvNeXt conversion consumed %d of %d non-classifier tensors",
            consumed,
            total,
        )
    return params


def convert_vit_state_dict(
    state_dict: Mapping[str, Any], num_heads: int
) -> dict:
    """timm ViT/DeiT state dict -> params tree.

    timm names: ``cls_token``, ``pos_embed``, ``patch_embed.proj``,
    ``blocks.{i}.{norm1,attn.{qkv,proj},norm2,mlp.fc1,mlp.fc2}``, ``norm``.
    The fused qkv projection is split into flax MultiHeadDotProductAttention's
    query/key/value trees with per-head reshapes. ``head`` is dropped.
    DeiT-III LayerScale tensors (ls1/ls2 or gamma_1/gamma_2) are not part of
    this package's ViT blocks and raise if present.
    """
    params: dict = {}
    consumed = 0

    def put(path: tuple[str, ...], value: np.ndarray) -> None:
        nonlocal consumed
        _set(params, path, value)
        consumed += 1

    if any(".ls1." in k or ".gamma_1" in k for k in state_dict):
        raise ValueError(
            "DeiT-III LayerScale checkpoints are not supported by the "
            "plain-ViT block (no ls1/ls2 params)"
        )

    for key, tensor in state_dict.items():
        parts = key.split(".")
        if parts[0] in ("head", "fc_norm", "pre_logits"):
            continue
        if key == "cls_token":
            put(("cls_token",), _np(tensor))
        elif key == "pos_embed":
            put(("pos_embed",), _np(tensor))
        elif parts[0] == "patch_embed" and parts[1] == "proj":
            if parts[2] == "weight":
                put(("patch_embed", "kernel"), _conv(tensor))
            else:
                put(("patch_embed", "bias"), _np(tensor))
        elif parts[0] == "blocks":
            i = int(parts[1]) + 1
            prefix = (f"block{i}",)
            rest = parts[2:]
            if rest[0] in ("norm1", "norm2"):
                put(
                    prefix + (rest[0], "scale" if rest[1] == "weight" else "bias"),
                    _np(tensor),
                )
            elif rest[0] == "attn" and rest[1] == "qkv":
                w = _np(tensor)
                if rest[2] == "weight":
                    d = w.shape[1]
                    head_dim = d // num_heads
                    for name, chunk in zip(
                        ("query", "key", "value"), np.split(w, 3, axis=0)
                    ):
                        # torch [D_out, D_in] -> flax [D_in, heads, head_dim]
                        put(
                            prefix + ("attn", name, "kernel"),
                            chunk.T.reshape(d, num_heads, head_dim),
                        )
                else:
                    d = w.shape[0] // 3
                    head_dim = d // num_heads
                    for name, chunk in zip(
                        ("query", "key", "value"), np.split(w, 3, axis=0)
                    ):
                        put(
                            prefix + ("attn", name, "bias"),
                            chunk.reshape(num_heads, head_dim),
                        )
            elif rest[0] == "attn" and rest[1] == "proj":
                w = _np(tensor)
                if rest[2] == "weight":
                    d = w.shape[0]
                    head_dim = d // num_heads
                    put(
                        prefix + ("attn", "out", "kernel"),
                        w.T.reshape(num_heads, head_dim, d),
                    )
                else:
                    put(prefix + ("attn", "out", "bias"), w)
            elif rest[0] == "mlp":
                put(
                    prefix
                    + (rest[1], "kernel" if rest[2] == "weight" else "bias"),
                    _linear(tensor) if rest[2] == "weight" else _np(tensor),
                )
        elif parts[0] == "norm":
            put(("norm", "scale" if parts[1] == "weight" else "bias"), _np(tensor))

    if consumed == 0:
        raise ValueError(
            "ViT conversion consumed no tensors — unrecognized naming "
            f"(sample keys: {sorted(state_dict)[:4]})"
        )
    return params


# timm's PatchMerging concatenates the 2x2 neighborhood in (h-offset,
# w-offset) order (0,0),(1,0),(0,1),(1,1); this package uses
# (0,0),(0,1),(1,0),(1,1) — channel groups 1 and 2 swap.
_MERGE_GROUP_PERM = (0, 2, 1, 3)


def _permute_merge_groups(value: np.ndarray, axis: int) -> np.ndarray:
    parts = np.split(value, 4, axis=axis)
    return np.concatenate([parts[i] for i in _MERGE_GROUP_PERM], axis=axis)


def convert_swin_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """timm Swin state dict -> params tree.

    timm names: ``patch_embed.{proj,norm}``, ``layers.{s}.blocks.{b}.
    {norm1,attn.{qkv,proj,relative_position_bias_table},norm2,mlp.fc1/fc2}``,
    ``layers.{s}.downsample.{norm,reduction}`` (s>=1), final ``norm``.
    ``relative_position_index`` buffers are recomputed at init and skipped;
    the patch-merging 4C input is group-permuted to this package's 2x2
    concatenation order.
    """
    params: dict = {}
    consumed = 0

    def put(path: tuple[str, ...], value: np.ndarray) -> None:
        nonlocal consumed
        _set(params, path, value)
        consumed += 1

    for key, tensor in state_dict.items():
        parts = key.split(".")
        if parts[0] == "head" or key.endswith("relative_position_index") or key.endswith("attn_mask"):
            continue
        if parts[0] == "patch_embed":
            sub = "patch_embed" if parts[1] == "proj" else "patch_norm"
            if parts[1] == "proj":
                if parts[2] == "weight":
                    put((sub, "kernel"), _conv(tensor))
                else:
                    put((sub, "bias"), _np(tensor))
            else:
                put(
                    (sub, "scale" if parts[2] == "weight" else "bias"),
                    _np(tensor),
                )
        elif parts[0] == "layers":
            stage = int(parts[1])
            if parts[2] == "downsample":
                # timm attaches the merge at the *start* of stage s (s>=1).
                prefix = (f"merge{stage}",)
                if parts[3] == "reduction":
                    put(
                        prefix + ("Dense_0", "kernel"),
                        _permute_merge_groups(_linear(tensor), axis=0),
                    )
                else:  # norm
                    put(
                        prefix
                        + (
                            "LayerNorm_0",
                            "scale" if parts[4] == "weight" else "bias",
                        ),
                        _permute_merge_groups(_np(tensor), axis=0),
                    )
                continue
            block = int(parts[3]) + 1
            prefix = (f"stage{stage + 1}_block{block}",)
            rest = parts[4:]
            if rest[0] in ("norm1", "norm2"):
                put(
                    prefix + (rest[0], "scale" if rest[1] == "weight" else "bias"),
                    _np(tensor),
                )
            elif rest[0] == "attn":
                if rest[1] == "relative_position_bias_table":
                    put(prefix + ("attn", "relative_position_bias_table"), _np(tensor))
                elif rest[1] in ("qkv", "proj"):
                    leaf = "kernel" if rest[2] == "weight" else "bias"
                    value = _linear(tensor) if rest[2] == "weight" else _np(tensor)
                    put(prefix + ("attn", rest[1], leaf), value)
            elif rest[0] == "mlp":
                put(
                    prefix + (rest[1], "kernel" if rest[2] == "weight" else "bias"),
                    _linear(tensor) if rest[2] == "weight" else _np(tensor),
                )
        elif parts[0] == "norm":
            put(("norm", "scale" if parts[1] == "weight" else "bias"), _np(tensor))

    if consumed == 0:
        raise ValueError(
            "Swin conversion consumed no tensors — unrecognized naming "
            f"(sample keys: {sorted(state_dict)[:4]})"
        )
    return params


def _se_paths(prefix: tuple[str, ...], rest: list[str]) -> tuple[tuple[str, ...], bool] | None:
    """timm SE conv_reduce/conv_expand -> fc1/fc2 Dense paths."""
    if rest[0] != "se":
        return None
    fc = "fc1" if rest[1] == "conv_reduce" else "fc2"
    return prefix + ("se", fc, "kernel" if rest[2] == "weight" else "bias"), rest[2] == "weight"


def _put_se(put, prefix, rest, tensor) -> bool:
    mapped = _se_paths(prefix, rest)
    if mapped is None:
        return False
    path, is_weight = mapped
    # timm SE uses 1x1 convs [out, in, 1, 1]; ours are Dense [in, out].
    value = _np(tensor)
    if is_weight:
        value = value.reshape(value.shape[0], value.shape[1]).T
    put(path, value)
    return True


def convert_efficientnet_state_dict(
    state_dict: Mapping[str, Any],
) -> tuple[dict, dict]:
    """timm EfficientNet v1 / v2 state dict -> (params, batch_stats).

    timm block layouts: DepthwiseSeparable ``conv_dw/bn1/se/conv_pw/bn2``,
    InvertedResidual ``conv_pw/bn1/conv_dw/bn2/se/conv_pwl/bn3``,
    EdgeResidual (v2 fused) ``conv_exp/bn1/conv_pwl/bn2``; stem
    ``conv_stem/bn1``; head ``conv_head/bn2``; classifier dropped.
    """
    params: dict = {}
    stats: dict = {}
    consumed = 0

    def put(path: tuple[str, ...], value: np.ndarray) -> None:
        nonlocal consumed
        _set(params, path, value)
        consumed += 1

    def put_bn(prefix: tuple[str, ...], torch_key: str) -> None:
        nonlocal consumed
        _set(params, prefix + ("scale",), _np(state_dict[f"{torch_key}.weight"]))
        _set(params, prefix + ("bias",), _np(state_dict[f"{torch_key}.bias"]))
        _set(stats, prefix + ("mean",), _np(state_dict[f"{torch_key}.running_mean"]))
        _set(stats, prefix + ("var",), _np(state_dict[f"{torch_key}.running_var"]))
        consumed += 4

    # Per-block kind detection: presence of conv_exp => fused (EdgeResidual);
    # conv_pw + conv_pwl => InvertedResidual; conv_pw + bn2 only => DS block.
    block_keys: dict[tuple[int, int], set[str]] = {}
    for key in state_dict:
        if key.startswith("blocks."):
            parts = key.split(".")
            block_keys.setdefault((int(parts[1]), int(parts[2])), set()).add(parts[3])

    put(("stem_conv", "kernel"), _conv(state_dict["conv_stem.weight"]))
    put_bn(("stem_bn",), "bn1")

    for (s, b), kinds in sorted(block_keys.items()):
        prefix = (f"stage{s + 1}_block{b + 1}",)
        tk = f"blocks.{s}.{b}"
        if "conv_exp" in kinds:  # fused (EdgeResidual)
            put(prefix + ("fused_conv", "kernel"), _conv(state_dict[f"{tk}.conv_exp.weight"]))
            put_bn(prefix + ("fused_bn",), f"{tk}.bn1")
            put(prefix + ("project_conv", "kernel"), _conv(state_dict[f"{tk}.conv_pwl.weight"]))
            put_bn(prefix + ("project_bn",), f"{tk}.bn2")
        elif "conv_pwl" in kinds:  # InvertedResidual
            put(prefix + ("expand_conv", "kernel"), _conv(state_dict[f"{tk}.conv_pw.weight"]))
            put_bn(prefix + ("expand_bn",), f"{tk}.bn1")
            put(prefix + ("dwconv", "kernel"), _dwconv(state_dict[f"{tk}.conv_dw.weight"]))
            put_bn(prefix + ("dw_bn",), f"{tk}.bn2")
            put(prefix + ("project_conv", "kernel"), _conv(state_dict[f"{tk}.conv_pwl.weight"]))
            put_bn(prefix + ("project_bn",), f"{tk}.bn3")
        else:  # DepthwiseSeparable
            put(prefix + ("dwconv", "kernel"), _dwconv(state_dict[f"{tk}.conv_dw.weight"]))
            put_bn(prefix + ("dw_bn",), f"{tk}.bn1")
            put(prefix + ("project_conv", "kernel"), _conv(state_dict[f"{tk}.conv_pw.weight"]))
            put_bn(prefix + ("project_bn",), f"{tk}.bn2")
        for se_key in ("conv_reduce", "conv_expand"):
            for leaf in ("weight", "bias"):
                full = f"{tk}.se.{se_key}.{leaf}"
                if full in state_dict:
                    _put_se(put, prefix, ["se", se_key, leaf], state_dict[full])

    put(("head_conv", "kernel"), _conv(state_dict["conv_head.weight"]))
    put_bn(("head_bn",), "bn2")
    if consumed == 0:
        raise ValueError("EfficientNet conversion consumed no tensors")
    return params, stats


def convert_mobilenetv3_state_dict(
    state_dict: Mapping[str, Any],
) -> tuple[dict, dict]:
    """timm MobileNetV3 state dict -> (params, batch_stats).

    timm nests blocks per stage (``blocks.{s}.{b}``) with the final
    ConvBnAct 1x1 (this package's ``head_conv``/``head_bn``) as the last
    stage; the post-pool ``conv_head`` maps to the ``head_fc`` Dense.
    Blocks are flattened to this package's ``block{i}_*`` naming.
    """
    params: dict = {}
    stats: dict = {}
    consumed = 0

    def put(path: tuple[str, ...], value: np.ndarray) -> None:
        nonlocal consumed
        _set(params, path, value)
        consumed += 1

    def put_bn(prefix: tuple[str, ...], torch_key: str) -> None:
        nonlocal consumed
        _set(params, prefix + ("scale",), _np(state_dict[f"{torch_key}.weight"]))
        _set(params, prefix + ("bias",), _np(state_dict[f"{torch_key}.bias"]))
        _set(stats, prefix + ("mean",), _np(state_dict[f"{torch_key}.running_mean"]))
        _set(stats, prefix + ("var",), _np(state_dict[f"{torch_key}.running_var"]))
        consumed += 4

    put(("stem_conv", "kernel"), _conv(state_dict["conv_stem.weight"]))
    put_bn(("stem_bn",), "bn1")

    block_keys: dict[tuple[int, int], set[str]] = {}
    for key in state_dict:
        if key.startswith("blocks."):
            parts = key.split(".")
            block_keys.setdefault((int(parts[1]), int(parts[2])), set()).add(parts[3])

    flat = 0
    for (s, b), kinds in sorted(block_keys.items()):
        tk = f"blocks.{s}.{b}"
        if kinds == {"conv", "bn1"}:
            # Final ConvBnAct stage = this package's head conv + bn.
            put(("head_conv", "kernel"), _conv(state_dict[f"{tk}.conv.weight"]))
            put_bn(("head_bn",), f"{tk}.bn1")
            continue
        flat += 1
        name = f"block{flat}"
        if "conv_pwl" in kinds:  # InvertedResidual with expansion
            put((f"{name}_expand", "kernel"), _conv(state_dict[f"{tk}.conv_pw.weight"]))
            put_bn((f"{name}_expand_bn",), f"{tk}.bn1")
            put((f"{name}_dw", "kernel"), _dwconv(state_dict[f"{tk}.conv_dw.weight"]))
            put_bn((f"{name}_dw_bn",), f"{tk}.bn2")
            put((f"{name}_project", "kernel"), _conv(state_dict[f"{tk}.conv_pwl.weight"]))
            put_bn((f"{name}_project_bn",), f"{tk}.bn3")
        else:  # DepthwiseSeparable (no expand)
            put((f"{name}_dw", "kernel"), _dwconv(state_dict[f"{tk}.conv_dw.weight"]))
            put_bn((f"{name}_dw_bn",), f"{tk}.bn1")
            put((f"{name}_project", "kernel"), _conv(state_dict[f"{tk}.conv_pw.weight"]))
            put_bn((f"{name}_project_bn",), f"{tk}.bn2")
        for se_key in ("conv_reduce", "conv_expand"):
            for leaf in ("weight", "bias"):
                full = f"{tk}.se.{se_key}.{leaf}"
                if full in state_dict:
                    fc = "fc1" if se_key == "conv_reduce" else "fc2"
                    value = _np(state_dict[full])
                    if leaf == "weight":
                        value = value.reshape(value.shape[0], value.shape[1]).T
                    put((f"{name}_se", fc, "kernel" if leaf == "weight" else "bias"), value)

    # Post-pool conv_head acts as the head Dense: [F, C, 1, 1] -> [C, F].
    w = _np(state_dict["conv_head.weight"])
    put(("head_fc", "kernel"), w.reshape(w.shape[0], w.shape[1]).T)
    if "conv_head.bias" in state_dict:
        put(("head_fc", "bias"), _np(state_dict["conv_head.bias"]))
    if consumed == 0:
        raise ValueError("MobileNetV3 conversion consumed no tensors")
    return params, stats


def load_torch_backbone(checkpoint_path: Path, arch: str) -> tuple[dict, dict]:
    """Load a torch ``.pth``/``.pt`` state-dict file and convert it for
    ``arch``: ``(params, batch_stats)``, ``batch_stats`` empty for the
    BatchNorm-free families (ConvNeXt, ViT/DeiT, Swin). Every family of the
    backbone registry (``models/backbone.py``)."""
    raw = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    if arch.startswith(("resnet", "resnext", "wide_resnet")):
        return convert_resnet_state_dict(raw)
    if arch.startswith("convnext"):
        return convert_convnext_state_dict(raw), {}
    if arch.startswith(("vit", "deit")):
        return convert_vit_state_dict(raw, VIT_CONFIGS[arch].num_heads), {}
    if arch.startswith("swin"):
        return convert_swin_state_dict(raw), {}
    if arch.startswith("efficientnet"):
        return convert_efficientnet_state_dict(raw)
    if arch.startswith("mobilenetv3"):
        return convert_mobilenetv3_state_dict(raw)
    raise ValueError(f"No converter for architecture: {arch}")


# ---------------------------------------------------------------------------
# Native backbone artifact: a flat .npz of the CONVERTED trees, keys
# '/'-joined tree paths under 'params/' and 'batch_stats/', the arch under
# '__meta__/arch', dtypes kept: the JAX package's format, read and written
# by both packages.
# ---------------------------------------------------------------------------

_NPZ_META_KEY = "__meta__/arch"


def _flatten_tree(tree: Mapping[str, Any], prefix: str) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_backbone_npz(
    params: Mapping[str, Any],
    batch_stats: Mapping[str, Any],
    path: Path,
    arch: str = "",
) -> None:
    """Write converted backbone trees as the native flat .npz artifact."""
    flat = _flatten_tree(params, "params")
    flat.update(_flatten_tree(batch_stats or {}, "batch_stats"))
    if arch:
        flat[_NPZ_META_KEY] = np.asarray(arch)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def save_variables_npz(variables: Mapping[str, Any], path: Path) -> None:
    """Write a Flax variables tree (``{"params": ..., "batch_stats": ...}``)
    as the JAX package's ``train/ocr.py::save_variables_npz`` does: a flat
    compressed ``.npz`` of ``/``-joined paths, f32 params stored f16,
    everything else as it is. Both packages' loaders read it."""
    flat = {}
    for collection, tree in variables.items():
        for key, value in _flatten_tree(tree, collection).items():
            if key.startswith("params/") and value.dtype == np.float32:
                value = value.astype(np.float16)
            flat[key] = value
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def load_variables_npz(path: Path) -> dict:
    """A Flax variables tree (``{"params": ..., "batch_stats": ...}``) from a
    flat ``.npz`` of ``a/b/c`` keys, f16 leaves widened to f32: the JAX
    package's ``train/ocr.py::save_variables_npz`` format, in which the OCR
    nets' weights ship."""
    flat = {}
    with np.load(Path(path)) as data:
        for key in data.files:
            arr = data[key]
            flat[key] = arr.astype(np.float32) if arr.dtype == np.float16 else arr
    return _unflatten_tree(flat)


def load_backbone_npz(path: Path) -> tuple[dict, dict, str]:
    """Load a native backbone artifact -> (params, batch_stats, arch)."""
    with np.load(Path(path)) as data:
        arch = ""
        flat: dict[str, np.ndarray] = {}
        for key in data.files:
            if key == _NPZ_META_KEY:
                arch = str(data[key])
            else:
                flat[key] = data[key]
    tree = _unflatten_tree(flat)
    return tree.get("params", {}), tree.get("batch_stats", {}), arch


def convert_checkpoint(
    checkpoint_path: Path, arch: str, output_path: Path
) -> Path:
    """One-shot torch ``.pth``/``.pt`` -> ``.npz`` artifact conversion.

    The artifact is read by ``TrainingConfig.pretrained_path`` and
    :func:`load_pretrained_backbone`, of this package or the JAX package.
    """
    params, stats = load_torch_backbone(Path(checkpoint_path), arch)
    save_backbone_npz(params, stats, Path(output_path), arch=arch)
    n = sum(
        int(np.prod(x.shape)) for x in _flatten_tree(params, "params").values()
    )
    logger.info(
        "Converted %s (%s, %d params) -> %s",
        checkpoint_path,
        arch,
        n,
        output_path,
    )
    return Path(output_path)


def load_pretrained_backbone(path: Path, arch: str) -> tuple[dict, dict]:
    """Load pretrained backbone trees from either artifact format.

    ``.npz`` -> the converted artifact (the arch recorded at conversion
    time must match when present). Anything else -> a torch state-dict file
    converted on the fly by :func:`load_torch_backbone`.
    """
    path = Path(path)
    if path.suffix == ".npz":
        params, stats, saved_arch = load_backbone_npz(path)
        if saved_arch and arch and saved_arch != arch:
            raise ValueError(
                f"Backbone artifact {path} was converted for "
                f"'{saved_arch}', not '{arch}'"
            )
        return params, stats
    return load_torch_backbone(path, arch)
