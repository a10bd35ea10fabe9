"""The zoo's timm converters: the port's against the JAX package's.

For ViT, Swin, EfficientNet (v1 and v2) and MobileNetV3, a timm-named state
dict of random tensors is written from a seeded Flax-layout tree of a small
port model (the inverse mappings and key patterns of
``tests/test_convert.py``: the fused qkv, Swin's merge-group permutation,
the SE 1x1 convolutions). Both packages' converters must give trees equal
leaf for leaf, equal to the tree the state dict was written from, and the
port model must take them (every leaf used, every shape right). Then the
``.npz`` artifact: written by one package, read by the other, and
``load_torch_backbone`` by arch name for every family.
"""

import numpy as np
import pytest
import torch
from test_convert import _emit_bn, _emit_effnet_block, _inv_conv, _inv_dwconv, _inv_linear, _t

from spine_vision_torch.models import convert as tconv
from spine_vision_torch.models import efficientnet as te
from spine_vision_torch.models import swin as ts
from spine_vision_torch.models import vit as tv
from spine_vision_tpu.models import convert as jconv

VIT = tv.ViTConfig(16, 192, 2, 3)  # vit_tiny's widths and heads, two blocks
SWIN = ts.SwinConfig(32, (2, 1), (2, 4), window_size=7)
EFF_V1 = te.EfficientNetConfig((te.BlockSpec("dsconv", 1, 16, 1, 3, 1, 0.25),
                                te.BlockSpec("mbconv", 6, 24, 2, 5, 2, 0.25)), 16, 64)
EFF_V2 = te.EfficientNetConfig((te.BlockSpec("fused", 1, 16, 1, 3, 1),
                                te.BlockSpec("fused", 4, 24, 1, 3, 2),
                                te.BlockSpec("mbconv", 4, 32, 1, 3, 2, 0.25)), 16, 64)
MNV3 = te.MobileNetV3Config(((16, 16, 3, 2, True, "relu"), (64, 24, 3, 2, False, "relu"),
                             (72, 24, 5, 1, True, "hswish")), 96)


def _qkv_sd(sd, tp, attn, d):
    sd[f"{tp}.attn.qkv.weight"] = _t(np.concatenate(
        [attn[k]["kernel"].reshape(d, d).T for k in ("query", "key", "value")], axis=0))
    sd[f"{tp}.attn.qkv.bias"] = _t(np.concatenate(
        [attn[k]["bias"].reshape(-1) for k in ("query", "key", "value")]))
    sd[f"{tp}.attn.proj.weight"] = _t(attn["out"]["kernel"].reshape(d, d).T)
    sd[f"{tp}.attn.proj.bias"] = _t(attn["out"]["bias"])


def _ln_sd(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _mlp_sd(sd, tp, blk):
    for fc in ("fc1", "fc2"):
        sd[f"{tp}.mlp.{fc}.weight"] = _inv_linear(blk[fc]["kernel"])
        sd[f"{tp}.mlp.{fc}.bias"] = _t(blk[fc]["bias"])


def _vit_sd(p, s):
    d = VIT.hidden_dim
    sd = {"cls_token": _t(p["cls_token"]), "pos_embed": _t(p["pos_embed"]),
          "patch_embed.proj.weight": _inv_conv(p["patch_embed"]["kernel"]),
          "patch_embed.proj.bias": _t(p["patch_embed"]["bias"])}
    for i in range(VIT.depth):
        blk, tp = p[f"block{i + 1}"], f"blocks.{i}"
        _ln_sd(sd, f"{tp}.norm1", blk["norm1"])
        _ln_sd(sd, f"{tp}.norm2", blk["norm2"])
        _qkv_sd(sd, tp, blk["attn"], d)
        _mlp_sd(sd, tp, blk)
    _ln_sd(sd, "norm", p["norm"])
    sd["head.weight"], sd["head.bias"] = _t(np.zeros((10, d))), _t(np.zeros(10))
    return sd


def _perm(a):
    parts = np.split(a, 4, axis=0)
    return np.concatenate([parts[i] for i in (0, 2, 1, 3)], axis=0)


def _swin_sd(p, s):
    sd = {"patch_embed.proj.weight": _inv_conv(p["patch_embed"]["kernel"]),
          "patch_embed.proj.bias": _t(p["patch_embed"]["bias"])}
    _ln_sd(sd, "patch_embed.norm", p["patch_norm"])
    for st, depth in enumerate(SWIN.depths):
        if st:
            merge = p[f"merge{st}"]
            sd[f"layers.{st}.downsample.reduction.weight"] = _inv_linear(
                _perm(merge["Dense_0"]["kernel"]))
            sd[f"layers.{st}.downsample.norm.weight"] = _t(_perm(merge["LayerNorm_0"]["scale"]))
            sd[f"layers.{st}.downsample.norm.bias"] = _t(_perm(merge["LayerNorm_0"]["bias"]))
        for b in range(depth):
            blk, tp = p[f"stage{st + 1}_block{b + 1}"], f"layers.{st}.blocks.{b}"
            _ln_sd(sd, f"{tp}.norm1", blk["norm1"])
            _ln_sd(sd, f"{tp}.norm2", blk["norm2"])
            for lin in ("qkv", "proj"):
                sd[f"{tp}.attn.{lin}.weight"] = _inv_linear(blk["attn"][lin]["kernel"])
                sd[f"{tp}.attn.{lin}.bias"] = _t(blk["attn"][lin]["bias"])
            sd[f"{tp}.attn.relative_position_bias_table"] = _t(
                blk["attn"]["relative_position_bias_table"])
            sd[f"{tp}.attn.relative_position_index"] = torch.zeros(49, 49)
            _mlp_sd(sd, tp, blk)
    _ln_sd(sd, "norm", p["norm"])
    return sd


def _effnet_sd(cfg):
    def emit(p, s):
        sd = {"conv_stem.weight": _inv_conv(p["stem_conv"]["kernel"])}
        _emit_bn(sd, "bn1", p["stem_bn"], s["stem_bn"])
        for si, spec in enumerate(cfg.blocks):
            for b in range(spec.num_blocks):
                name = f"stage{si + 1}_block{b + 1}"
                _emit_effnet_block(sd, f"blocks.{si}.{b}", p[name], s[name],
                                   spec.kind == "fused")
        sd["conv_head.weight"] = _inv_conv(p["head_conv"]["kernel"])
        _emit_bn(sd, "bn2", p["head_bn"], s["head_bn"])
        sd["classifier.weight"] = _t(np.zeros((10, cfg.head_filters)))
        return sd
    return emit


def _mnv3_sd(p, s):
    sd = {"conv_stem.weight": _inv_conv(p["stem_conv"]["kernel"])}
    _emit_bn(sd, "bn1", p["stem_bn"], s["stem_bn"])
    n = len(MNV3.blocks)
    for i in range(1, n + 1):
        tk, b = f"blocks.0.{i - 1}", f"block{i}"
        names = ((f"{b}_expand", "conv_pw", _inv_conv), (f"{b}_dw", "conv_dw", _inv_dwconv),
                 (f"{b}_project", "conv_pwl", _inv_conv))
        if f"{b}_expand" not in p:
            names = ((f"{b}_dw", "conv_dw", _inv_dwconv), (f"{b}_project", "conv_pw", _inv_conv))
        for j, (ours, theirs, inv) in enumerate(names):
            sd[f"{tk}.{theirs}.weight"] = inv(p[ours]["kernel"])
            _emit_bn(sd, f"{tk}.bn{j + 1}", p[f"{ours}_bn"], s[f"{ours}_bn"])
        if f"{b}_se" in p:
            se = p[f"{b}_se"]
            for fc, key in (("fc1", "conv_reduce"), ("fc2", "conv_expand")):
                sd[f"{tk}.se.{key}.weight"] = _t(se[fc]["kernel"].T[:, :, None, None])
                sd[f"{tk}.se.{key}.bias"] = _t(se[fc]["bias"])
    sd[f"blocks.0.{n}.conv.weight"] = _inv_conv(p["head_conv"]["kernel"])
    _emit_bn(sd, f"blocks.0.{n}.bn1", p["head_bn"], s["head_bn"])
    sd["conv_head.weight"] = _t(p["head_fc"]["kernel"].T[:, :, None, None])
    sd["conv_head.bias"] = _t(p["head_fc"]["bias"])
    return sd


FAMILIES = {
    "vit_tiny": (lambda: tv.ViT(VIT), _vit_sd),
    "swin_tiny": (lambda: ts.SwinTransformer(SWIN), _swin_sd),
    "efficientnet_b0": (lambda: te.EfficientNet(EFF_V1), _effnet_sd(EFF_V1)),
    "efficientnetv2_s": (lambda: te.EfficientNet(EFF_V2), _effnet_sd(EFF_V2)),
    "mobilenetv3_small": (lambda: te.MobileNetV3(MNV3), _mnv3_sd),
}


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _convert(module, arch, sd):
    if arch.startswith("vit"):
        return module.convert_vit_state_dict(sd, VIT.num_heads), {}
    if arch.startswith("swin"):
        return module.convert_swin_state_dict(sd), {}
    if arch.startswith("efficientnet"):
        return module.convert_efficientnet_state_dict(sd)
    return module.convert_mobilenetv3_state_dict(sd)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_converters_match_jax_leaf_for_leaf(arch, tmp_path):
    make, emit = FAMILIES[arch]
    model = make()
    params, stats = tconv.random_flax_variables(model, seed=len(arch))
    sd = emit(params, stats)
    got_p, got_s = _convert(tconv, arch, sd)
    want_p, want_s = _convert(jconv, arch, sd)
    _assert_trees_equal(got_p, want_p)
    _assert_trees_equal(got_s, want_s)
    _assert_trees_equal(got_p, params)
    tconv.load_flax_variables(model, got_p, got_s)
    back_p, _ = tconv.export_flax_variables(model)
    _assert_trees_equal(back_p, params)

    # The torch file by arch name, and the .npz written by either package.
    torch.save(sd, tmp_path / "w.pth")
    for writer, reader in ((tconv, jconv), (jconv, tconv)):
        npz = tmp_path / f"{writer.__name__.split('.')[0]}.npz"
        writer.convert_checkpoint(tmp_path / "w.pth", arch, npz)
        p, s = reader.load_pretrained_backbone(npz, arch)
        _assert_trees_equal(p, want_p)
        _assert_trees_equal(s, want_s)
    p, s = tconv.load_pretrained_backbone(tmp_path / "w.pth", arch)
    _assert_trees_equal(p, want_p)


def test_swin_merge_permutation_and_se_keys():
    """timm's 2x2 merge concatenates (0,0), (1,0), (0,1), (1,1): the
    converter swaps channel groups 1 and 2 of the merge's norm and
    reduction; the SE 1x1 convolutions become ``se/fc1``, ``se/fc2`` Denses."""
    c = 4
    groups = np.repeat(np.arange(4, dtype=np.float32), c)
    sd = {"layers.1.downsample.norm.weight": torch.from_numpy(groups),
          "layers.1.downsample.norm.bias": torch.zeros(4 * c),
          "layers.1.downsample.reduction.weight": torch.from_numpy(
              np.tile(groups, (2 * c, 1)))}
    p = tconv.convert_swin_state_dict(sd)
    np.testing.assert_array_equal(p["merge1"]["LayerNorm_0"]["scale"][::c], [0, 2, 1, 3])
    np.testing.assert_array_equal(p["merge1"]["Dense_0"]["kernel"][::c, 0], [0, 2, 1, 3])
    path, is_weight = tconv._se_paths(("stage1_block1",), ["se", "conv_expand", "weight"])
    assert path == ("stage1_block1", "se", "fc2", "kernel") and is_weight
    assert tconv._se_paths(("b",), ["conv_pw", "weight"]) is None
