"""Localization training in the LN-fused MLP mode (``use_pallas="mlp"``, the
trainer's ``use_pallas_mlp=True``) against the JAX package's.

The JAX ConvNeXt runs ``fused_ln_mlp`` (v1 blocks of C <= 512 with
LayerScale) and ``fused_mlp`` (those without) with their Pallas kernels in
interpret mode; the port, on the CPU, runs the kernels' plain versions. This
file sits beside the other train-step comparisons so that a run spread over
workers by file takes them at once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
    random_flax_variables,
)
from spine_vision_torch.models.convnext import ConvNeXtBlock
from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer
from spine_vision_tpu.models.convnext import ConvNeXtBlock as JBlock
from test_torch_train import _Set, check_one_train_step_against_jax


def test_one_train_step_matches_jax_mlp_mode():
    """convnext_tiny at 32^2: 15 LN-fused blocks (C = 96, 192, 384) and 3
    plain ones (C = 768); tolerances as the hybrid comparison's."""
    check_one_train_step_against_jax("mlp")


def test_cpu_trainer_epoch_with_use_pallas_mlp(tmp_path):
    cfg = LocalizationConfig(backbone="convnext_tiny", image_size=(32, 32), batch_size=4,
                             num_epochs=1, output_path=tmp_path / "run", num_workers=2,
                             seed=0, pretrained=False, use_pallas_mlp=True)
    trainer = LocalizationTrainer(cfg, train_dataset=_Set(8, 32, 0),
                                  val_dataset=_Set(5, 32, 1), device="cpu")
    blocks = [m for m in trainer.model.modules() if isinstance(m, ConvNeXtBlock)]
    assert [b.route for b in blocks] == ["ln_mlp"] * 15 + ["plain"] * 3
    assert [b.dim for b in blocks if b.route == "ln_mlp"] == [96] * 3 + [192] * 3 + [384] * 9
    result = trainer.train()
    for key in ("train_loss", "val_loss", "lr", "med"):
        values = result.history[key]
        assert len(values) == 1 and np.isfinite(values[0]), key
    assert all(p.grad is not None for p in trainer.model.parameters())
    assert trainer.state.step == 2


@pytest.mark.parametrize("mode", ["mlp", "hybrid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_without_layer_scale_matches_jax(mode, dtype):
    """A v1 block without LayerScale takes the fused MLP (#5 forward, #6
    backward) after a plain conv and LayerNorm, in the "mlp" and in the
    "hybrid" mode alike (the hybrid block needs LayerScale)."""
    c = 128
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    port = ConvNeXtBlock(c, use_grn=False, layer_scale_init=0.0, dtype=tdt, device="cpu",
                         use_pallas=mode, param_dtype=torch.float32)
    assert port.route == "mlp" and port.gamma is None
    params, _ = random_flax_variables(port, seed=21)
    load_flax_variables(port, params)
    ref = JBlock(c, use_grn=False, layer_scale_init=0.0, dtype=jdt, use_pallas_mlp=True,
                 use_pallas_hybrid=mode == "hybrid")
    x = np.random.default_rng(22).normal(size=(2, 8, 8, c)).astype(np.float32)

    def loss(p, xx):
        out = ref.apply({"params": p}, xx)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (_, jout), (jgrads, jdx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = port(xt)
    assert type(out.grad_fn).__name__ == "_FusedMlpBackward"
    (out.float() ** 2).sum().backward()
    # f32: sums in another order; bf16: the conv, the LayerNorm and the MLP
    # round at the same points on both sides, but a value on a rounding
    # boundary can round apart: the forward to 5e-4 / 1e-2 of max(1, max
    # |ref|), each gradient to 5e-3 / 3e-2 of its own scale.
    f32 = dtype == "float32"
    ref_out = np.asarray(jout, np.float32)
    scale = max(1.0, float(np.abs(ref_out).max()))
    np.testing.assert_allclose(out.detach().float().numpy() / scale, ref_out / scale,
                               atol=5e-4 if f32 else 1e-2)
    got = dict(jax.tree_util.tree_flatten_with_path(export_flax_variables(port, grads=True)[0])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    assert got.keys() == want.keys()
    tol = 5e-3 if f32 else 3e-2
    for path, w in [*want.items(), ("x", jdx)]:
        g = xt.grad.float().numpy() if path == "x" else got[path]
        w = np.asarray(w, np.float32)
        s = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g / s, w / s, atol=tol, err_msg=str(path))
