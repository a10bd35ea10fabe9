"""Port's models against the JAX package's, on the same weights.

Weights are seeded numpy Flax-layout trees (``random_flax_variables`` of the
port's module); the JAX model applies them as they are and the port loads them
through ``load_flax_variables``. The JAX ConvNeXt runs with
``use_pallas=True``, so both Pallas kernels run in interpret mode; the port,
on the CPU, runs its kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.models import classifier as tcls
from spine_vision_torch.models import convnext as tconvnext
from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
from spine_vision_tpu.models import Classifier, CoordinateRegressor
from spine_vision_tpu.models.convnext import CONVNEXT_CONFIGS, ConvNeXt


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


def _carry(port_model, jax_model, image_hw, seed):
    """(params, batch_stats) for both, checked against the JAX init's tree."""
    params, stats = random_flax_variables(port_model, seed)
    init = jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, *image_hw, 3)), train=False)
    )
    assert _shapes(params) == _shapes(init["params"])
    assert _shapes(stats) == _shapes(init.get("batch_stats", {}))
    load_flax_variables(port_model, params, stats)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return variables


def _images(seed, n, hw):
    return np.random.default_rng(seed).normal(size=(n, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize(
    "backbone,dtype,atol",
    [
        ("convnext_tiny", "float32", 1e-4),
        # bf16 through 18 blocks: both round at the same points, in sums of
        # another order; after the f32 head and sigmoid, stated atol 2e-2.
        ("convnext_tiny", "bfloat16", 2e-2),
        ("convnextv2_tiny", "float32", 1e-4),  # GRN: dwconv+LN kernel + plain MLP
    ],
)
def test_coordinate_regressor_matches_jax(backbone, dtype, atol):
    port = tcls.CoordinateRegressor(backbone, dtype=getattr(torch, dtype), device="cpu")
    ref = CoordinateRegressor(backbone_name=backbone, dtype=getattr(jnp, dtype), use_pallas=True)
    variables = _carry(port, ref, (64, 64), seed=0)
    x = _images(1, 2, (64, 64))
    want = np.asarray(ref.apply(variables, jnp.asarray(x), train=False), np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).float().numpy()
    assert got.shape == (2, 5, 2)
    np.testing.assert_allclose(got, want, atol=atol)


def test_convnext_erf_gelu_plain_path_matches_jax():
    """``gelu="erf"`` runs plain ops on both sides (f32)."""
    cfg = CONVNEXT_CONFIGS["convnext_tiny"]
    port = tconvnext.ConvNeXt(tconvnext.CONVNEXT_CONFIGS["convnext_tiny"], gelu="erf")
    ref = ConvNeXt(config=cfg, gelu="erf")
    variables = _carry(port, ref, (32, 32), seed=2)
    x = _images(3, 2, (32, 32))
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize(
    "dtype,rtol,atol",
    # bf16: convolutions round per layer in both, in sums of another order;
    # stated rtol/atol 5e-2 on logits of unit scale.
    [("float32", 1e-4, 1e-4), ("bfloat16", 5e-2, 5e-2)],
)
def test_resnet18_classifier_matches_jax(dtype, rtol, atol):
    port = tcls.Classifier("resnet18", dtype=getattr(torch, dtype), device="cpu")
    ref = Classifier(backbone_name="resnet18", dtype=getattr(jnp, dtype))
    variables = _carry(port, ref, (32, 32), seed=4)
    x = _images(5, 3, (32, 32))
    want = ref.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for name, logits in want.items():
        np.testing.assert_allclose(
            got[name].float().numpy(), np.asarray(logits, np.float32), rtol=rtol, atol=atol,
            err_msg=name,
        )


def test_load_rejects_wrong_shapes_and_unused_leaves():
    port = tcls.Classifier("resnet18", dtype=torch.float32, device="cpu")
    params, stats = random_flax_variables(port, 0)
    params["head_pfirrmann"]["kernel"] = np.zeros((512, 4), np.float32)
    with pytest.raises(ValueError):
        load_flax_variables(port, params, stats)
    params, stats = random_flax_variables(port, 0)
    params["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError):
        load_flax_variables(port, params, stats)


def test_unported_backbone_names_the_roadmap():
    """Every backbone the JAX package names is ported: EfficientNet-B0, once
    refused here, builds and takes a backward pass with finite gradients."""
    model = tcls.Classifier("efficientnet_b0", dtype=torch.float32, device="cpu")
    model.train()
    out = model(torch.from_numpy(_images(7, 2, (32, 32))), torch.Generator().manual_seed(0))
    sum(v.sum() for v in out.values()).backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    with pytest.raises(ValueError, match="Unknown backbone"):
        tcls.Classifier("alexnet", device="cpu")
