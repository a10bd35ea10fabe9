"""The port's head library against the JAX package's ``models/heads.py``.

Every head type from ``create_head`` at f32 and bf16 on ``[B, 32]``
features, in eval mode and (dropout off) in training mode, where
``ConvHead``'s Flax BatchNorm uses and updates its batch statistics;
``MultiTaskHead``; ``HeadFactory.register``; the dropout schedules; and a
``CoordinateRegressor`` whose head a ``HeadConfig`` replaces.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn
from torch_zoo_helpers import carry, check_stats, forward_pair, images, rel_err

from spine_vision_torch.models import classifier as tcls
from spine_vision_torch.models import heads as th
from spine_vision_torch.models.convert import random_flax_variables
from spine_vision_tpu.models import CoordinateRegressor
from spine_vision_tpu.models import heads as jh

CONFIGS = {
    "linear": {"head_type": "linear", "dropout": 0.0, "output_activation": "sigmoid"},
    "mlp": {"head_type": "mlp", "hidden_dims": (16, 8), "dropout": 0.0, "activation": "silu"},
    "attention": {"head_type": "attention", "dropout": 0.0, "num_attention_heads": 4},
    "residual": {"head_type": "residual", "hidden_dims": (16, 24), "dropout": 0.0,
                 "activation": "gelu", "output_activation": "tanh"},
    "conv": {"head_type": "conv", "hidden_dims": (16, 8), "dropout": 0.0,
             "activation": "relu"},
    "mlp_no_norm": {"head_type": "mlp", "use_layer_norm": False, "dropout": 0.0,
                    "output_activation": "softmax"},
}


def _heads(name, dtype, out=6):
    cfg = CONFIGS[name]
    port = th.create_head(th.HeadConfig(**cfg), out, getattr(torch, dtype), in_features=32)
    ref = jh.create_head(jh.HeadConfig(**cfg), out, getattr(jnp, dtype))
    return port, ref


# f32 within 1e-5 of the output's largest magnitude (measured 7.3e-8 to
# 3.1e-7). bf16: Dense products round to bf16 in both, in sums of another
# order; within 2e-2, test_torch_models.py's ConvNeXt bf16 bound (measured
# 0 to 9.5e-3).
@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_head_matches_jax(name, dtype, bound):
    port, ref = _heads(name, dtype)
    variables = carry(port, ref, (2, 32), seed=len(name))
    got, want, _ = forward_pair(port, ref, images(1, (5, 32)), variables)
    assert got.shape == (5, 6)
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) <= bound


@pytest.mark.parametrize("name", ["conv", "residual"])
def test_head_training_mode_matches_jax(name):
    """Dropout off: the same outputs; ``ConvHead``'s BatchNorm normalises by
    the batch and moves its running statistics at momentum 0.99."""
    port, ref = _heads(name, "float32")
    variables = carry(port, ref, (2, 32), seed=3)
    x = images(4, (8, 32))
    if "batch_stats" not in variables:
        got, want, _ = forward_pair(port, ref, x, variables)
        port.train()
        np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), got.numpy())
        return
    got, want, upd = forward_pair(port, ref, x, variables, train=True)
    assert rel_err(got.numpy(), want) <= 1e-5
    check_stats(port, upd)


def test_multitask_head_matches_jax():
    tasks = {"grade": (5, jh.HeadConfig("mlp", (16,), 0.0)),
             "flag": (1, jh.HeadConfig("linear", dropout=0.0))}
    port = th.MultiTaskHead({k: (n, th.HeadConfig(*vars(c).values()))
                             for k, (n, c) in tasks.items()}, in_features=32)
    ref = jh.MultiTaskHead(tasks)
    assert port.task_names == ref.task_names == ["grade", "flag"]
    variables = carry(port, ref, (2, 32), seed=9)
    got, want, _ = forward_pair(port, ref, images(2, (3, 32)), variables)
    assert got.keys() == want.keys()
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


def test_head_factory_registers_custom_heads(monkeypatch):
    monkeypatch.setattr(th.HeadFactory, "_heads", dict(th.HeadFactory._heads))
    monkeypatch.setattr(jh.HeadFactory, "_heads", dict(jh.HeadFactory._heads))

    @th.HeadFactory.register("double")
    class TDouble(nn.Module):
        def __init__(self, in_features, out_features, **kw):
            super().__init__()
            self.Dense_0 = th.Dense(in_features, out_features)

        def forward(self, x, generator=None, shard=None):
            return 2 * self.Dense_0(x)

    @jh.HeadFactory.register("double")
    class JDouble(fnn.Module):
        out_features: int

        @fnn.compact
        def __call__(self, x, train=False):
            return 2 * fnn.Dense(self.out_features)(x)

    assert "double" in th.HeadFactory.list_heads() and th.HeadFactory._heads["double"] is TDouble
    port = th.HeadFactory.create("double", 3, in_features=32)
    ref = jh.HeadFactory.create("double", 3)
    variables = carry(port, ref, (2, 32), seed=1)
    got, want, _ = forward_pair(port, ref, images(3, (4, 32)), variables)
    assert rel_err(got.numpy(), want) <= 1e-6
    with pytest.raises(KeyError, match="Unknown head type"):
        th.HeadFactory.create("nope", 3, in_features=32)
    with pytest.raises(ValueError, match="Unknown activation"):
        th.get_activation("swish2")


def test_dropout_schedules_and_draws(monkeypatch):
    """``MLPHead`` drops at the full rate before its first hidden layer and
    at half the rate after; ``AttentionHead``'s attention weights and output
    draw from the generator passed to ``forward``."""
    rates = []
    real = tcls.dropout
    monkeypatch.setattr(tcls, "dropout",
                        lambda x, rate, *a: rates.append(rate) or real(x, rate, *a))
    mlp = th.create_head(th.HeadConfig("mlp", (16, 8, 4), dropout=0.4), 3, in_features=32)
    mlp.train()
    mlp(torch.randn(2, 32), torch.Generator().manual_seed(0))
    assert rates == [0.4, 0.2, 0.2, 0.2]
    res = th.create_head(th.HeadConfig("residual", (16,), dropout=0.4), 3, in_features=32)
    rates.clear()
    res.train()
    res(torch.randn(2, 32), torch.Generator().manual_seed(0))
    assert rates == [0.4, 0.2, 0.4]
    attn = th.create_head(th.HeadConfig("attention", dropout=0.5), 3, in_features=32)
    x = torch.randn(4, 32)
    attn.eval()
    plain = attn(x)
    attn.train()
    a = attn(x, torch.Generator().manual_seed(1))
    b = attn(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, plain)


@pytest.mark.parametrize("head", ["residual", "attention"])
def test_coordinate_regressor_takes_a_head_config(head):
    """``head_config`` replaces the default head by ``create_head(config, L *
    2, dtype)`` named ``head``; f32 within 1e-5 of the largest output."""
    cfg = {"residual": ("residual", (16,), 0.0), "attention": ("attention", (256,), 0.0)}[head]
    port = tcls.CoordinateRegressor("resnet18", dtype=torch.float32, device="cpu",
                                    head_config=th.HeadConfig(*cfg))
    ref = CoordinateRegressor(backbone_name="resnet18", dtype=jnp.float32,
                              head_config=jh.HeadConfig(*cfg))
    params, _ = random_flax_variables(port, 0)
    assert "head" in params and "head_fc1" not in params
    variables = carry(port, ref, (1, 32, 32, 3), seed=2, train=False)
    got, want, _ = forward_pair(port, ref, images(5, (2, 32, 32, 3)), variables)
    assert got.shape == (2, 5, 2)
    assert rel_err(got.numpy(), want) <= 1e-5
    default = tcls.CoordinateRegressor("resnet18", dtype=torch.float32, device="cpu")
    assert {"head_norm", "head_fc1", "head_fc2"} <= set(random_flax_variables(default, 0)[0])
