"""Port of the whole-block training ConvNeXt block (``use_pallas="block"``,
kernel #10) against the JAX package's.

The JAX side runs ``convnext_block_train(tile_h=8, interpret=True)`` (the
megakernel forward, ``_block_train_bwd_pallas`` and an XLA grouped conv for dx)
and ``_block_train_bwd_pallas`` alone, in interpret mode; the port's
``convnext_block_train`` and ``block_train_bwd``, given CPU tensors, run the
plain versions of their kernels. Inputs come from numpy with a seed and go to
both; the loss is ``sum(out.float() ** 2)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.ops import block_train as tbt
from spine_vision_torch.ops import convnext_block as tcb
from spine_vision_tpu.ops.block_train import _block_train_bwd_pallas, convnext_block_train
from test_torch_block_train import LOW, NAMES, _args, _jax_args, _to_flax_layout, _torch_args

OUTPUTS = ["g_u", "dk", "ddwb", "dls", "dlb", "dw1", "db1", "dw2", "db2", "dgamma"]


@pytest.mark.parametrize(
    "b,h,w,c",
    [
        (1, 8, 8, 128),   # single tile, single hidden chunk
        (2, 20, 8, 128),  # padded rows in the JAX kernels + batch
        (1, 16, 8, 512),  # four-row tiles and 256-wide hidden chunks in the JAX kernel
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_train_matches_jax(b, h, w, c, dtype):
    args = _args(np.random.default_rng(11), b, h, w, c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(*a):
        out = convnext_block_train(*a, tile_h=8, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jargs = _jax_args(args, jdt)
    jout = convnext_block_train(*jargs, tile_h=8, interpret=True)
    want = jax.grad(loss, argnums=tuple(range(10)))(*jargs)
    targs = _torch_args(args, tdt)
    out = tbt.convnext_block_train(*targs)
    assert out.dtype == tdt and type(out.grad_fn).__name__ == "_TrainBlockBackward"
    # Forward: the inference block's tolerances (f32 2e-3, bf16 0.25).
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(jout, np.float32),
                               atol=2e-3 if dtype == "float32" else 0.25)
    (out.float() ** 2).sum().backward()
    # As the hybrid block's comparison: f32 5e-3 of max(1, max |grad|), bf16
    # 3e-2 (about four bf16 steps: y, h, g*gamma, the hidden gradient and g_u
    # round at the same points on both sides, but a value on a rounding
    # boundary can round apart).
    tol = 5e-3 if dtype == "float32" else 3e-2
    for name, ta, wa in zip(NAMES, targs, want):
        assert ta.grad.dtype == (tdt if name in LOW else torch.float32), name
        ref = np.asarray(wa, np.float32)
        scale = max(1.0, float(np.max(np.abs(ref))))
        np.testing.assert_allclose(
            _to_flax_layout(name, ta.grad, c) / scale, ref / scale, atol=tol,
            err_msg=f"grad mismatch for {name}",
        )


@pytest.mark.parametrize("b,h,w,c", [(2, 12, 8, 128), (1, 8, 8, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_train_bwd_reference_matches_the_pallas_kernel(b, h, w, c, dtype):
    """The plain version's ten outputs against the TPU kernel's own, given
    the same output gradient g."""
    rng = np.random.default_rng(12)
    args = _args(rng, b, h, w, c)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _block_train_bwd_pallas(*_jax_args(args, jdt), jnp.asarray(g, jdt), 1e-6, True)
    targs = [a.detach() for a in _torch_args(args, tdt)]
    got = tbt.block_train_bwd(*targs, torch.from_numpy(g).to(tdt))
    assert got[0].dtype == tdt and got[0].shape == (b, h, w, c)
    assert all(t.dtype == torch.float32 for t in got[1:])
    # f32: sums in another order, 2e-4 of max(1, max |ref|). bf16: the same
    # rounding points, a weight gradient sums a few hundred products each of
    # which can round apart: 2e-2 of the scale (about three bf16 steps).
    tol = 2e-4 if dtype == "float32" else 2e-2
    for name, port, ref in zip(OUTPUTS, got, want):
        ref = np.asarray(ref, np.float32)
        port = port.float().numpy()
        if name == "dk":
            port = port.reshape(7, 7, c)
        elif name in ("dw1", "dw2"):
            port = port.T  # the port keeps [out, in]
        port = port.reshape(ref.shape)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(port / scale, ref / scale, atol=tol, err_msg=name)


def test_block_train_without_grad_is_the_inference_kernel():
    targs = [a.detach() for a in _torch_args(_args(np.random.default_rng(13), 1, 8, 8, 128),
                                             torch.bfloat16)]
    with torch.no_grad():
        got = tbt.convnext_block_train(*targs)
    torch.testing.assert_close(got, tcb.block_reference(*targs), rtol=0, atol=0)
