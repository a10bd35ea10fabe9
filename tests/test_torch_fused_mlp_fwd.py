"""Port of the trainable MLP forwards (kernels #7 and #5) against the JAX
package's.

The JAX side runs ``fused_ln_mlp`` and ``fused_mlp`` with ``interpret=True``
(their Pallas forward and backward kernels in interpret mode); the port's
``fused_ln_mlp`` and ``fused_mlp``, given CPU tensors, run the plain versions
of their kernels with the same rounding points. The same seeded numpy inputs
go to both; the loss is ``sum(out.float() ** 2)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.ops import fused_mlp as tfm
from spine_vision_tpu.ops.fused_mlp import fused_ln_mlp, fused_mlp


def _weights(rng, c):
    return {
        "ln_scale": (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
        "ln_bias": (0.05 * rng.normal(size=(c,))).astype(np.float32),
        "w1": (rng.normal(size=(c, 4 * c)) * c ** -0.5).astype(np.float32),
        "b1": (0.1 * rng.normal(size=(4 * c,))).astype(np.float32),
        "w2": (rng.normal(size=(4 * c, c)) * (4 * c) ** -0.5).astype(np.float32),
        "b2": (0.1 * rng.normal(size=(c,))).astype(np.float32),
        "gamma": (0.5 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
    }


LOW = {"x", "w1", "w2", "residual"}  # cast to the compute dtype; the rest stay f32


def _jax_in(name, a, dtype):
    return jnp.asarray(a, dtype if name in LOW else jnp.float32)


def _torch_in(name, a, dtype):
    t = torch.from_numpy(a)
    if name in ("w1", "w2"):
        t = t.t().contiguous()  # the port keeps [out, in]
    return t.to(dtype if name in LOW else torch.float32).requires_grad_(True)


def _port_grad(name, t):
    g = t.grad.float().numpy()
    return g.T if name in ("w1", "w2") else g


def _compare(names, jargs, targs, jout, tout, want_grads, dtype):
    """Forward and every gradient. f32: sums in another order, 5e-4 of
    max(1, max |ref|) forward, 5e-3 for the gradients (as the JAX package's own
    tests). bf16: the same rounding points on both sides, but a value on a
    rounding boundary can round apart: 1e-2 of the scale forward (one bf16
    step of the output and a flipped hidden), 3e-2 for the gradients (about
    four bf16 steps)."""
    f32 = dtype == "float32"
    ref = np.asarray(jout, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(tout.detach().float().numpy() / scale, ref / scale,
                               atol=5e-4 if f32 else 1e-2)
    tol = 5e-3 if f32 else 3e-2
    for name, ja, ta, wa in zip(names, jargs, targs, want_grads):
        assert ta.grad is not None and ta.grad.dtype == ta.dtype, name
        assert np.dtype(wa.dtype) == np.dtype(ja.dtype), name
        ref = np.asarray(wa, np.float32)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(_port_grad(name, ta) / scale, ref / scale, atol=tol,
                                   err_msg=f"grad mismatch for {name}")


LN_NAMES = ["x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "gamma", "residual"]


@pytest.mark.parametrize("shape", [(2, 4, 6, None), (40, None)], ids=["nhwc", "flat"])
@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_matches_jax(shape, c, dtype):
    """C = 512 takes the JAX package's resident-weights backward (#8), C = 128
    the chunked one (#9); 40 flat tokens leave a ragged JAX token tile."""
    rng = np.random.default_rng(c + len(shape))
    act = tuple(c if d is None else d for d in shape)
    w = _weights(rng, c)
    vals = {"x": rng.normal(size=act).astype(np.float32), **w,
            "residual": rng.normal(size=act).astype(np.float32)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [_jax_in(n, vals[n], jdt) for n in LN_NAMES]

    def loss(*a):
        return jnp.sum(fused_ln_mlp(*a, interpret=True).astype(jnp.float32) ** 2)

    jout = fused_ln_mlp(*jargs, interpret=True)
    want = jax.grad(loss, argnums=tuple(range(9)))(*jargs)
    targs = [_torch_in(n, vals[n], tdt) for n in LN_NAMES]
    tout = tfm.fused_ln_mlp(*targs)
    assert tout.dtype == tdt and tout.shape == act
    assert type(tout.grad_fn).__name__ == "_FusedLnMlpBackward"
    (tout.float() ** 2).sum().backward()
    _compare(LN_NAMES, jargs, targs, jout, tout, want, dtype)


MLP_FORMS = {
    "tail": ("gamma", "residual"),
    "residual_only": ("residual",),  # the ConvNeXt block without LayerScale
    "no_tail": (),
}


@pytest.mark.parametrize("form,c", [("tail", 128), ("residual_only", 128), ("no_tail", 128),
                                    ("residual_only", 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_matches_jax(form, c, dtype):
    rng = np.random.default_rng(7 * c + len(form))
    m = 150
    w = _weights(rng, c)
    vals = {"x": rng.normal(size=(m, c)).astype(np.float32), **w,
            "residual": rng.normal(size=(m, c)).astype(np.float32)}
    names = ["x", "w1", "b1", "w2", "b2", *MLP_FORMS[form]]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [_jax_in(n, vals[n], jdt) for n in names]

    def call(fn, args, **kw):
        return fn(*args[:5], **dict(zip(names[5:], args[5:])), **kw)

    def loss(*a):
        return jnp.sum(call(fused_mlp, a, interpret=True).astype(jnp.float32) ** 2)

    jout = call(fused_mlp, jargs, interpret=True)
    want = jax.grad(loss, argnums=tuple(range(len(names))))(*jargs)
    targs = [_torch_in(n, vals[n], tdt) for n in names]
    tout = call(tfm.fused_mlp, targs)
    assert tout.dtype == tdt and tout.shape == (m, c)
    assert type(tout.grad_fn).__name__ == "_FusedMlpBackward"
    (tout.float() ** 2).sum().backward()
    _compare(names, jargs, targs, jout, tout, want, dtype)


def test_above_max_fused_dim_both_run_the_plain_composition():
    """C = 1024 > MAX_FUSED_DIM: on CPU tensors both functions take the plain
    composition, differentiated by autograd, as the JAX functions take their
    XLA one (a CUDA tensor raises: ``test_torch_kernels_gpu.py``). The port
    dispatches on C (the last axis) for NHWC input too."""
    rng = np.random.default_rng(9)
    c, m = 1024, 24
    w = _weights(rng, c)
    vals = {"x": rng.normal(size=(m, c)).astype(np.float32), **w,
            "residual": rng.normal(size=(m, c)).astype(np.float32)}
    jargs = [_jax_in(n, vals[n], jnp.float32) for n in LN_NAMES]
    targs = [_torch_in(n, vals[n], torch.float32) for n in LN_NAMES]
    tout = tfm.fused_ln_mlp(*targs)
    assert type(tout.grad_fn).__name__ != "_FusedLnMlpBackward"

    def loss(*a):
        return jnp.sum(fused_ln_mlp(*a, interpret=True) ** 2)

    want = jax.grad(loss, argnums=tuple(range(9)))(*jargs)
    (tout ** 2).sum().backward()
    _compare(LN_NAMES, jargs, targs, fused_ln_mlp(*jargs, interpret=True), tout, want,
             "float32")

    names = ["x", "w1", "b1", "w2", "b2", "gamma", "residual"]
    jargs = [_jax_in(n, vals[n], jnp.float32) for n in names]
    targs = [_torch_in(n, vals[n], torch.float32) for n in names]
    tout = tfm.fused_mlp(*targs)
    assert type(tout.grad_fn).__name__ != "_FusedMlpBackward"

    def loss_mlp(*a):
        return jnp.sum(fused_mlp(*a, interpret=True) ** 2)

    want = jax.grad(loss_mlp, argnums=tuple(range(7)))(*jargs)
    (tout ** 2).sum().backward()
    _compare(names, jargs, targs, fused_mlp(*jargs, interpret=True), tout, want, "float32")

    nhwc = torch.from_numpy(vals["x"]).reshape(2, 3, 4, c).requires_grad_(True)
    params = [_torch_in(n, vals[n], torch.float32) for n in LN_NAMES[1:8]]
    out = tfm.fused_ln_mlp(nhwc, *params, torch.zeros(2, 3, 4, c))
    assert type(out.grad_fn).__name__ != "_FusedLnMlpBackward" and out.shape == nhwc.shape


def test_plain_versions_are_what_the_wrappers_give_on_the_cpu():
    """On CPU tensors the kernel wrappers are their plain versions, and no
    launch is counted."""
    rng = np.random.default_rng(10)
    c = 128
    w = {k: torch.from_numpy(v) for k, v in _weights(rng, c).items()}
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, c)).astype(np.float32)).bfloat16()
    res = torch.from_numpy(rng.normal(size=(2, 3, 5, c)).astype(np.float32)).bfloat16()
    w1t, w2t = w["w1"].t().contiguous().bfloat16(), w["w2"].t().contiguous().bfloat16()
    before = tfm.ln_mlp.launches, tfm.mlp_fwd.launches
    got = tfm.ln_mlp(x, w["ln_scale"], w["ln_bias"], w1t, w["b1"], w2t, w["b2"], w["gamma"], res)
    want = tfm.ln_mlp_reference(x, w["ln_scale"], w["ln_bias"], w1t, w["b1"], w2t, w["b2"],
                                w["gamma"], res)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = tfm.mlp_fwd(x, w1t, w["b1"], w2t, w["b2"])
    torch.testing.assert_close(got, tfm.mlp_reference(x, w1t, w["b1"], w2t, w["b2"]),
                               rtol=0, atol=0)
    assert (tfm.ln_mlp.launches, tfm.mlp_fwd.launches) == before
