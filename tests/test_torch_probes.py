"""The port's measurement probes (``spine_vision_torch/probes``) against the
JAX scripts they replace, on the CPU, at small sizes.

Each script is loaded from ``scripts/`` with ``importlib`` and its kernel
runs through ``pl.pallas_call(..., interpret=pltpu.InterpretParams())``, the
TPU interpret mode, which runs the scripts' DMAs and semaphores on the CPU;
the scripts themselves are not edited (the loaded module's ``pl`` is swapped
for one whose ``pallas_call`` interprets). The port's wrappers, given CPU
tensors, run their plain versions, which the card's kernels are held to in
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``. Where the script's
kernel cannot run here, the plain version is held to the function it
computes, and the test says so:

- ``probe_copy_bw5.py::emitpipe_copy`` (``emit_pipeline`` asks for a TPU
  device kind): a copy, the identity;
- ``probe_copy_bw2.py::manual_copy`` runs at S = 2 only (at S >= 3 it
  leaves one out-DMA unwaited, and the interpreter does not write that tile);
- ``probe_gelu_cost.py`` imports ``_erf_gelu`` from
  ``spine_vision_tpu.ops.fused_mlp``, which no longer defines it: its bodies
  are held to ``fused_mlp._tanh_gelu`` and ``_gelu_and_grad`` and to the A&S
  erf-GELU of ``ablate_mlp_kernel.py:42``.

Tolerances: copies, the read-only token and the write-only broadcast bit for
bit; the GELU bodies 1e-2 * max |reference| (f32 on both sides, rounded once
to bf16); the MLP ablation 2e-2 * max |reference| (bf16 hidden and output on
both sides: a value on a rounding boundary can round apart).
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spine_vision_torch import probes
from spine_vision_torch.probes import ablate_mlp as am
from spine_vision_torch.probes import copy_bw as cp
from spine_vision_torch.probes import gelu_cost as gc
from spine_vision_torch.probes.__main__ import main as probes_main
from spine_vision_tpu.ops import fused_mlp as jfm

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
M, C = 2 * 16 * 16, 128  # a batch of 2 at the 16^2 stage


def _script(name: str) -> types.ModuleType:
    """``scripts/<name>.py`` with its ``pl.pallas_call`` in interpret mode."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams())
    module.pl = shim
    return module


def _pair(rng, shape, dtype=np.float32):
    """The same values as a JAX array and a torch tensor (bf16 unless int8)."""
    if dtype == np.int8:
        a = rng.integers(-100, 100, size=shape, dtype=np.int8)
        return jnp.asarray(a), torch.from_numpy(a)
    a = rng.normal(size=shape).astype(np.float32)
    if dtype == "f32":
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(_np(torch_out), _np(jax_out))


# ------------------------------------------------------------------ streaming


@pytest.mark.parametrize("tile", [256, 512])
def test_copy_tiled_is_probe_copy_bw_copy(tile):
    jx, tx = _pair(np.random.default_rng(0), (M, C))
    _same(_script("probe_copy_bw").make_copy(M, C, tile)(jx), cp.copy_tiled(tx, tile))


def test_probe_copy_bw2_mechanisms_are_copies():
    """The ring at S = 2 only: with S >= 3 the script's ``manual_copy`` never
    waits on one out-DMA (step ``n - 2`` when ``n`` tiles), and the interpreter
    leaves that tile unwritten."""
    mod = _script("probe_copy_bw2")
    jx, tx = _pair(np.random.default_rng(1), (M, C))
    _same(mod.auto_copy(M, C, 128)(jx), cp.copy_tiled(tx, 128))
    wide = mod.auto_copy(M // 8, 8 * C, 64)(jx.reshape(M // 8, 8 * C)).reshape(M, C)
    _same(wide, cp.copy_tiled(tx.view(M // 8, 8 * C), 64).view(M, C))
    _same(mod.manual_copy(M, C, 128, 2)(jx), cp.copy_staged(tx, 2, 64))
    _same(mod.hbm_dma_copy(M, C)(jx), cp.copy_bulk(tx, 2, 384))


@pytest.mark.parametrize("dtype,c", [("bf16", 128), ("bf16", 512), ("f32", 128), (np.int8, 256)])
@pytest.mark.parametrize("vector", [True, False])
def test_copy_tiled_is_probe_copy_bw3_copy_by_dtype(dtype, c, vector):
    jx, tx = _pair(np.random.default_rng(2), (M, c), dtype)
    _same(_script("probe_copy_bw3").auto_copy(M, c, 128, jx.dtype)(jx),
          cp.copy_tiled(tx, 128, vector))


def test_probe_copy_bw4_many_in_flight_are_copies():
    mod = _script("probe_copy_bw4")
    jx, tx = _pair(np.random.default_rng(3), (M, C))
    _same(mod.vmem_copy(M, C, 64, 4)(jx), cp.copy_staged(tx, 4, 64))
    _same(mod.hbm_copy(M, C, 64, 4)(jx), cp.copy_bulk(tx, 4, 128))


def test_read_only_token_is_probe_copy_bw5_read_only():
    """The script's token at 8-row tiles: the in-order f32 sum of every 8-row
    group, cast to bf16. The port folds every row of its larger tiles into
    that token, in the same order (one CTA: the same additions), and keeps
    it in f32."""
    jx, tx = _pair(np.random.default_rng(4), (M, C))
    token = _script("probe_copy_bw5").read_only(M, C, 8, 2)(jx)
    got = cp.read_only(tx, 64, 2)
    assert got.dtype == torch.float32 and got.shape == (8, C)
    _same(token, got.to(torch.bfloat16))


def test_read_only_grouping_only_reorders_the_sum():
    """Over several CTAs the port adds each CTA's tiles, then the CTAs' sums;
    f32 sums of 64 bf16 terms in another order: within 1e-5 relative."""
    _, tx = _pair(np.random.default_rng(5), (M, C))
    one = cp.read_only_reference(tx, 32, 1)
    np.testing.assert_allclose(cp.read_only_reference(tx, 32, 3).numpy(), one.numpy(),
                               rtol=1e-5, atol=1e-5)
    folded = tx.float().view(-1, 8, C).sum(0)  # every row r into token row r mod 8
    np.testing.assert_allclose(one.numpy(), folded.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        cp.read_only_reference(tx, 12, 1)  # tiles must be whole 8-row groups


@pytest.mark.parametrize("bulk", [True, False])
def test_write_only_is_probe_copy_bw5_write_only(bulk):
    jseed, tseed = _pair(np.random.default_rng(6), (8, C))
    _same(_script("probe_copy_bw5").write_only(M, C, 64, 2)(jseed), cp.write_only(tseed, M, bulk))


def test_priority_split_is_probe_copy_bw5_priority_copies():
    """The DMA priorities' counterpart, two streams, is a copy like them."""
    mod = _script("probe_copy_bw5")
    jx, tx = _pair(np.random.default_rng(7), (M, C))
    got = cp.copy_bulk_split(tx, 4, 128)
    _same(mod.hbm_prio_split(M, C, 64, 4)(jx), got)
    _same(mod.vmem_prio_copy(M, C, 64, 4)(jx), got)


def test_emitpipe_counterpart_is_the_identity():
    """``emitpipe_copy`` does not run in interpret mode here (it asks for a
    TPU device kind); its counterpart, the double-buffered ring, is held to
    the function it computes, the identity."""
    _, tx = _pair(np.random.default_rng(8), (M, C))
    assert torch.equal(cp.copy_staged(tx, 2, 64), tx)


def test_inc_copy_forms_are_probe_copy_bw6():
    """``x + 1`` in bf16 over two payloads: one launch, two streams, two
    dependent launches, as the script's one_kernel, two_kernels and
    interleaved."""
    mod = _script("probe_copy_bw6")
    mod.M, mod.C, mod.TILE_M = M, C, 128
    rng = np.random.default_rng(9)
    (ja, ta), (jb, tb) = _pair(rng, (M, C)), _pair(rng, (M, C))
    for jfn, tfn in ((mod.one_kernel, lambda a, b: cp.inc_copy(a, b)),
                     (mod.two_kernels, cp.inc_two_streams),
                     (mod.interleaved, cp.inc_interleaved)):
        for jout, tout in zip(jfn(ja, jb), tfn(ta, tb), strict=True):
            _same(jout, tout)


# ----------------------------------------------------------------------- GELU


def _as_erf_gelu():
    return _script("ablate_mlp_kernel")._erf_gelu


@pytest.mark.parametrize("body", ["copy", "gelu", "gelu+grad", "tanh_gelu"])
def test_gelu_bodies_match_the_jax_functions(body):
    """Each body in f32 on the bf16 input, rounded once, against the JAX
    functions it computes: ``fused_mlp._tanh_gelu`` and ``_gelu_and_grad``
    (the sum of both, as the script sums them) and the A&S erf-GELU."""
    jx, tx = _pair(np.random.default_rng(10), (M, 512))
    tx = (tx.float() * 3).to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy(), jnp.bfloat16)
    xf = jx.astype(jnp.float32)
    ref = {"copy": xf, "gelu": _as_erf_gelu()(xf), "gelu+grad": sum(jfm._gelu_and_grad(xf)),
           "tanh_gelu": jfm._tanh_gelu(xf)}[body].astype(jnp.bfloat16)
    got = gc.gelu_map(tx, body)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    ref = _np(ref)
    assert np.abs(_np(got) - ref).max() <= 1e-2 * np.abs(ref).max()


def test_max_error_tolerances():
    """The check every probe kernel meets on the card: bit for bit, one bf16
    ulp of the plain value element by element, or a share of max |plain|."""
    want = torch.tensor([1.0, -0.5, 3.0, 0.0], dtype=torch.bfloat16)
    ulp = torch.tensor([2.0**-7, 2.0**-8, 2.0**-6, 0.0])
    one_off = (want.float() + ulp).to(torch.bfloat16)
    assert probes.max_error(want.clone(), want, None) == 0
    with pytest.raises(AssertionError):
        probes.max_error(one_off, want, None)
    assert probes.max_error(one_off, want, "ulp") == 2.0**-6
    with pytest.raises(AssertionError):  # two ulps at 1.0
        probes.max_error((want.float() + 2 * ulp).to(torch.bfloat16), want, "ulp")
    with pytest.raises(AssertionError):  # plain 0: only the smallest subnormal passes
        probes.max_error(torch.tensor([1.0, -0.5, 3.0, 2.0**-20], dtype=torch.bfloat16),
                         want, "ulp")
    assert probes.max_error((one_off, want), (want, want), 1e-2) == 2.0**-6
    with pytest.raises(AssertionError):
        probes.max_error(one_off, want, 1e-3)


def test_erf_gelu_in_bf16_is_the_script_formula():
    """The bf16-arithmetic erf-GELU (every operation rounded) against the
    script's formula on a bf16 array."""
    jx, tx = _pair(np.random.default_rng(11), (M, 512))
    ref = _np(_as_erf_gelu()(jx))
    got = _np(gc.erf_gelu(tx))
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


# ------------------------------------------------------------- MLP ablation


def _ablate_inputs(c: int, m: int = M, seed: int = 12):
    rng = np.random.default_rng(seed)
    h = 4 * c
    x = (rng.normal(size=(m, c)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(c, h)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.normal(size=(1, h)) * 0.01).astype(np.float32)
    w2 = (rng.normal(size=(h, c)) / np.sqrt(h)).astype(np.float32)
    b2 = (rng.normal(size=(1, c)) * 0.01).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=(1, c))).astype(np.float32)
    res = (rng.normal(size=(m, c)) * 0.5).astype(np.float32)
    bf = jnp.bfloat16
    jargs = (jnp.asarray(x, bf), jnp.asarray(w1, bf), jnp.asarray(b1), jnp.asarray(w2, bf),
             jnp.asarray(b2), jnp.asarray(gamma), jnp.asarray(res, bf))
    t = torch.from_numpy
    targs = (t(x).to(torch.bfloat16), t(w1.T.copy()).to(torch.bfloat16), t(b1[0]),
             t(w2.T.copy()).to(torch.bfloat16), t(b2[0]), t(gamma[0]), t(res).to(torch.bfloat16))
    return jargs, targs


def _script_mlp(variant: str, jargs, tile_m: int = 128):
    """``ablate_mlp_kernel.make_kernel(variant)`` with the script's BlockSpecs
    (memory spaces dropped), in interpret mode."""
    mod = _script("ablate_mlp_kernel")
    m, c = jargs[0].shape
    h = 4 * c
    tok = pl.BlockSpec((tile_m, c), lambda i: (i, 0))

    def fix(shape):
        return pl.BlockSpec(shape, lambda i: (0, 0))

    call = pl.pallas_call(
        mod.make_kernel(variant), grid=(m // tile_m,),
        in_specs=[tok, fix((c, h)), fix((1, h)), fix((h, c)), fix((1, c)), fix((1, c)), tok],
        out_specs=tok, out_shape=jax.ShapeDtypeStruct((m, c), jnp.bfloat16), interpret=True)
    return call(*jargs)


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("variant", ["copy", "matmul_only", "relu", "gelu_bf16", "full"])
def test_mlp_ablation_variants_match_the_script_kernel(c, variant):
    jargs, targs = _ablate_inputs(c)
    ref = _np(_script_mlp(variant, jargs))
    got = am.mlp_ablate(variant, *targs)
    assert got.dtype == torch.bfloat16 and got.shape == (M, c)
    err = np.abs(_np(got) - ref).max()
    if variant == "copy":
        assert err == 0
    assert err <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("c", [128, 512])
def test_mlp_ablation_production_activation_is_the_reference_mlp(c):
    """``gelu_tanh``, what #5 runs, against ``fused_mlp.mlp_reference`` with
    the tail, and the port's own #5 plain version."""
    jargs, targs = _ablate_inputs(c)
    x, w1, b1, w2, b2, gamma, res = jargs
    ref = _np(jfm.mlp_reference(x, w1, b1[0], w2, b2[0], gamma[0], res))
    got = am.mlp_ablate("gelu_tanh", *targs)
    assert np.abs(_np(got) - ref).max() <= 2e-2 * np.abs(ref).max()
    assert torch.equal(got, am.fm.mlp_fwd(*targs[:6], targs[6]))


def test_mlp_ablation_rejects_unknown_variants():
    _, targs = _ablate_inputs(128, m=64)
    with pytest.raises(ValueError):
        am.mlp_ablate("gelu_exact", *targs)


# ---------------------------------------------------------------- entry point


def test_probes_run_end_to_end_on_the_cpu(capsys):
    """Every probe at batch 1 on the CPU: each row ran its plain version and
    no time was measured; the entry point prints a line a row."""
    tables = probes.run("all", device="cpu", batch=1)
    assert set(tables) == {"copy", "gelu", "mlp"}
    rows = [r for t in tables.values() for r in t]
    kernels = {r.kernel for r in rows}
    assert {"copy_tiled", "copy_staged", "copy_bulk", "read_only", "write_only", "inc_copy",
            "gelu_map", "mlp_ablate", "mlp_fwd"} <= kernels
    assert all(r.ms is None and r.library_ms is None for r in rows)
    assert all(r.bound_ms > 0 for r in rows)
    out = capsys.readouterr().out
    assert out.count("[probe] ") == len(rows)
    assert "not measured" in out


def test_probes_module_entry_point_on_the_cpu(capsys):
    assert probes_main(["gelu", "--device", "cpu", "--batch", "1"]) == 0
    assert capsys.readouterr().out.count("probe_gelu_cost") == 5


def test_probes_default_to_the_card_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probes.run("copy")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probes_main(["mlp"])
    with pytest.raises(ValueError):
        probes.run("nothing", device="cpu")


def test_build_diff_runs_on_the_card_only(monkeypatch, tmp_path):
    """The build comparison needs the card for its timings and raises
    without one before it compiles anything."""
    from spine_vision_torch.probes import build_diff

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_diff.main(["--parent", str(tmp_path)])
