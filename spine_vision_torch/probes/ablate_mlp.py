"""MLP-body ablation probe: where the time of the block MLP goes on the card
(``csrc/probe_mlp.cu``).

Counterpart of ``scripts/ablate_mlp_kernel.py`` (its ``pallas_call`` at :96,
the body ``make_kernel`` at :55). The old ``mma.sync`` row kernel
(``csrc/mlp_body.cuh``'s ``row_mlp_kernel`` in its copy form with the tail,
what #5 ran before its ``wgmma`` form) computes ``out = res + gamma * (W2 .
act(W1 . x + b1) + b2)`` with the hidden activation swapped; the probe
measures that recorded body, not the kernels #5 and #7 run now:

- ``gelu_tanh``: tanh-GELU in f32, the old body's own activation;
- ``full``: the A&S erf-GELU in f32 (the script's "full");
- ``relu``;
- ``gelu_bf16``: the erf-GELU in bf16 arithmetic on the bf16-rounded
  pre-activation;
- ``matmul_only``: the pre-activation only rounded to bf16;
- ``copy``: ``out = x + res`` through the same 64-token prologue and
  coalesced epilogue, no body (the script's grid-step floor).

At C = 128, 256 and 512 with M = B*H*W tokens of that stage (B = 32 in the
script). The script also swept the TPU's token tile (1024-4096 rows a grid
step); the old body has one tile, 64 tokens a CTA, so only C is swept. The
anchor row is #5 itself (``ops/fused_mlp.py::mlp_fwd``, the ``wgmma``
products of ``csrc/row_mlp.cu``) at the same shape: the old body against the
new on the same inputs. Rates are the script's:
``4 * M * C * 4C`` flops over the time, beside the share of 989 TFLOP/s.
The inputs follow the script's scales, but gamma is ``1 + 0.1 * N(0, 1)``
instead of ``0.01 * N(0, 1)``, so that the check against the plain version
sees the MLP and not only the residual.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from spine_vision_torch.ops import cuda_build
from spine_vision_torch.ops import fused_mlp as fm
from spine_vision_torch.probes import SEED, Row, format_row, measure, normal
from spine_vision_torch.probes.gelu_cost import BODY_OPS, erf_gelu

# The kernel's variant codes, in the script's order of report after the copy.
VARIANTS = {"gelu_tanh": 0, "full": 1, "relu": 2, "gelu_bf16": 3, "matmul_only": 4, "copy": 5}
STAGE_HW = {128: 128, 256: 64, 512: 32}  # C -> H = W of its stage at 512^2
ACT_OPS = {"gelu_tanh": BODY_OPS["tanh_gelu"], "full": BODY_OPS["gelu"], "relu": 1,
           "gelu_bf16": BODY_OPS["gelu"], "matmul_only": 0}


def _act(h: torch.Tensor, variant: str) -> torch.Tensor:
    """The f32 pre-activation ``h`` to the bf16 hidden."""
    bf16 = torch.bfloat16
    if variant == "gelu_tanh":
        return fm.tanh_gelu(h).to(bf16)
    if variant == "full":
        return erf_gelu(h).to(bf16)
    if variant == "relu":
        return torch.relu(h).to(bf16)
    if variant == "gelu_bf16":
        return erf_gelu(h.to(bf16))
    if variant == "matmul_only":
        return h.to(bf16)
    raise ValueError(f"unknown variant {variant!r}; one of {tuple(VARIANTS)}")


def mlp_ablate_reference(variant: str, x, w1t, b1, w2t, b2, gamma, res) -> torch.Tensor:
    """Plain version: f32 products on the bf16 operands, the hidden rounded
    where the kernel rounds it, ``(acc + b2) * gamma + res`` in f32 rounded
    once; ``copy`` is ``x + res`` rounded once."""
    if variant == "copy":
        return (x.float() + res.float()).to(x.dtype)
    h = _act(x.float() @ w1t.float().t() + b1.float(), variant)
    out = (h.float() @ w2t.float().t() + b2.float()) * gamma.float() + res.float()
    return out.to(x.dtype)


def mlp_ablate(variant: str, x, w1t, b1, w2t, b2, gamma, res) -> torch.Tensor:
    """One ablation variant over [M, C] rows (C = 128, 256 or 512) by
    ``csrc/probe_mlp.cu`` on CUDA tensors (x, res, w1t [4C, C], w2t [C, 4C]
    bf16; b1, b2, gamma f32), :func:`mlp_ablate_reference` on CPU tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {tuple(VARIANTS)}")
    if x.device.type == "cpu":
        return mlp_ablate_reference(variant, x, w1t, b1, w2t, b2, gamma, res)
    c = x.shape[-1]
    if c not in STAGE_HW:
        raise ValueError(f"mlp_ablate is built for C in {tuple(STAGE_HW)}, got {c}")
    fm._check("mlp_ablate", x, res, (("b1", b1, 4 * c), ("b2", b2, c), ("gamma", gamma, c)),
              w1t, w2t, g_name="residual")
    out = torch.empty_like(x)
    fn = cuda_build.load("probe_mlp").svt_probe_mlp
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(VARIANTS[variant], p(x), p(res), p(w1t), p(b1), p(w2t), p(b2), p(gamma), p(out),
             ctypes.c_longlong(x.numel() // c), c, cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "mlp_ablate")
    mlp_ablate.launches += 1
    return out


mlp_ablate.launches = 0


def _library(variant: str, x, w1t, b1, w2t, b2, gamma, res):
    """PyTorch's own computation of the variant, in bf16 (bias and gamma cast)."""
    if variant == "copy":
        return lambda: x + res
    bf16 = torch.bfloat16
    b1b, b2b, gb = b1.to(bf16), b2.to(bf16), gamma.to(bf16)
    act = {"gelu_tanh": lambda h: F.gelu(h, approximate="tanh"), "full": F.gelu,
           "relu": F.relu, "gelu_bf16": F.gelu, "matmul_only": lambda h: h}[variant]
    return lambda: F.linear(act(F.linear(x, w1t, b1b)), w2t, b2b) * gb + res


def inputs(c: int, batch: int, device) -> dict:
    """The script's inputs at width ``c``, in the port's weight layout."""
    rng = np.random.default_rng(SEED)
    m, h = batch * STAGE_HW[c] ** 2, 4 * c
    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "x": normal(rng, (m, c), 0.5, bf16, device),
        "w1t": normal(rng, (h, c), c ** -0.5, bf16, device),
        "b1": normal(rng, (h,), 0.01, f32, device),
        "w2t": normal(rng, (c, h), h ** -0.5, bf16, device),
        "b2": normal(rng, (c,), 0.01, f32, device),
        "gamma": (1.0 + normal(rng, (c,), 0.1, f32, device)).contiguous(),
        "res": normal(rng, (m, c), 0.5, bf16, device),
    }


def run(device: str | torch.device = "cuda", batch: int = 32, report=print) -> list[Row]:
    """Every variant at C = 128, 256, 512 (M = batch * H * W), then #5."""
    from spine_vision_torch.device import resolve_device

    dev = resolve_device(device)
    rows = []
    for c in STAGE_HW:
        a = inputs(c, batch, dev)
        args = tuple(a[k] for k in ("x", "w1t", "b1", "w2t", "b2", "gamma", "res"))
        m = a["x"].shape[0]
        weights = 2 * 4 * c * c * 2 + 6 * c * 4
        for variant in ("copy", "matmul_only", "relu", "gelu_bf16", "full", "gelu_tanh"):
            body = variant != "copy"
            row = Row(
                "ablate_mlp_kernel", f"C={c} {variant}", "mlp_ablate",
                f"M={m}, 64 tokens a CTA", nbytes=3 * m * c * 2 + (weights if body else 0),
                flops=16 * m * c * c if body else 0,
                f32_ops=(m * 4 * c * (1 + ACT_OPS[variant]) + 3 * m * c) if body else m * c,
                rate="TFLOP/s" if body else "GB/s",
                call=lambda v=variant: mlp_ablate(v, *args),
                plain=lambda v=variant: mlp_ablate_reference(v, *args),
                library=_library(variant, *args), tol=2e-2)
            rows.append(measure(row, dev))
            report(format_row(row))
        x, w1t, b1, w2t, b2, gamma, res = args
        row = Row("ablate_mlp_kernel", f"C={c} anchor #5", "mlp_fwd",
                  "ops/fused_mlp.py::mlp_fwd, tail form", 3 * m * c * 2 + weights,
                  16 * m * c * c, m * 4 * c * (1 + ACT_OPS["gelu_tanh"]) + 3 * m * c, "TFLOP/s",
                  call=lambda: fm.mlp_fwd(x, w1t, b1, w2t, b2, gamma, res),
                  plain=lambda: fm.mlp_reference(x, w1t, b1, w2t, b2, gamma, res),
                  library=_library("gelu_tanh", *args), tol=2e-2)
        rows.append(measure(row, dev))
        report(format_row(row))
    return rows
