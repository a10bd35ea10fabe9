"""GELU-cost probe: what the block MLP's activation costs per element on the
card (``csrc/probe_gelu.cu``).

Counterpart of ``scripts/probe_gelu_cost.py`` (its ``pallas_call`` at :45),
which chose the tanh-GELU of the TPU kernels
(``spine_vision_tpu/ops/fused_mlp.py:47-58``). One elementwise pass over the
stage-1 hidden, [B*128*128, 512] bf16, with four bodies in f32 on the bf16
input, rounded once: ``copy``, ``gelu`` (the Abramowitz & Stegun erf-GELU of
``scripts/ablate_mlp_kernel.py:42``; the script imports an ``_erf_gelu`` that
``fused_mlp.py`` no longer defines), ``gelu+grad`` (``h + dh`` of the
production ``svt::gelu_and_grad``) and ``tanh_gelu`` (``svt::gelu_tanh``).
The bodies are the production kernels' own device functions; the time beyond
``copy`` is what each costs per pass. Yardstick: ``F.gelu(x.float(),
approximate="tanh")``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from spine_vision_torch.ops import cuda_build
from spine_vision_torch.ops.fused_mlp import gelu_and_grad, tanh_gelu
from spine_vision_torch.probes import SEED, Row, format_row, measure, normal

HIDDEN = 512  # 4 * C at stage 1
IMAGE_TOKENS = 128 * 128
# Abramowitz & Stegun 7.1.26 (|error| < 1.5e-7), as ablate_mlp_kernel.py.
AS_P = 0.3275911
AS_COEFFS = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
BODIES = ("copy", "gelu", "gelu+grad", "tanh_gelu")  # the kernel's op codes 0-3
# f32 operations an element of each body (tanh, exp and a division count one).
BODY_OPS = {"copy": 0, "gelu": 22, "gelu+grad": 17, "tanh_gelu": 9}


def erf_gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU through the A&S erf, in ``x``'s dtype: with a bf16 ``x`` every
    operation rounds to bf16, its constants too, as JAX evaluates the formula
    on a bf16 array."""
    def k(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    z = x * k(1.0 / math.sqrt(2.0))
    az = z.abs()
    t = 1.0 / (1.0 + k(AS_P) * az)
    poly = t * k(AS_COEFFS[-1])
    for a in AS_COEFFS[-2::-1]:
        poly = t * (k(a) + poly)
    erf_abs = 1.0 - poly * torch.exp(-(az * az))
    return (0.5 * x) * (1.0 + torch.sign(z) * erf_abs)


def gelu_reference(x: torch.Tensor, body: str) -> torch.Tensor:
    """The body in f32 on ``x``, rounded once to ``x``'s dtype."""
    xf = x.float()
    if body == "copy":
        out = xf
    elif body == "gelu":
        out = erf_gelu(xf)
    elif body == "gelu+grad":
        out = sum(gelu_and_grad(xf))
    elif body == "tanh_gelu":
        out = tanh_gelu(xf)
    else:
        raise ValueError(f"unknown body {body!r}; one of {BODIES}")
    return out.to(x.dtype)


def gelu_map(x: torch.Tensor, body: str) -> torch.Tensor:
    """``body`` over bf16 ``x`` by ``csrc/probe_gelu.cu::gelu_map`` on a CUDA
    tensor, :func:`gelu_reference` on a CPU tensor."""
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; one of {BODIES}")
    if x.device.type == "cpu":
        return gelu_reference(x, body)
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16 or x.numel() % 8:
        raise ValueError("gelu_map takes contiguous, 16-byte aligned bf16 of 8k values")
    y = torch.empty_like(x)
    fn = cuda_build.load("probe_gelu").svt_probe_gelu
    fn.restype = ctypes.c_int
    err = fn(BODIES.index(body), cuda_build.ptr(x), cuda_build.ptr(y),
             ctypes.c_longlong(x.numel()), cuda_build.stream_ptr(x.device))
    cuda_build.check(err, "gelu_map")
    gelu_map.launches += 1
    return y


gelu_map.launches = 0


def _library(x: torch.Tensor, body: str, out: torch.Tensor):
    """PyTorch's own computation of the body on ``x``."""
    if body == "copy":
        return lambda: out.copy_(x)
    if body == "gelu":
        return lambda: F.gelu(x)
    if body == "tanh_gelu":
        return lambda: F.gelu(x, approximate="tanh")
    ones = torch.ones_like(x)
    return lambda: F.gelu(x, approximate="tanh") + torch.ops.aten.gelu_backward(
        ones, x, approximate="tanh")


def run(device: str | torch.device = "cuda", batch: int = 32, report=print) -> list[Row]:
    """The four bodies over [batch*128*128, 512] bf16 (the script's batch is
    32), then the yardstick, and each body's time beyond the copy."""
    from spine_vision_torch.device import resolve_device

    dev = resolve_device(device)
    x = normal(np.random.default_rng(SEED), (batch * IMAGE_TOKENS, HIDDEN), 1.0,
               torch.bfloat16, dev)
    out = torch.empty_like(x)
    rows = []
    for body in BODIES:
        row = Row("probe_gelu_cost", body, "gelu_map", f"op {BODIES.index(body)}, 16 B a thread",
                  nbytes=2 * x.numel() * 2, flops=0, f32_ops=BODY_OPS[body] * x.numel(),
                  rate="GB/s", call=lambda b=body: gelu_map(x, b),
                  plain=lambda b=body: gelu_reference(x, b), library=_library(x, body, out),
                  tol=None if body == "copy" else "ulp")
        rows.append(measure(row, dev))
        report(format_row(row))
    yard = Row("probe_gelu_cost", "torch_tanh_gelu_f32", "torch",
               'F.gelu(x.float(), approximate="tanh")', x.numel() * (2 + 4), 0,
               BODY_OPS["tanh_gelu"] * x.numel(), "GB/s",
               call=lambda: F.gelu(x.float(), approximate="tanh"), plain=None, library=None,
               tol=None)
    rows.append(measure(yard, dev))
    report(format_row(yard))
    if dev.type == "cuda":
        copy_ms = rows[0].ms
        report("[probe] probe_gelu_cost ms beyond copy: " + ", ".join(
            f"{r.variant} {r.ms - copy_ms:+.4f}" for r in rows[1:len(BODIES)]))
    return rows
