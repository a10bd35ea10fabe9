"""Measurement probes of the port on the card: what streaming, the GELU and
the ConvNeXt block's MLP body cost on an H100.

The counterparts of the JAX package's measurement scripts, which picked its
kernel designs on the TPU:

- :mod:`.copy_bw`: ``scripts/probe_copy_bw.py`` and ``probe_copy_bw2.py`` to
  ``probe_copy_bw6.py``, device-memory streaming by mechanism
  (``csrc/probe_copy.cu``);
- :mod:`.gelu_cost`: ``scripts/probe_gelu_cost.py``, the activation's cost
  per element (``csrc/probe_gelu.cu``);
- :mod:`.ablate_mlp`: ``scripts/ablate_mlp_kernel.py``, the MLP body's time
  split between products, activation and data movement
  (``csrc/probe_mlp.cu``).

Beside them, :mod:`.build_diff` holds this tree's build of the MLP body's
kernels against another checkout's.

``python -m spine_vision_torch.probes [copy|gelu|mlp|all]`` prints each
probe's table. Every probe runs on the card by default; on ``device="cpu"``
each kernel wrapper runs its plain version and no time is measured. Each
table row carries the kernel call, its plain version and a PyTorch yardstick,
so a caller can check the kernel against its plain version
(``chip_smoke.py`` does).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
L2_BYTES = 50 * 2**20
SEED = 0  # every probe's inputs come from numpy.random.default_rng(SEED), as the scripts'


@dataclasses.dataclass
class Row:
    """One variant of a probe: the script and its variant name, the port's
    kernel (a wrapper's name) and its parameters, the work it must do, and
    its time on the card (None where it was not measured)."""

    probe: str
    variant: str
    kernel: str
    config: str
    nbytes: float  # bytes the function must move: inputs read once, outputs written once
    flops: float  # bf16 tensor-core flops
    f32_ops: float  # f32 operations outside the tensor cores
    rate: str  # "GB/s" or "TFLOP/s"
    call: Callable = dataclasses.field(repr=False)
    plain: Callable | None = dataclasses.field(repr=False)  # None for a yardstick row
    library: Callable | None = dataclasses.field(repr=False)
    tol: float | str | None  # see max_error
    cold: bool = False  # the L2 cache flushed before each timed launch
    calls: int = 1  # the kernel's runs in one call of ``call``
    ms: float | None = None
    host_ms: float | None = None  # the host's time to enqueue a run
    library_ms: float | None = None

    @property
    def bound_ms(self) -> float:
        return max(self.nbytes / PEAK_BYTES_S, self.flops / PEAK_BF16_FLOPS,
                   self.f32_ops / PEAK_F32_FLOPS) * 1e3

    @property
    def bound_by(self) -> str:
        return "bytes" if self.nbytes / PEAK_BYTES_S * 1e3 >= self.bound_ms else "operations"

    def achieved(self, ms: float | None) -> float | None:
        """GB/s (bytes moved) or TFLOP/s (tensor flops) at ``ms``."""
        if ms is None:
            return None
        work = self.nbytes / 1e9 if self.rate == "GB/s" else self.flops / 1e12
        return work / (ms * 1e-3)

    @property
    def share(self) -> float | None:
        """The share of the card's peak: bytes over 3.35 TB/s or tensor flops
        over 989 TFLOP/s, as ``rate`` counts."""
        a = self.achieved(self.ms)
        if a is None:
            return None
        return a * 1e9 / PEAK_BYTES_S if self.rate == "GB/s" else a * 1e12 / PEAK_BF16_FLOPS


def time_ms(fn: Callable, iters: int = 20, warmup: int = 3, cold: bool = False,
            repeats: int = 3) -> tuple[float, float]:
    """``(device ms, host ms)`` a call of ``fn`` on the card, by CUDA events,
    beside the host's time to enqueue the call (where that is the larger, the
    device time is the host's). Back to back: the best of ``repeats`` runs of
    ``iters`` calls, as the JAX scripts take the best of three. ``cold``:
    the L2 cache flushed (a write of twice its size) before each call, each
    call timed alone, the median of ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if cold:
        flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32, device="cuda")
        pairs, host = [], []
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs), statistics.median(host)
    best, host = float("inf"), float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = min(host, (time.perf_counter() - t0) * 1e3 / iters)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best, host


def warm_up(device: torch.device, seconds: float = 0.5) -> None:
    """Keep the card busy for a while, so that the first probe does not meet
    it at idle clocks."""
    buf = torch.empty(2**28, dtype=torch.uint8, device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            buf.zero_()
        torch.cuda.synchronize(device)


def measure(row: Row, device: torch.device) -> Row:
    """Time the row's kernel and yardstick on the card, or run the kernel's
    wrapper once on the CPU (its plain version; no time). A call that runs
    the kernel ``row.calls`` times counts as that many."""
    if device.type == "cuda":
        ms, host = time_ms(row.call, cold=row.cold)
        row.ms, row.host_ms = ms / row.calls, host / row.calls
        if row.library is not None:
            row.library_ms = time_ms(row.library, cold=row.cold)[0]
    else:
        row.call()
    return row


def max_error(got, want, tol: float | str | None) -> float:
    """The max absolute error of a kernel's output(s) against its plain
    version's. Raises ``AssertionError`` where, with ``tol`` None, an output
    is not bit for bit; with "ulp", an element of a bf16 output is off by more
    than one bf16 ulp of the plain value (2^-133 below the smallest normal);
    with a number, an output is off by more than ``tol * max |plain|``."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        diff = (a.float() - b.float()).abs()
        err = diff.max().item()
        if tol is None and not torch.equal(a, b):
            raise AssertionError(f"differs from its plain version (max abs {err:.4g})")
        if tol == "ulp":
            p = b.float().abs()
            ulp = torch.ldexp(torch.ones_like(p), torch.frexp(p).exponent - 8)
            ulp = torch.where(p < 2.0**-126, torch.full_like(p, 2.0**-133), ulp)
            if not (diff <= ulp).all():
                raise AssertionError(f"an element is off by more than one bf16 ulp "
                                     f"(max abs {err:.4g})")
        if isinstance(tol, float) and not err <= tol * b.float().abs().max().item():
            raise AssertionError(f"max abs error {err:.4g} > {tol} * max |plain|")
        worst = max(worst, err)
    return worst


def format_row(row: Row) -> str:
    if row.ms is None:
        timing = "ms=not measured (CPU: the plain version ran)"
    else:
        lib = "" if row.library_ms is None else f" library_ms={row.library_ms:.4f}"
        timing = (f"ms={row.ms:.4f} {row.achieved(row.ms):.1f} {row.rate} "
                  f"share={row.share:.3f} bound_ms={row.bound_ms:.4f} ({row.bound_by}) "
                  f"host_ms={row.host_ms:.4f}{lib}")
    cold = " cold" if row.cold else ""
    return f"[probe] {row.probe} {row.variant:20s} {row.kernel}({row.config}){cold}: {timing}"


def normal(rng: np.random.Generator, shape, scale: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """Seeded normal values made on the host in f32, then cast on the device."""
    a = rng.standard_normal(size=shape, dtype=np.float32)
    if scale != 1.0:
        a *= np.float32(scale)
    return torch.from_numpy(a).to(device).to(dtype).contiguous()


PROBES = ("copy", "gelu", "mlp")


def run(which: str = "all", device: str | torch.device = "cuda", batch: int = 32,
        report=print) -> dict[str, list[Row]]:
    """Run the probes named by ``which`` ("copy", "gelu", "mlp" or "all") at
    batch ``batch`` (the scripts' 32) and return their rows by probe. On the
    card each row is timed; ``device="cpu"`` runs the plain versions and
    times nothing. No card and ``device="cuda"``: raises."""
    from spine_vision_torch.device import resolve_device
    from spine_vision_torch.probes import ablate_mlp, copy_bw, gelu_cost

    dev = resolve_device(device)
    modules = {"copy": copy_bw, "gelu": gelu_cost, "mlp": ablate_mlp}
    names = PROBES if which == "all" else (which,)
    if any(n not in modules for n in names):
        raise ValueError(f"unknown probe {which!r}; one of {PROBES + ('all',)}")
    if dev.type == "cuda":
        report(f"[probe] card: {torch.cuda.get_device_name(dev)}, batch {batch}")
        warm_up(dev)
    return {n: modules[n].run(dev, batch=batch, report=report) for n in names}
