#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``spine_vision_torch``) on one GPU.

    python3 chip_smoke.py              # every phase, as a check of a checkout
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --profile    # adds a torch.profiler breakdown

Phases, each of which raises (and so exits non-zero) on any fault:

1. Versions, the card's name and power limit; TF32 off for matmul and cuDNN.
2. Build every CUDA kernel from ``spine_vision_torch/csrc`` with nvcc.
3. Kernels: at each shape the study graph gives them (16 images, bf16), each
   kernel against its plain PyTorch version (stated tolerance), and the
   kernel, the plain version and a PyTorch yardstick timed with CUDA events
   beside the card's bound for the same work.
4. The slice: ConvNeXt-base localization at 512^2 and ResNet-18 grading at
   256^2 in bf16, weights from seeded numpy Flax-layout trees carried by
   ``load_flax_variables``; ``StudyInferencePipeline.run`` on 8 studies of
   640x640 slices (padded to 768^2) in both crop modes and on a 3-study
   request (bucketed to 4). It checks the kernels' launch counts per forward,
   the outputs' ranges and shapes, and one study against the same entry
   point on the CPU.

It prints a ``kernels`` JSON line and the card's name and power limit before
its last line, ``{"ok": true, "device": {...}}``. Needs a CUDA device and the
rest of the repository; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16 peak
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES_S = 3.35e12  # HBM3

BLOCK_SHAPES = ((128, 128, 3), (64, 256, 3), (32, 512, 27))  # (H=W, C, blocks)
DW_LN_SHAPES = ((16, 1024, 3),)
BATCH = 16  # 8 studies x (T1, T2)
KERNEL_REL_TOL = 1e-2  # max |kernel - plain| <= 1e-2 * max |plain| (~2.5 bf16 steps)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, tensor_flops: float, f32_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_S * 1e3
    t_ops = max(tensor_flops / H100_BF16_FLOPS, f32_flops / H100_F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rand(gen, shape, scale, device, dtype, shift=0.0):
    import torch

    t = torch.randn(shape, generator=gen, device=device) * scale + shift
    return t.to(dtype).contiguous()


def kernel_phase(device) -> dict:
    """Check and time each kernel at its main-path shapes."""
    import torch
    import torch.nn.functional as F

    from spine_vision_torch.ops import convnext_block as cb
    from spine_vision_torch.ops import dwconv as dw

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    report = {}

    # Kernel 1: whole ConvNeXt block. LayerScale ~1 so the MLP is checked.
    rows = []
    for hw, c, count in BLOCK_SHAPES:
        x = _rand(gen, (BATCH, hw, hw, c), 1.0, device, bf16)
        args = (
            x,
            _rand(gen, (49, c), 0.1, device, bf16),
            _rand(gen, (c,), 0.1, device, f32),
            _rand(gen, (c,), 0.1, device, f32, 1.0),
            _rand(gen, (c,), 0.1, device, f32),
            _rand(gen, (4 * c, c), c ** -0.5, device, bf16),
            _rand(gen, (4 * c,), 0.1, device, f32),
            _rand(gen, (c, 4 * c), (4 * c) ** -0.5, device, bf16),
            _rand(gen, (c,), 0.1, device, f32),
            _rand(gen, (c,), 0.1, device, f32, 1.0),
        )
        got = cb.convnext_block(*args)
        want = cb.block_reference(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = err <= KERNEL_REL_TOL * scale
        print(f"[kernel] convnext_block B={BATCH} {hw}x{hw} C={c}: max_abs_err={err:.4g} "
              f"max_rel_err={err / scale:.4g} tol={KERNEL_REL_TOL}*max|plain|={KERNEL_REL_TOL * scale:.4g}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"convnext_block disagrees with its plain version at C={c}")

        k_oihw = args[1].t().reshape(c, 1, 7, 7).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view

        def library():
            t = F.conv2d(x_nchw, k_oihw, args[2].to(bf16), padding=3, groups=c)
            t = F.layer_norm(t.permute(0, 2, 3, 1), (c,), args[3].to(bf16), args[4].to(bf16), 1e-6)
            h = F.gelu(F.linear(t, args[5], args[6].to(bf16)), approximate="tanh")
            return F.linear(h, args[7], args[8].to(bf16)) * args[9].to(bf16) + x

        saved = cb.convnext_block.launches
        ms = _time_ms(lambda: cb.convnext_block(*args))
        cb.convnext_block.launches = saved  # timing launches are not the main path's
        plain_ms = _time_ms(lambda: cb.block_reference(*args), iters=5)
        library_ms = _time_ms(library)
        m = BATCH * hw * hw
        nbytes = 2 * m * c * 2 + 2 * 4 * c * c * 2 + 49 * c * 2 + (4 * c + 6 * c) * 4
        bound, by = _bound_ms(nbytes, 2 * 2 * m * c * 4 * c, 2 * 49 * m * c)
        print(f"[kernel] convnext_block C={c}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound:.4f} ({by}) "
              f"roofline_share={bound / ms:.3f} per_forward={count}")
        rows.append((count, err, ms, plain_ms, bound, by, library_ms))
    report["convnext_block"] = rows

    # Kernel 2: dwconv + LayerNorm at C = 1024.
    rows = []
    for hw, c, count in DW_LN_SHAPES:
        x = _rand(gen, (BATCH, hw, hw, c), 1.0, device, bf16)
        args = (
            x,
            _rand(gen, (49, c), 0.1, device, bf16),
            _rand(gen, (c,), 0.1, device, f32),
            _rand(gen, (c,), 0.1, device, f32, 1.0),
            _rand(gen, (c,), 0.1, device, f32),
        )
        got = dw.dw_ln(*args)
        want = dw.dw_ln_reference(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = err <= KERNEL_REL_TOL * scale
        print(f"[kernel] dw_ln B={BATCH} {hw}x{hw} C={c}: max_abs_err={err:.4g} "
              f"max_rel_err={err / scale:.4g} tol={KERNEL_REL_TOL}*max|plain|={KERNEL_REL_TOL * scale:.4g}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dw_ln disagrees with its plain version at C={c}")
        # f32 inputs too (the kernel is templated on the data type).
        args32 = (x.float(), args[1].float(), *args[2:])
        err32 = (dw.dw_ln(*args32) - dw.dw_ln_reference(*args32)).abs().max().item()
        print(f"[kernel] dw_ln f32 C={c}: max_abs_err={err32:.4g} tol=1e-4")
        if not err32 <= 1e-4:
            raise AssertionError("dw_ln (f32) disagrees with its plain version")

        k_oihw = args[1].t().reshape(c, 1, 7, 7).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)

        def library():
            t = F.conv2d(x_nchw, k_oihw, args[2].to(bf16), padding=3, groups=c)
            return F.layer_norm(t.permute(0, 2, 3, 1), (c,), args[3].to(bf16), args[4].to(bf16), 1e-6)

        saved = dw.dw_ln.launches
        ms = _time_ms(lambda: dw.dw_ln(*args))
        dw.dw_ln.launches = saved
        plain_ms = _time_ms(lambda: dw.dw_ln_reference(*args), iters=5)
        library_ms = _time_ms(library)
        m = BATCH * hw * hw
        nbytes = 2 * m * c * 2 + 49 * c * 2 + 3 * c * 4
        bound, by = _bound_ms(nbytes, 0, 2 * 49 * m * c + 8 * m * c)
        print(f"[kernel] dw_ln C={c}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound:.4f} ({by}) "
              f"roofline_share={bound / ms:.3f} per_forward={count}")
        rows.append((count, err, ms, plain_ms, bound, by, library_ms))
    report["dw_ln"] = rows
    return report


def _studies(n: int, seed: int):
    import numpy as np

    from spine_vision_torch.infer.pipeline import StudyInput

    rng = np.random.default_rng(seed)
    return [
        StudyInput(
            t1_slice=rng.normal(100, 30, (640, 640)).astype(np.float32),
            t2_slice=rng.normal(90, 25, (640, 640)).astype(np.float32),
            t1_spacing=(0.3, 0.3), t2_spacing=(0.3, 0.3), study_id=f"s{i}",
        )
        for i in range(n)
    ]


def _check_results(results, n: int, tasks) -> None:
    import numpy as np

    assert len(results) == n, (len(results), n)
    for r in results:
        assert r.coords.shape == (2, 5, 2) and np.all(np.isfinite(r.coords))
        assert np.all(r.coords >= 0) and np.all(r.coords <= 1), "coords outside [0, 1]"
        assert r.angles.shape == (2, 5) and np.all(np.isfinite(r.angles))
        for t in tasks:
            logit = r.logits[t.name]
            assert logit.shape == (5, t.num_classes) and np.all(np.isfinite(logit))
            assert r.predictions[t.name].shape == (5,), (t.name, r.predictions[t.name].shape)
            assert r.probabilities[t.name].shape == (5, t.num_classes)


def profile_run(pipe, studies, mode: str) -> float:
    """One traced run: device time by op and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        pipe.run(studies, fetch_crops=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    # Device-side events only (kernels, copies): operator rows would count
    # their kernels a second time.
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_us = sum(dev(e) for e in events)
    print(f"[profile] {mode}: traced wall {wall_us / 1e3:.3f} ms for {len(studies)} studies, "
          f"device busy {busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%} of the traced wall)")
    for e in sorted(events, key=dev, reverse=True)[:12]:
        print(f"[profile] {mode}: {dev(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return busy_us / 1e3


def slice_phase(device, card: str, profile: bool = False) -> dict:
    """Drive StudyInferencePipeline.run at full width; return launch counts."""
    import numpy as np
    import torch

    from spine_vision_torch.core.tasks import get_tasks
    from spine_vision_torch.infer.pipeline import StudyInferencePipeline, StudyPipelineConfig
    from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
    from spine_vision_torch.ops import convnext_block as cb
    from spine_vision_torch.ops import dwconv as dw

    t0 = time.perf_counter()
    loc = CoordinateRegressor("convnext_base", dtype=torch.bfloat16, device=device)
    cls = Classifier("resnet18", dtype=torch.bfloat16, device=device)
    for model, seed in ((loc, 0), (cls, 1)):
        params, stats = random_flax_variables(model, seed)
        load_flax_variables(model, params, stats)
    print(f"[slice] models built and loaded in {time.perf_counter() - t0:.1f} s")
    tasks = get_tasks()
    studies = _studies(8, 0)
    launches = {}
    per_mode = {}
    for mode in ("horizontal", "rotated"):
        cfg = StudyPipelineConfig(padded_hw=(768, 768), crop_mode=mode)
        pipe = StudyInferencePipeline(loc, cls, config=cfg, device=device)
        _check_results(pipe.run(studies), 8, tasks)  # warm
        cb.convnext_block.launches = 0
        dw.dw_ln.launches = 0
        results = pipe.run(studies, fetch_crops=False)
        counts = {"convnext_block": cb.convnext_block.launches, "dw_ln": dw.dw_ln.launches}
        print(f"[slice] {mode}: launches in one run {counts}")
        if counts != {"convnext_block": 33, "dw_ln": 3}:
            raise AssertionError(f"expected 33 and 3 launches per forward, got {counts}")
        _check_results(results, 8, tasks)
        if mode == "horizontal":
            launches = counts
        lat = []
        for _ in range(10):
            torch.cuda.synchronize()
            start = time.perf_counter()
            pipe.run(studies, fetch_crops=False)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - start) * 1e3 / len(studies))
        p50 = float(np.percentile(lat, 50))
        per_mode[mode] = p50
        print(f"[slice] {mode}: per-study p50 {p50:.3f} ms (8 studies/run, 10 runs, "
              f"host pack + transfers included) on {card}")
        if profile:
            busy = profile_run(pipe, studies, mode)
            batch = p50 * len(studies)
            print(f"[profile] {mode}: device busy {busy:.3f} ms of the untraced p50 batch "
                  f"{batch:.3f} ms: idle share {1 - busy / batch:.1%}")

    # A 3-study request buckets to 4.
    pipe = StudyInferencePipeline(
        loc, cls, config=StudyPipelineConfig(padded_hw=(768, 768)), device=device
    )
    cb.convnext_block.launches = 0
    dw.dw_ln.launches = 0
    results = pipe.run(_studies(3, 1))
    _check_results(results, 3, tasks)
    assert results[0].crops.shape == (2, 5, 256, 256) and results[0].crops.dtype == np.uint8
    counts = {"convnext_block": cb.convnext_block.launches, "dw_ln": dw.dw_ln.launches}
    if counts != {"convnext_block": 33, "dw_ln": 3}:
        raise AssertionError(f"3-study request: expected 33 and 3 launches, got {counts}")
    print(f"[slice] 3-study request: ok, launches {counts}")

    # One study through the same entry point on the CPU (plain versions).
    one = _studies(1, 2)
    gpu = pipe.run(one)[0]
    cpu_pipe = StudyInferencePipeline(
        copy.deepcopy(loc), copy.deepcopy(cls),
        config=StudyPipelineConfig(padded_hw=(768, 768)), device="cpu",
    )
    t0 = time.perf_counter()
    cpu = cpu_pipe.run(one)[0]
    coord_err = float(np.abs(gpu.coords - cpu.coords).max())
    logit_err = max(float(np.abs(gpu.logits[k] - cpu.logits[k]).max()) for k in gpu.logits)
    logit_scale = max(float(np.abs(cpu.logits[k]).max()) for k in cpu.logits)
    crop_share = float(np.mean(np.abs(gpu.crops.astype(int) - cpu.crops.astype(int)) > 1))
    print(f"[slice] card vs CPU ({time.perf_counter() - t0:.1f} s on the CPU): "
          f"coords max_abs_err={coord_err:.4g} (tol 2e-2), logits max_abs_err={logit_err:.4g} "
          f"(tol 0.1 + 0.05*max|cpu|={0.1 + 0.05 * logit_scale:.4g}), "
          f"crop pixels off by >1 level: {crop_share:.4%}")
    if coord_err > 2e-2 or logit_err > 0.1 + 0.05 * logit_scale:
        raise AssertionError("the card and the CPU disagree beyond the bf16 tolerance")
    _check_crops_on_card(device, gpu.coords)
    return {"launches": launches, "p50": per_mode}


def _check_crops_on_card(device, coords) -> None:
    """The crop stage alone, card against CPU, on the same centres.

    The whole-graph comparison above feeds each device its own bf16 centres,
    and a centre a fraction of a pixel apart shifts a whole crop; here both
    devices crop from the same centres, at the bench shape, in both modes."""
    import numpy as np
    import torch

    from spine_vision_torch.ops.crop import crop_ivd_regions
    from spine_vision_torch.ops.geometry import mm_to_pixels, rotation_angles

    rng = np.random.default_rng(3)
    images = np.zeros((2, 768, 768), np.float32)
    images[:, :640, :640] = rng.uniform(0, 255, (2, 640, 640))
    hw = torch.tensor([[640, 640], [640, 640]], dtype=torch.int32)
    centers = torch.from_numpy(np.ascontiguousarray(coords, dtype=np.float32))
    deltas = mm_to_pixels(torch.tensor([55.0, 15.0, 17.5, 20.0]), torch.full((2, 2), 0.3))
    for separable in (True, False):
        angles = (torch.zeros((2, 5)) if separable else rotation_angles(centers, hw))
        args = (torch.from_numpy(images), centers, angles, deltas, hw)
        cpu = crop_ivd_regions(*args, separable=separable).numpy()
        gpu = crop_ivd_regions(*(a.to(device) for a in args), separable=separable).cpu().numpy()
        diff = np.abs(cpu.astype(int) - gpu.astype(int))
        share = float(np.mean(diff > 0))
        mode = "horizontal" if separable else "rotated"
        print(f"[slice] crop {mode}, card vs CPU on the same centres: max level diff "
              f"{diff.max()}, share of pixels off {share:.4%} (tol: <= 1 level on <= 1%)")
        if diff.max() > 1 or share > 0.01:
            raise AssertionError(f"{mode} crops differ between the card and the CPU")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels; skip the slice phase")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one run per crop mode with torch.profiler")
    opts = parser.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from spine_vision_torch.ops import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the spine_vision_torch package is missing ({exc})", file=sys.stderr)
        return 2

    card = _card()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"[env] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"[build] {len(cuda_build.SOURCES)} sources built in {time.perf_counter() - t0:.1f} s")
    for name, log in cuda_build.build_logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(line.split()[4]) for line in log.splitlines()
                     if "spill stores" in line)
        print(f"[build] {name}: {len(regs)} kernels, registers max {max(regs, default=0)}, "
              f"spill stores {spills} bytes")

    report = kernel_phase(device)
    launches = {"convnext_block": None, "dw_ln": None}
    if not opts.kernels_only:
        launches = slice_phase(device, card, opts.profile)["launches"]

    sources = {
        "convnext_block": ("spine_vision_torch/csrc/convnext_block.cu",
                           "spine_vision_tpu/ops/convnext_block.py:194"),
        "dw_ln": ("spine_vision_torch/csrc/dwconv_ln.cu", "spine_vision_tpu/ops/dwconv.py:495"),
    }
    kernels = []
    for name, rows in report.items():
        # Per-forward totals: each shape's time times its launches per forward.
        total = lambda i: sum(r[0] * r[i] for r in rows)  # noqa: E731
        bound = total(4)
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r[1] for r in rows), "ms": total(2), "plain_ms": total(3),
            "bound_ms": bound, "bound_by": max(rows, key=lambda r: r[0] * r[4])[5],
            "library_ms": total(6),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
