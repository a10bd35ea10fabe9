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
   The training kernels too, at the train step's shapes (32 images): the
   block kernel's ``emit_conv`` form and the LN+MLP backward.
4. The inference slice: ConvNeXt-base localization at 512^2 and ResNet-18
   grading at 256^2 in bf16, weights from seeded numpy Flax-layout trees
   carried by ``load_flax_variables``; ``StudyInferencePipeline.run`` on 8
   studies of 640x640 slices (padded to 768^2) in both crop modes and on a
   3-study request (bucketed to 4). It checks the kernels' launch counts per
   forward, the outputs' ranges and shapes, and one study against the same
   entry point on the CPU.
5. The training slice: ``LocalizationTrainer.train()`` for 2 epochs of
   ConvNeXt-base at 512^2, batch 32, bf16 on f32 master weights, the hybrid
   block, augmentation and dropout on, over an in-memory seeded set of 96
   train and 32 val images. It checks the run dir, a finite history and the
   kernels' launch counts in every train step, and prints the step's p50;
   then one step's gradients on the card against the CPU (batch 2, 128^2),
   and an overfit run on one fixed batch.

It prints a ``kernels`` JSON line and the card's name and power limit before
its last line, ``{"ok": true, "device": {...}}``. Needs a CUDA device and the
rest of the repository; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
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
TRAIN_BATCH = 32  # the localization trainer's batch at 512^2
# The LN+MLP backward: the same rounding points as its plain version, but a
# value on a rounding boundary can round apart and the weight gradients sum
# 32K-512K such products in another order: 2e-2 * max |plain| per output.
BWD_REL_TOL = 2e-2
RUN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_runs"
INFERENCE_LAUNCHES = {"convnext_block": 33, "convnext_block_emit_conv": 0, "dw_ln": 3,
                      "ln_mlp_bwd": 0}
# Card against CPU, one step's gradients at bf16: each parameter's relative
# error (norm of the difference over the norm) stays under 2e-2, five bf16
# rounding steps (2^-8) of relative error; the first card run read 7.9e-3.
GRAD_REL_TOL = 2e-2
# Overfit one batch of 8 shaded 512^2 images. Predicting the batch's mean
# coordinates brings the loss to about 0.6 of its first value (an earlier run
# on unshaded images, whose pooled bf16 features barely differ, stalled at
# 0.625 with lr 3e-4); below 0.5 the model must fit each image.
OVERFIT_STEPS = 60
OVERFIT_LR = 1e-4
OVERFIT_FRACTION = 0.5


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


def train_kernel_phase(device, report: dict) -> None:
    """The hybrid training block's kernels at the train step's shapes: the
    block kernel's emit_conv form and the LN+MLP backward, each against its
    plain version, timed beside the plain version, a PyTorch yardstick and
    the bound. Rows go into ``report``."""
    import torch
    import torch.nn.functional as F

    from spine_vision_torch.ops import convnext_block as cb
    from spine_vision_torch.ops import fused_mlp as fm

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(1)
    emit_rows, bwd_rows = [], []
    for hw, c, count in BLOCK_SHAPES:
        m = TRAIN_BATCH * hw * hw
        x = _rand(gen, (TRAIN_BATCH, hw, hw, c), 1.0, device, bf16)
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
        # 1. The block kernel's emit_conv form: out and t.
        saved = cb.convnext_block.launches, cb.convnext_block.emit_launches
        out, t = cb.convnext_block(*args, emit_conv=True)
        want_out, want_t = cb.block_reference(*args, emit_conv=True)
        torch.cuda.synchronize()
        err_out = (out.float() - want_out.float()).abs().max().item()
        err_t = (t.float() - want_t.float()).abs().max().item()
        s_out = want_out.float().abs().max().item()
        s_t = want_t.float().abs().max().item()
        ok = err_out <= KERNEL_REL_TOL * s_out and err_t <= KERNEL_REL_TOL * s_t
        print(f"[kernel] convnext_block emit_conv B={TRAIN_BATCH} {hw}x{hw} C={c}: "
              f"out max_abs_err={err_out:.4g} (tol {KERNEL_REL_TOL * s_out:.4g}), "
              f"t max_abs_err={err_t:.4g} (tol {KERNEL_REL_TOL * s_t:.4g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"convnext_block emit_conv disagrees with its plain version at C={c}")
        del want_out, want_t
        k_oihw = args[1].t().reshape(c, 1, 7, 7).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)

        def library_fwd():
            tt = F.conv2d(x_nchw, k_oihw, args[2].to(bf16), padding=3, groups=c).permute(0, 2, 3, 1)
            y = F.layer_norm(tt, (c,), args[3].to(bf16), args[4].to(bf16), 1e-6)
            h = F.gelu(F.linear(y, args[5], args[6].to(bf16)), approximate="tanh")
            return F.linear(h, args[7], args[8].to(bf16)) * args[9].to(bf16) + x, tt

        ms = _time_ms(lambda: cb.convnext_block(*args, emit_conv=True))
        cb.convnext_block.launches, cb.convnext_block.emit_launches = saved
        plain_ms = _time_ms(lambda: cb.block_reference(*args, emit_conv=True), iters=3, warmup=1)
        library_ms = _time_ms(library_fwd)
        nbytes = 3 * m * c * 2 + 2 * 4 * c * c * 2 + 49 * c * 2 + (4 * c + 6 * c) * 4
        bound, by = _bound_ms(nbytes, 2 * 2 * m * c * 4 * c, 2 * 49 * m * c)
        print(f"[kernel] convnext_block emit_conv C={c}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound:.4f} ({by}) "
              f"roofline_share={bound / ms:.3f} per_train_step={count}")
        emit_rows.append((count, max(err_out, err_t), ms, plain_ms, bound, by, library_ms))

        # 2. The LN+MLP backward from t and an output gradient g.
        g = _rand(gen, (TRAIN_BATCH, hw, hw, c), 1.0, device, bf16)
        bargs = (t, args[3], args[4], args[5], args[6], args[7], args[8], args[9], g)
        saved = fm.ln_mlp_bwd.launches
        got = fm.ln_mlp_bwd(*bargs)
        want = fm.ln_mlp_bwd_reference(*bargs)
        torch.cuda.synchronize()
        errs = []
        names = ("dt", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma")
        for name, a, b in zip(names, got, want):
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            errs.append(err)
            if not err <= BWD_REL_TOL * scale:
                raise AssertionError(
                    f"ln_mlp_bwd {name} disagrees with its plain version at C={c}: "
                    f"{err:.4g} > {BWD_REL_TOL} * {scale:.4g}")
        print(f"[kernel] ln_mlp_bwd B={TRAIN_BATCH} {hw}x{hw} C={c}: max_abs_err "
              + " ".join(f"{n}={e:.3g}" for n, e in zip(names, errs))
              + f" (tol {BWD_REL_TOL}*max|plain| each) ok")
        del got, want
        leaves = [a.detach().clone().to(bf16).requires_grad_(True)
                  for a in (args[3], args[4], args[5], args[6], args[7], args[8], args[9])]
        t_leaf = t.detach().clone().requires_grad_(True)

        def library_bwd():
            ls, lb, w1t, b1, w2t, b2, gamma = leaves
            y = F.layer_norm(t_leaf, (c,), ls, lb, 1e-6)
            h = F.gelu(F.linear(y, w1t, b1), approximate="tanh")
            o = F.linear(h, w2t, b2) * gamma
            return torch.autograd.grad(o, [t_leaf, *leaves], g)

        ms = _time_ms(lambda: fm.ln_mlp_bwd(*bargs))
        fm.ln_mlp_bwd.launches = saved
        plain_ms = _time_ms(lambda: fm.ln_mlp_bwd_reference(*bargs), iters=3, warmup=1)
        library_ms = _time_ms(library_bwd)
        nbytes = 3 * m * c * 2 + 2 * 4 * c * c * 2 + 2 * 4 * c * c * 4 + 10 * c * 4 + 4 * c * 8
        bound, by = _bound_ms(nbytes, 5 * 2 * m * c * 4 * c, 15 * m * 4 * c + 20 * m * c)
        print(f"[kernel] ln_mlp_bwd C={c}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound:.4f} ({by}) "
              f"roofline_share={bound / ms:.3f} per_train_step={count}")
        bwd_rows.append((count, max(errs), ms, plain_ms, bound, by, library_ms))
        del t, g, bargs, leaves, t_leaf, out
        torch.cuda.empty_cache()
    report["convnext_block_emit_conv"] = emit_rows
    report["ln_mlp_bwd"] = bwd_rows


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
        _zero_counts()
        results = pipe.run(studies, fetch_crops=False)
        counts = _counts()
        print(f"[slice] {mode}: launches in one run {counts}")
        if counts != INFERENCE_LAUNCHES:
            raise AssertionError(f"expected {INFERENCE_LAUNCHES} launches per forward, got {counts}")
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
    _zero_counts()
    results = pipe.run(_studies(3, 1))
    _check_results(results, 3, tasks)
    assert results[0].crops.shape == (2, 5, 256, 256) and results[0].crops.dtype == np.uint8
    counts = _counts()
    if counts != INFERENCE_LAUNCHES:
        raise AssertionError(f"3-study request: expected {INFERENCE_LAUNCHES}, got {counts}")
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


class _Images:
    """In-memory localization samples from a seed: uint8 images with a bright
    disc at each of the five level coordinates, coords and masks. With
    ``shade``, image i is also brightened by 20 * i, so that the images
    differ in their pooled features too."""

    def __init__(self, n: int, hw: int, seed: int, shade: bool = False) -> None:
        import numpy as np

        rng = np.random.default_rng(seed)
        self.coords = rng.uniform(0.2, 0.8, (n, 5, 2)).astype(np.float32)
        self.mask = (rng.uniform(size=(n, 5)) > 0.1).astype(np.float32)
        self.images = rng.integers(0, 96, (n, hw, hw, 3), dtype=np.uint8)
        yy, xx = np.mgrid[0:hw, 0:hw]
        for i in range(n):
            for x, y in self.coords[i]:
                disc = (yy - y * hw) ** 2 + (xx - x * hw) ** 2 < (hw / 40) ** 2
                self.images[i][disc] = 255
            if shade:
                self.images[i] = np.minimum(self.images[i].astype(np.int32) + 20 * i, 255)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> dict:
        return {"image": self.images[i], "coords": self.coords[i], "mask": self.mask[i],
                "series_type_idx": 0, "metadata": {"image_path": f"synthetic/{i}.png"}}


def _regressor(device, seed: int, dropout: float):
    """ConvNeXt-base CoordinateRegressor for training (bf16 on f32 masters,
    the hybrid block), weights from a seeded Flax-layout tree."""
    import torch

    from spine_vision_torch.models.classifier import CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables

    model = CoordinateRegressor("convnext_base", dtype=torch.bfloat16, device=device,
                                dropout=dropout, use_pallas="hybrid", param_dtype=torch.float32)
    params, _ = random_flax_variables(model, seed)
    return load_flax_variables(model, params)


def _counts() -> dict:
    from spine_vision_torch.ops import convnext_block as cb
    from spine_vision_torch.ops import dwconv as dw
    from spine_vision_torch.ops import fused_mlp as fm

    return {"convnext_block": cb.convnext_block.launches,
            "convnext_block_emit_conv": cb.convnext_block.emit_launches,
            "dw_ln": dw.dw_ln.launches, "ln_mlp_bwd": fm.ln_mlp_bwd.launches}


def _zero_counts() -> None:
    from spine_vision_torch.ops import convnext_block as cb
    from spine_vision_torch.ops import dwconv as dw
    from spine_vision_torch.ops import fused_mlp as fm

    cb.convnext_block.launches = cb.convnext_block.emit_launches = 0
    dw.dw_ln.launches = fm.ln_mlp_bwd.launches = 0


def train_phase(device, card: str, profile: bool = False) -> dict:
    """LocalizationTrainer.train() at full width; return the launch counts of
    one train step."""
    import math

    import numpy as np
    import torch

    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    t0 = time.perf_counter()
    model = _regressor(device, seed=0, dropout=0.2)
    train_set, val_set = _Images(96, 512, 10), _Images(32, 512, 11)
    print(f"[train] model and data built in {time.perf_counter() - t0:.1f} s")
    run = RUN_DIR / "train"
    shutil.rmtree(run, ignore_errors=True)
    cfg = LocalizationConfig(
        backbone="convnext_base", image_size=(512, 512), batch_size=TRAIN_BATCH, num_epochs=2,
        augment=True, dropout=0.2, mixed_precision=True, output_path=run, num_workers=8,
        pretrained=False, profile_steps=True, seed=0,
    )
    trainer = LocalizationTrainer(cfg, model=model, train_dataset=train_set,
                                  val_dataset=val_set, device=device)
    step_counts = []
    inner = trainer.train_step_fn

    def counted_step(state, batch):
        _zero_counts()
        loss = inner(state, batch)
        step_counts.append(_counts())
        return loss

    trainer.train_step_fn = counted_step
    t0 = time.perf_counter()
    result = trainer.train()
    wall = time.perf_counter() - t0
    want = {"convnext_block": 33, "convnext_block_emit_conv": 33, "dw_ln": 0, "ln_mlp_bwd": 33}
    print(f"[train] {len(step_counts)} train steps, 2 epochs in {wall:.1f} s; launches in "
          f"the first step {step_counts[0]}")
    if len(step_counts) != 6:
        raise AssertionError(f"expected 6 train steps (2 epochs of 96 / 32), got {len(step_counts)}")
    for i, counts in enumerate(step_counts):
        if counts != want:
            raise AssertionError(f"train step {i}: launches {counts}, expected {want}")
    for name in ("best_model/state.pt", "best_model.meta.json", "config.yaml", "logs"):
        if not (run / name).exists():
            raise AssertionError(f"run dir lacks {name}")
    for key in ("train_loss", "val_loss", "lr", "med"):
        values = result.history[key]
        if len(values) != 2 or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"history[{key!r}] = {values}")
    print(f"[train] history: train_loss {result.history['train_loss']}, val_loss "
          f"{result.history['val_loss']}, med {result.history['med']}, lr {result.history['lr']}")
    steps = trainer.step_times[1:]  # the first step allocates and tunes
    p50 = float(np.percentile(steps, 50)) * 1e3
    print(f"[train] train step p50 {p50:.3f} ms = {TRAIN_BATCH / p50 * 1e3:.2f} img/s "
          f"(ConvNeXt-base 512^2 b{TRAIN_BATCH} bf16; upload, augmentation and the optimizer "
          f"included, the loader's prefetch not; {len(steps)} steps after the first; steps ms "
          f"{[round(t * 1e3, 3) for t in trainer.step_times]}) on {card}")
    print(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_train(trainer, train_set, p50)
    shutil.rmtree(run, ignore_errors=True)
    return {"launches": step_counts[0], "p50_ms": p50}


def profile_train(trainer, dataset, p50_ms: float) -> None:
    """Two traced train steps: device time by kernel and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spine_vision_torch.data.loader import collate_localization

    batch = collate_localization([dataset[i] for i in range(TRAIN_BATCH)])
    trainer.train_step_fn(trainer.state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(2):
            trainer.train_step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / 2
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_ms = sum(dev(e) for e in events) / 1e3 / 2
    print(f"[profile] train step: traced wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}); against the untraced p50 {p50_ms:.3f} ms the idle "
          f"share is {1 - busy_ms / p50_ms:.1%}")
    for e in sorted(events, key=dev, reverse=True)[:16]:
        print(f"[profile] train step: {dev(e) / 1e3 / 2:9.3f} ms/step x{e.count // 2:<5d} "
              f"{e.key[:90]}")


def grad_check(device) -> None:
    """One step's gradients, card against CPU: ConvNeXt-base at full width,
    batch 2 at 128^2 (stages 32^2 .. 4^2 reach all four widths), augmentation
    and dropout off, the same weights and batch, the same entry point."""
    import numpy as np
    import torch

    from spine_vision_torch.data.loader import collate_localization
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    batch = collate_localization([_Images(2, 128, 12)[i] for i in range(2)])
    grads = {}
    for dev in (device, torch.device("cpu")):
        run = RUN_DIR / f"grad_{dev.type}"
        shutil.rmtree(run, ignore_errors=True)
        cfg = LocalizationConfig(
            backbone="convnext_base", image_size=(128, 128), batch_size=2, num_epochs=1,
            augment=False, dropout=0.0, output_path=run, num_workers=1, pretrained=False,
            grad_clip=None, seed=0,
        )
        trainer = LocalizationTrainer(cfg, model=_regressor(dev, seed=3, dropout=0.0),
                                      train_dataset=_Images(2, 128, 12),
                                      val_dataset=_Images(2, 128, 13), device=dev)
        t0 = time.perf_counter()
        loss = float(trainer.train_step_fn(trainer.state, batch))
        grads[dev.type] = ({n: p.grad.detach().float().cpu() for n, p in
                            trainer.model.named_parameters()}, loss, time.perf_counter() - t0)
        shutil.rmtree(run, ignore_errors=True)
    card, cpu = grads["cuda"][0], grads["cpu"][0]
    rel = {n: (torch.linalg.vector_norm(card[n] - cpu[n]) /
               torch.linalg.vector_norm(cpu[n]).clamp_min(1e-30)).item() for n in cpu}
    worst = sorted(rel.items(), key=lambda kv: kv[1], reverse=True)[:4]
    tol = GRAD_REL_TOL
    print(f"[grad] card vs CPU, one step of {len(rel)} parameters (CPU step "
          f"{grads['cpu'][2]:.1f} s): loss {grads['cuda'][1]:.6f} vs {grads['cpu'][1]:.6f}; "
          f"per-parameter ||g_card - g_cpu|| / ||g_cpu||: median {np.median(list(rel.values())):.4g}, "
          f"max {worst[0][1]:.4g} ({worst[0][0]}), tol {tol}")
    print(f"[grad] largest: {[(n, round(v, 5)) for n, v in worst]}")
    if worst[0][1] > tol:
        raise AssertionError(f"card and CPU gradients differ beyond {tol}: {worst}")


def overfit_check(device) -> None:
    """Steps on one fixed batch, augmentation and dropout off: the loss must
    fall below OVERFIT_FRACTION of its first value."""
    import torch

    from spine_vision_torch.data.loader import collate_localization
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    data = _Images(8, 512, 14, shade=True)
    batch = collate_localization([data[i] for i in range(8)])
    run = RUN_DIR / "overfit"
    shutil.rmtree(run, ignore_errors=True)
    cfg = LocalizationConfig(
        backbone="convnext_base", image_size=(512, 512), batch_size=8, num_epochs=1,
        augment=False, dropout=0.0, learning_rate=OVERFIT_LR, scheduler_type="none",
        output_path=run, num_workers=1, pretrained=False, seed=0,
    )
    trainer = LocalizationTrainer(cfg, model=_regressor(device, seed=4, dropout=0.0),
                                  train_dataset=data, val_dataset=data, device=device)
    losses = [float(trainer.train_step_fn(trainer.state, batch)) for _ in range(OVERFIT_STEPS)]
    shutil.rmtree(run, ignore_errors=True)
    print(f"[overfit] {OVERFIT_STEPS} steps at lr {OVERFIT_LR} on one batch of 8: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} ({losses[-1] / losses[0]:.3f} of the first; "
          f"must be < {OVERFIT_FRACTION}); every 5th: {[round(v, 6) for v in losses[::5]]}")
    if not all(torch.isfinite(torch.tensor(losses))) or losses[-1] >= OVERFIT_FRACTION * losses[0]:
        raise AssertionError("the loss did not fall on a fixed batch")


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
    train_kernel_phase(device, report)
    paths = {"study_inference": None, "train_step": None}
    if not opts.kernels_only:
        paths["study_inference"] = slice_phase(device, card, opts.profile)["launches"]
        paths["train_step"] = train_phase(device, card, opts.profile)["launches"]
        grad_check(device)
        overfit_check(device)

    sources = {
        "convnext_block": ("spine_vision_torch/csrc/convnext_block.cu",
                           "spine_vision_tpu/ops/convnext_block.py:194", "study_inference"),
        "dw_ln": ("spine_vision_torch/csrc/dwconv_ln.cu", "spine_vision_tpu/ops/dwconv.py:495",
                  "study_inference"),
        "convnext_block_emit_conv": ("spine_vision_torch/csrc/convnext_block.cu",
                                     "spine_vision_tpu/ops/convnext_block.py:194", "train_step"),
        "ln_mlp_bwd": ("spine_vision_torch/csrc/ln_mlp_bwd.cu",
                       "spine_vision_tpu/ops/fused_mlp.py:930 and :1050", "train_step"),
    }
    kernels = []
    for name, rows in report.items():
        # Per-path totals: each shape's time times its launches on the path.
        total = lambda i: sum(r[0] * r[i] for r in rows)  # noqa: E731
        source, replaces, path = sources[name]
        by_path = {p: (c or {}).get(name) for p, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": path, "launches": by_path[path], "launches_by_path": by_path,
            "max_abs_err": max(r[1] for r in rows), "ms": total(2), "plain_ms": total(3),
            "bound_ms": total(4), "bound_by": max(rows, key=lambda r: r[0] * r[4])[5],
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
