#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``spine_vision_torch``) on one GPU.

    python3 chip_smoke.py              # every phase, as a check of a checkout
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --profile    # adds a torch.profiler breakdown
    python3 chip_smoke.py --parity-only --parity-seeds 0 1 2 3   # the parity band
    python3 chip_smoke.py --ocr-only [--profile]   # report OCR alone
    python3 chip_smoke.py --ocr-train-only [--profile]   # OCR training and evaluation alone
    python3 chip_smoke.py --ocr-train-full   # train_ocr_stack at the JAX defaults
    python3 chip_smoke.py --io-only    # study inference from volume files alone
    python3 chip_smoke.py --serve-only [--profile]   # the directory server alone
    python3 chip_smoke.py --build-only # the dataset builders alone
    python3 chip_smoke.py --ddp-only   # data parallelism alone
    python3 chip_smoke.py --zoo-only   # the backbone zoo alone
    python3 chip_smoke.py --f32-only   # the f32 forms of #1 and #5-#10 and their paths
    python3 chip_smoke.py --cli-only   # the port's command line (and the JPEG decoder) alone
    python3 chip_smoke.py --codecs-only  # JPEG 2000 DICOM and progressive JPEG inputs alone
    python3 chip_smoke.py --pdf-only   # PDF reports: render, OCR, dataset phenikaa -> builder

Phases, each of which raises (and so exits non-zero) on any fault:

1. Versions, the card's name and power limit; TF32 off for matmul and cuDNN.
2. Build every CUDA kernel from ``spine_vision_torch/csrc`` with nvcc.
3. Kernels: at each shape the study graph gives them (16 images, bf16), each
   kernel against its plain PyTorch version (stated tolerance), and the
   kernel, the plain version and a PyTorch yardstick timed with CUDA events
   beside the card's bound for the same work.
   The training kernels too, at the train step's shapes (32 images): the
   block kernel's ``emit_conv`` form and the LN+MLP backward (the hybrid
   block), the MLP backward, the dwconv+LN backward and the plain depthwise
   stencil (the all-kernel block), the backward kernels also run twice to
   show that they agree bit for bit; the dwconv+LN forward #2 at every
   shape of the all-kernel train step too, in bf16 and f32. The MLP
   backward's stages (#6, #8/#9, #10, with #10's two ends, the conv
   recompute and the tap sums, each also alone beside its plain stage and a
   PyTorch call of the same function), the block forward's three launches
   (#1: the stencil+LayerNorm prologue P, the products F1 and F2), the row
   forms' (#7: the LayerNorm rows L, F1 and F2; #5: F1 and F2), the
   dwconv+LN backward's (#4: the statistics S, the tile T, the column sums),
   the stencil #3 and #2 are timed one by one from a profile, each beside
   its own bound, with the call's device time.
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
6. The same training run with ``use_pallas_dwconv=True``, the all-kernel
   block (``train_step_dwconv``), with its own launch counts, p50 and peak
   memory, and its own card-against-CPU gradient check.
7. The same again in the LN-fused MLP mode of ``use_pallas_mlp=True``
   (``train_step_mlp``: the LN+MLP forward #7 and backward #8/#9) and with a
   ``use_pallas="block"`` model handed to the trainer (``train_step_block``:
   the block kernel forward and the whole-block backward #10 with the stencil
   for dx), each with its launch counts, p50, peak memory and gradient check;
   then the gradient check of ConvNeXt-base without LayerScale in the "mlp"
   mode, whose blocks run the fused MLP (#5 forward, #6 backward).
   The kernel phases check and time #7, #5 (both forms) and #10 at the train
   step's shapes, #10 also bit for bit over two runs, and #5 again at the
   shapes of its path, that gradient check's.
8. The measurement probes (#11, ``spine_vision_torch/probes``), after the
   kernel phases and with ``--kernels-only`` too: their entry point
   (``probes.run("all")``, as ``python -m spine_vision_torch.probes all``)
   at the JAX scripts' shapes prints every table (ms, GB/s or TFLOP/s, share
   of the card's peak); then each probe kernel's every variant against its
   plain version (copies, the read-only token, the write-only broadcast and
   the GELU pass's copy bit for bit, the GELU bodies each element within one
   bf16 ulp, the MLP ablation within 2e-2 * max |plain|), with the plain
   version timed.
9. Classification training (``cls_train``): ``ClassificationTrainer.train()``
   for 2 epochs of ResNet-18 at 256^2, batch 256, all 8 tasks, bf16 on f32
   master weights, training BatchNorm, augmentation, dropout 0.3 and
   weighted sampling over a seeded in-memory set (3 batches of train images,
   1 of validation, a task of which holds one class), then ``evaluate`` on a
   seeded test set. It checks the run dir, a finite history, the metric keys
   (an AUC present and finite exactly where both classes occur), that every
   BatchNorm's running statistics moved, and prints the step's p50, its
   spread and peak memory (with ``--profile``, the step's device busy time,
   idle share and groups: cuDNN convolutions, BatchNorm passes, losses,
   AdamW, the rest). Then one step card against CPU (batch 8 at 64^2, the
   same seeded weights, dropout 0: f32 gradients, bf16 gradients, loss and
   running statistics, see ``CLS_F32_WORST`` and ``CLS_BF16_MARGIN``), an
   overfit of one fixed batch of 16, and a ConvNeXt-base ``Classifier``
   (``use_pallas="hybrid"``) through the same trainer, whose every step must
   launch #1's ``emit_conv`` form and #8/#9.
10. The quality-parity suite (``parity``): ``run_parity`` at its defaults
   for seeds 0 and 1, the ``tpu``/``flax`` seeds of ``PARITY_SEEDS.json``:
   ResNet-18 localization trained on rendered slices, the classification set
   cropped by that model through ``SeriesCropPipeline`` in both crop modes,
   ResNet-18 grading trained on it, then ``StudyInferencePipeline`` on 24
   held-out studies in both modes, with deterministic cuDNN algorithms (a
   seed gives one record). Each seed's record and wall time beside the
   reference's record; it raises on ``loc_pass``, ``e2e_pass``,
   ``e2e_auc_defined`` and ``e2e_rotated_pass`` and prints ``cls_pass`` and
   ``all_pass`` (see ``parity_phase``).
11. Training and inference from files (``file_backed``): a data directory of
   80 gray 512^2 PNGs written by the port's encoder (``data/png.py``, most
   rows Paeth or Sub) with ``annotations.csv``, and a seeded timm-named
   ConvNeXt-base ``.pth`` converted to ``.npz``; ``LocalizationTrainer`` from
   that directory (b16, 2 epochs, hybrid block, bf16) with
   ``pretrained_path``, ``sample_cache_dir`` and ``profile_trace``: the
   backbone equals the converted weights before training and differs after,
   the cache is built, every step launches #1's ``emit_conv`` and #8/#9, the
   Chrome trace names their kernels, ``evaluate()`` reads the test split from
   disk; a second trainer reuses the cache; the host input rates (PNG decode
   against the cache's ``get_batch``), the epoch and cache-build times;
   ResNet-18 ``ClassificationTrainer`` from a directory of 256^2 crops with a
   torchvision-named ``.pth`` converted on the fly; then
   ``StudyInferencePipeline.from_checkpoints`` of both runs on the 8 studies
   in both crop modes: the study phase's launch counts, and outputs equal bit
   for bit to a pipeline over the trainers' in-memory models. Not run with
   ``--kernels-only`` or ``--parity-only``.
12. Report OCR (``ocr``, also alone with ``--ocr-only``):
   ``DocumentExtractor(device="cuda")`` with the shipped weights (every
   parameter and buffer on the card) on the 16 bench pages and 2 report
   files of ``tests/fixtures/torch_ocr``, read with ``data/png.py``, held to
   the JAX package's record there (``utils/ocr_parity.py``: each page's box
   count and quads within 2 px once threshold ties take JAX's decision, the
   CER of the lines against JAX's within 5e-3, name, birthday and ID from
   both reports) with no kernel of this package launched; then, printed
   only, the CERs of the card and of the record against the rendered truth,
   the card-vs-CPU gaps of the maps and logits, ``ocr_pages_per_s`` as
   ``bench.py:_ocr_pages_per_s`` defines it (one warm-up, 4 batches of the
   16 pages, host work included), boxes per page, each stage's time (host
   prep, detector forward, components, rectification, recognizer forward,
   CTC decode) and, with ``--profile``, the device's busy and idle share of
   a batch.
13. Study inference from volume files (``volume_io``, run after phase 4, also
   alone with ``--io-only``; see ``volume_io_phase``): 8 studies of seeded
   int16 T1/T2 series of 17 sagittal slices of 512^2 written by the port's
   writers as DICOM (uncompressed and JPEG Lossless), ``.nii.gz``, ``.mha``
   and ``.nrrd``; read back bit for bit; ``study_input_from_paths`` on the
   card against the CPU; the fast middle slice against the whole-volume
   resample on the card; ``StudyInferencePipeline.run`` from the files in
   both crop modes with the study phase's launch counts, equal bit for bit
   to a run on the in-memory volumes' slices; decode, entropy-decode, slice
   and files-to-results times. Not run with ``--kernels-only`` or
   ``--parity-only``.
14. The directory server (``serve``, after phase 13 on its files, also alone
   with ``--serve-only``; see ``serve_phase``): 32 requests and a malformed
   one through ``serve_directory``, each result equal to ``run`` on the same
   batch, then two server threads on one pipeline serving each request
   once; ms a study from the first claim to the last result.
15. The dataset builders (``builders``, after phase 14, also alone with
   ``--build-only``; see ``builders_phase``): the classification builder
   over SPIDER and Phenikaa trees of phase 13's series with a ConvNeXt-base
   checkpoint (crops equal to ``SeriesCropPipeline.run``, resume writes
   nothing), the localization builder over RSNA-like DICOM and pretrain
   sources, ``preprocess_phenikaa`` with the shipped OCR weights on the two
   fixture report pages; series and crops a second, each builder's wall
   time. Phases 14 and 15 launch #1 and #2 as the study graph does, a
   forward; the ``kernels`` line reports them a forward.
16. OCR training and evaluation (``ocr_train``, after phase 12, also alone
   with ``--ocr-train-only``; see ``ocr_train_phase``): the shipped weights
   through the port's ``evaluate_recognizer`` (clean, ``hard``, unseen
   font), ``evaluate_detector`` (the same sets) and
   ``evaluate_layout_extraction`` on the port's rendered sets, each beside
   the JAX package's figure and held to a band of it; ``train_recognizer``
   (100 steps, b64 lines of 32x256) and ``train_detector`` (40 steps, b16
   pages of 320x448) from seed 0, the last 5 losses' mean at most 0.8 of the
   first 5's, each step's p50 and spread (CUDA events), the render time a
   chunk, the peak memory and, with ``--profile``, the device's idle share
   of the run; one step of each net on the card against the CPU; the
   written ``.npz`` read back by ``preprocess_phenikaa``'s loader into a
   ``DocumentExtractor`` on the card, which reads a report page. No kernel
   of this package lies on the path (all launch counts 0).
   ``--ocr-train-full`` runs ``train_ocr_stack`` at the JAX defaults (4000
   and 1200 steps; not in the default run) and prints every metric and
   each part's wall time.
17. Data parallelism (``ddp``, last, also alone with ``--ddp-only``; see
   ``ddp_phase``): ranks started as processes of this script. One rank over
   NCCL trains the train phase's ConvNeXt-base (hybrid, 512^2, batch 32)
   and the cls_train phase's ResNet-18 (256^2, batch 256, f32) through
   ``train()`` without a group and through DistributedDataParallel, bit for
   bit the same, and prints both step p50s; two ranks on the one card over
   gloo train the same global batches split in two (BatchNorm synced over
   them), the first step's gradients and BatchNorm running statistics held
   to the single process's and the parameters after two steps by the CPU
   test's rule, the largest gaps printed; a control run of the ResNet with
   each rank's own BatchNorm statistics must fail those bounds;
   ``from_checkpoints(mesh=data_parallel_mesh())`` bit
   for bit ``mesh=None`` on 8 studies. The ``kernels`` line's ``ddp`` path
   counts one DDP step's launches and one forward's, summed.

18. The backbone zoo (``zoo``, last, also alone with ``--zoo-only``; see
   ``zoo_phase`` and ``ZOO_FORWARD``-``ZOO_PNGS``): a Classifier at 256^2,
   b32, bf16 from seeded Flax-layout trees for one name per code path
   (ResNet-50, ResNeXt-50, ResNet-RS-50, ResNet-50 with Flax BatchNorm and
   the scatter-free pool, ViT-base, Swin-tiny, EfficientNet-B0 and V2-S,
   MobileNetV3-large): two rows of logits against the CPU, the forward's
   p50, img/s and peak memory; ``ClassificationTrainer.train()`` of
   EfficientNet-B0, Swin-tiny and ViT-base (b64 at 256^2, 2 epochs) and
   ``LocalizationTrainer.train()`` of a ViT-base ``CoordinateRegressor``
   with a residual ``HeadConfig`` at 512^2 b16: run dirs, finite histories,
   step p50s; one f32 step's gradients card against CPU per family; the
   test-time inference functions on 8 PNG files and their arrays against a
   direct forward. No kernel of this package lies on the zoo's paths: every
   launch count of the phase is 0.

19. The f32 forms (``f32``, after the ``cls_*`` phases, also alone with
   ``--f32-only``; see ``f32_kernel_phase`` and ``f32_phase``), the JAX
   package's kernels as it runs them with ``mixed_precision=False``: #1 (both
   forms), #7, #5, #8/#9, #6 and #10 in f32 at their main-path shapes (the
   study graph's B16 for #1, the train step's B32 for the rest) against their
   plain f32 versions within 1e-4 of max |plain| per output, timed beside the
   plain version, one PyTorch call of the same function (TF32 off) and the
   bound: the products as 3xTF32 work (three TF32 products each, at 495
   TFLOP/s: the f32 forms' core, ``csrc/wg_gemm.cuh``), with the bound at the
   67 TFLOP/s f32 rate beside it (``simt_bound_ms``, the bound of the SIMT
   core that came before it); one f32 step card against CPU in each of "hybrid",
   True, "mlp", "block" and the LayerScale-free "mlp" model, each parameter
   within 1e-3 of its norm, with each mode's launch counts; ConvNeXt-base
   localization at 512^2, batch 32, f32 through ``LocalizationTrainer`` for
   3 fixed batches in all five ``use_pallas`` modes, each step's loss within
   1e-4 (relative) of PyTorch's own ops (``use_pallas=False``) from the same
   weights, with the step p50 and peak memory; one f32 step of a ConvNeXt-base
   ``Classifier`` (hybrid) through ``ClassificationTrainer``; the f32 study
   graph on the 8 studies against the CPU (coordinates within 1e-4,
   probabilities within 1e-3, the same grades but at the CPU's near-ties),
   #1 33 and #2 3 launches a forward. The f32 launches are counted again
   under each kernel's name + ``_f32``; the ``kernels`` line lists the f32
   forms so, each on its f32 path.

20. The command line (``cli``, after phase 15 on phase 13's files, also
   alone with ``--cli-only``; see ``cli_phase``): the committed JPEG
   fixtures against Pillow's record (decode ms a frame and a series), then
   ``spine_vision_torch.cli.cli(argv)`` with ``--device cuda`` through
   ``dataset localization``, ``train localization`` (ConvNeXt-base 512²,
   b32, hybrid, bf16, 3 steps, from a timm ``.pth``, the tracker on),
   ``evaluate`` (the train command's metrics),
   ``dataset classification`` (cropped by that checkpoint), ``train
   classification`` (ResNet-18 256²) and ``evaluate``, ``infer`` and
   ``serve --once`` (volume_io's studies and one with baseline-JPEG DICOM
   frames; bit for bit ``StudyInferencePipeline.run`` and each other),
   ``test`` on JPEG and PNG files, ``dataset phenikaa`` with a JPEG report
   page, ``bench`` raising, and ``python -m spine_vision_torch.cli convert``
   of a torchvision ``.pth`` in a subprocess (its ``.npz`` the ResNet's
   ``--pretrained-path``); the launches of #1, #2 and #8/#9 counted as the path
   ``cli``.
21. The codecs (``codecs``, after phase 20, also alone with
   ``--codecs-only``; see ``codecs_phase``): the committed JPEG 2000 and
   progressive JPEG fixtures against Pillow's record (decode ms a frame and
   a series, tier-1 or entropy decode apart); the lossless 12-bit series and
   the lossy 16-bit one wrapped as .90 and .91 DICOM series at volume_io's
   geometry; ``StudyInferencePipeline.run`` on two studies of them from
   files, both crop modes, bit for bit the run on uncompressed DICOM series
   of the same decoded arrays; the ``test`` command's path on JPEG 2000 and
   progressive files with the f32 regressor; the launches of #1 and #2 (and
   #1's f32 form) counted as the path ``codecs``.
22. PDF reports (``pdf``, after phase 21, also alone with ``--pdf-only``,
   which checks #1 and #2 first for its ``kernels`` line; see
   ``pdf_phase``): the committed fixtures (``tests/fixtures/torch_pdf``)
   rendered at 200 dpi by the port (no PyMuPDF) against their record, the
   C++ scan converter, resamplers and G4 decoder against their plain
   versions bit for bit, ms a page (parse, interpretation, image decode,
   rasterisation) for a vector and a scanned A4 report; the shipped OCR on
   the card reading each report (the ID through
   ``DEFAULT_PDF_ID_CROP_REGION``'s crop, the three fields on the page);
   ``dataset phenikaa`` over four patient-named PDF reports, every patient
   matched through the crop path, then ``dataset classification`` over them
   (#1 and #2 counted as the path ``pdf``).

Each phase prints its wall time.

It prints a ``kernels`` JSON line and the card's name and power limit before
its last line, ``{"ok": true, "device": {...}}``. Needs a CUDA device and the
rest of the repository; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import json
import logging
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

H100_BF16_FLOPS = 989e12  # dense tensor-core bf16 peak
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12  # dense tensor-core TF32 peak: the f32 forms' products, three a product
H100_BYTES_S = 3.35e12  # HBM3

BLOCK_SHAPES = ((128, 128, 3), (64, 256, 3), (32, 512, 27))  # (H=W, C, blocks)
DW_LN_SHAPES = ((16, 1024, 3),)
TRAIN_DW_SHAPES = BLOCK_SHAPES + DW_LN_SHAPES  # every block's dwconv+LN backward
BATCH = 16  # 8 studies x (T1, T2)
KERNEL_REL_TOL = 1e-2  # max |kernel - plain| <= 1e-2 * max |plain| (~2.5 bf16 steps)
TRAIN_BATCH = 32  # the localization trainer's batch at 512^2
# The gradient checks' step: batch 2 at 128^2, so the blocks of C <= 512 see
# 32^2, 16^2 and 8^2 (the path of the MLP forward #5).
GRAD_BATCH = 2
GRAD_BLOCK_SHAPES = ((32, 128, 3), (16, 256, 3), (8, 512, 27))
# The LN+MLP backward: the same rounding points as its plain version, but a
# value on a rounding boundary can round apart and the weight gradients sum
# 32K-512K such products in another order: 2e-2 * max |plain| per output.
BWD_REL_TOL = 2e-2
RUN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_runs"
# Every kernel wrapper's launch counter, by the name the report gives it.
KERNEL_COUNTERS = ("convnext_block", "convnext_block_emit_conv", "dw_ln", "ln_mlp", "mlp_fwd",
                   "ln_mlp_bwd", "mlp_bwd", "dw_ln_bwd", "depthwise_conv7x7", "block_train_bwd",
                   "copy_tiled", "copy_staged", "copy_bulk", "read_only", "write_only",
                   "inc_copy", "gelu_map", "mlp_ablate",
                   # the f32 forms' launches, also counted under their kernel's name
                   "convnext_block_f32", "convnext_block_emit_conv_f32", "ln_mlp_f32",
                   "mlp_fwd_f32", "ln_mlp_bwd_f32", "mlp_bwd_f32", "block_train_bwd_f32")
# The kernels with an f32 form, each counted again under its name + "_f32".
F32_TWINS = ("convnext_block", "convnext_block_emit_conv", "ln_mlp", "mlp_fwd", "ln_mlp_bwd",
             "mlp_bwd", "block_train_bwd")
# The probe kernels (#11): each replaces the pallas_calls of the scripts named.
PROBE_SOURCES = {
    "copy_tiled": ("spine_vision_torch/csrc/probe_copy.cu",
                   "scripts/probe_copy_bw.py:36, scripts/probe_copy_bw2.py:52, "
                   "scripts/probe_copy_bw3.py:40"),
    "copy_staged": ("spine_vision_torch/csrc/probe_copy.cu",
                    "scripts/probe_copy_bw2.py:100, scripts/probe_copy_bw4.py:84, "
                    "scripts/probe_copy_bw5.py:255"),
    "copy_bulk": ("spine_vision_torch/csrc/probe_copy.cu",
                  "scripts/probe_copy_bw2.py:122, scripts/probe_copy_bw4.py:124, "
                  "scripts/probe_copy_bw5.py:140 and :232"),
    "read_only": ("spine_vision_torch/csrc/probe_copy.cu", "scripts/probe_copy_bw5.py:85"),
    "write_only": ("spine_vision_torch/csrc/probe_copy.cu", "scripts/probe_copy_bw5.py:187"),
    "inc_copy": ("spine_vision_torch/csrc/probe_copy.cu", "scripts/probe_copy_bw6.py:66"),
    "gelu_map": ("spine_vision_torch/csrc/probe_gelu.cu", "scripts/probe_gelu_cost.py:45"),
    "mlp_ablate": ("spine_vision_torch/csrc/probe_mlp.cu", "scripts/ablate_mlp_kernel.py:96"),
}


def _launches(**nonzero: int) -> dict:
    return {name: nonzero.get(name, 0) for name in KERNEL_COUNTERS}


def _f32_twins(launches: dict) -> dict:
    """The same launches in f32: each kernel with an f32 form counted again
    under its f32 name."""
    return {**launches, **{f"{k}_f32": launches[k] for k in F32_TWINS}}


INFERENCE_LAUNCHES = _launches(convnext_block=33, dw_ln=3)
# Launches in one train step of each training mode (the 3 blocks of C = 1024
# run plain ops in the "mlp" and "block" modes).
TRAIN_LAUNCHES = {
    "train_step": _launches(convnext_block=33, convnext_block_emit_conv=33, ln_mlp_bwd=33),
    "train_step_dwconv": _launches(convnext_block=33, dw_ln=36, mlp_bwd=33, dw_ln_bwd=36,
                                   depthwise_conv7x7=36),
    "train_step_mlp": _launches(ln_mlp=33, ln_mlp_bwd=33),
    "train_step_block": _launches(convnext_block=33, block_train_bwd=33, depthwise_conv7x7=33),
}
# One gradient-check step on the card: ConvNeXt-base without LayerScale in the
# "mlp" mode runs the fused MLP (#5 forward, #6 backward) on its 33 blocks of
# C <= 512; its path is that check.
GRAD_LAUNCHES = {
    "hybrid": TRAIN_LAUNCHES["train_step"],
    True: TRAIN_LAUNCHES["train_step_dwconv"],
    "mlp": TRAIN_LAUNCHES["train_step_mlp"],
    "block": TRAIN_LAUNCHES["train_step_block"],
    "mlp_no_layer_scale": _launches(mlp_fwd=33, mlp_bwd=33),
}
# Card against CPU, one step's gradients at bf16: each parameter's relative
# error (norm of the difference over the norm) stays under 2e-2, five bf16
# rounding steps (2^-8) of relative error; the first card run read 7.9e-3.
GRAD_REL_TOL = 2e-2
# ConvNeXt-base without LayerScale: the residual stream is undamped through
# its 36 blocks, and bf16 rounding flips grow on their way, so PyTorch's own
# ops on that model (use_pallas=False, no kernel of this package) can differ
# card against CPU by more than GRAD_REL_TOL. Its check runs each seed of
# NO_LAYER_SCALE_SEEDS (weights and batch) twice, through the kernels and
# through PyTorch's own ops, and holds the kernels' worst parameter within
# GRAD_REL_TOL, or within PLAIN_MARGIN times the plain ops' worst on the same
# seed where that is larger: the kernels may add no more than a quarter to
# the gap that the card's own arithmetic leaves.
NO_LAYER_SCALE_SEEDS = (3, 5, 7)
PLAIN_MARGIN = 1.25
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


def _bound_ms(nbytes: float, tensor_flops: float, f32_flops: float,
              tf32_flops: float = 0) -> tuple[float, str]:
    """The least time (ms) and what bounds it: the larger of the bytes at
    3.35 TB/s and the operations, bf16 tensor flops at 989 TFLOP/s, f32 ones
    at 67 and f32 product flops (``tf32_flops``) as 3xTF32 work, three TF32
    products each at 495."""
    t_bytes = nbytes / H100_BYTES_S * 1e3
    t_ops = max(tensor_flops / H100_BF16_FLOPS, f32_flops / H100_F32_FLOPS,
                3 * tf32_flops / H100_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed_row(what: str, count: int, err: float, kernel, plain, library, nbytes: float,
               tensor_flops: float, f32_flops: float, per: str, plain_iters: int = 3,
               plain_warmup: int = 1, tf32_flops: float = 0) -> tuple:
    """Time the kernel, its plain version and the PyTorch yardstick with CUDA
    events, print them beside the bound, and return the report row ``(count,
    err, ms, plain_ms, bound_ms, bound_by, library_ms)``; with f32 product
    flops (``tf32_flops``, bound as 3xTF32 work) also ``simt_bound_ms``, the
    bound with them at the f32 rate. The caller restores the kernel's launch
    count: these launches are not the main path's."""
    ms = _time_ms(kernel)
    plain_ms = _time_ms(plain, iters=plain_iters, warmup=plain_warmup)
    library_ms = _time_ms(library)
    bound, by = _bound_ms(nbytes, tensor_flops, f32_flops, tf32_flops)
    simt = _bound_ms(nbytes, tensor_flops, f32_flops + tf32_flops)[0] if tf32_flops else None
    print(f"[kernel] {what}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bound:.4f} ({by}) roofline_share={bound / ms:.3f}"
          + (f" simt_bound_ms={simt:.4f}" if simt is not None else "") + f" {per}={count}")
    row = (count, err, ms, plain_ms, bound, by, library_ms)
    return row if simt is None else (*row, simt)


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
        m = BATCH * hw * hw
        rows.append(_timed_row(
            f"convnext_block C={c}", count, err, lambda: cb.convnext_block(*args),
            lambda: cb.block_reference(*args), library,
            2 * m * c * 2 + 2 * 4 * c * c * 2 + 49 * c * 2 + (4 * c + 6 * c) * 4,
            2 * 2 * m * c * 4 * c, 2 * 49 * m * c, "per_forward", plain_iters=5, plain_warmup=3))
        _stage_times(f"convnext_block C={c}", lambda: cb.convnext_block(*args),
                     _fwd_stage_bounds(m, c, emit=False), FWD_STAGE_KERNELS)
        cb.convnext_block.launches = saved
    report["convnext_block"] = rows

    # Kernel 2: dwconv + LayerNorm, at inference's C = 1024 and at every
    # shape of the all-kernel train step.
    report["dw_ln"] = _dw_ln_rows(gen, device, BATCH, DW_LN_SHAPES, "per_forward")
    report["dw_ln@train_step_dwconv"] = _dw_ln_rows(gen, device, TRAIN_BATCH, TRAIN_DW_SHAPES,
                                                    "per_train_step")
    return report


def _dw_ln_rows(gen, device, batch: int, shapes, per: str) -> list:
    """#2 at each of ``shapes`` on ``batch`` images: bf16 against its plain
    version within KERNEL_REL_TOL * max |plain| and f32 within 1e-4, timed
    beside the plain version, ``F.conv2d`` + ``F.layer_norm`` and the bound,
    and its launch from a profile (``[stage]`` line). Returns the rows."""
    import torch
    import torch.nn.functional as F

    from spine_vision_torch.ops import dwconv as dw

    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for hw, c, count in shapes:
        x = _rand(gen, (batch, hw, hw, c), 1.0, device, bf16)
        args = (
            x,
            _rand(gen, (49, c), 0.1, device, bf16),
            _rand(gen, (c,), 0.1, device, f32),
            _rand(gen, (c,), 0.1, device, f32, 1.0),
            _rand(gen, (c,), 0.1, device, f32),
        )
        saved = dw.dw_ln.launches
        got = dw.dw_ln(*args)
        want = dw.dw_ln_reference(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = err <= KERNEL_REL_TOL * scale
        shape = f"B={batch} {hw}x{hw} C={c}"
        print(f"[kernel] dw_ln {shape}: max_abs_err={err:.4g} "
              f"max_rel_err={err / scale:.4g} tol={KERNEL_REL_TOL}*max|plain|={KERNEL_REL_TOL * scale:.4g}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dw_ln disagrees with its plain version at {shape}")
        del got, want
        # f32 inputs too (the kernel is templated on the data type).
        args32 = (x.float(), args[1].float(), *args[2:])
        err32 = (dw.dw_ln(*args32) - dw.dw_ln_reference(*args32)).abs().max().item()
        print(f"[kernel] dw_ln f32 {shape}: max_abs_err={err32:.4g} tol=1e-4")
        if not err32 <= 1e-4:
            raise AssertionError(f"dw_ln (f32) disagrees with its plain version at {shape}")
        del args32

        k_oihw = args[1].t().reshape(c, 1, 7, 7).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)

        def library():
            t = F.conv2d(x_nchw, k_oihw, args[2].to(bf16), padding=3, groups=c)
            return F.layer_norm(t.permute(0, 2, 3, 1), (c,), args[3].to(bf16), args[4].to(bf16), 1e-6)

        m = batch * hw * hw
        # x read, y written, the filter and three vectors read; the conv's 98
        # and the LayerNorm's about 8 f32 operations a channel of a token.
        nbytes, ops = 2 * m * c * 2 + 49 * c * 2 + 3 * c * 4, 2 * 49 * m * c + 8 * m * c
        rows.append(_timed_row(
            f"dw_ln {shape}", count, max(err, err32), lambda: dw.dw_ln(*args),
            lambda: dw.dw_ln_reference(*args), library, nbytes, 0, ops, per,
            plain_iters=5, plain_warmup=3))
        _stage_times(f"dw_ln {shape}", lambda: dw.dw_ln(*args),
                     {"#2 tile": _bound_ms(nbytes, 0, ops)}, DW_LN_STAGE_KERNELS)
        dw.dw_ln.launches = saved
        del x, args, x_nchw, k_oihw
        torch.cuda.empty_cache()
    return rows


def _check_outputs(what: str, names, got, want, tol: float, again=None) -> list[float]:
    """Each output within ``tol * max |plain|`` (and, given ``again``, equal
    bit for bit to a second run); returns the max absolute errors."""
    import torch

    errs = []
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        if not err <= tol * scale:
            raise AssertionError(f"{what} {name} disagrees with its plain version: "
                                 f"{err:.4g} > {tol} * {scale:.4g}")
        if again is not None and not torch.equal(a, again[i]):
            raise AssertionError(f"{what} {name} differs between two runs on the same inputs")
        errs.append(err)
    print(f"[kernel] {what}: max_abs_err " + " ".join(f"{n}={e:.3g}" for n, e in zip(names, errs))
          + f" (tol {tol}*max|plain| each)" + (", two runs bitwise equal" if again else "") + " ok")
    return errs


# The products of csrc/wg_gemm.cuh by epilogue, as the profiler names them
# without spaces: wg_gemm<T,NA,NB,MN,EPI> with EPI the number of its EPI_*
# (the MLP backward's 0-3, the block forward's 4 and 5), in bf16 and f32
# (whose K splits add split_reduce).
def _gemm(na_nb: tuple, mn: str, epi: int) -> tuple:
    return tuple(f"wg_gemm<{t},{na},{nb},{mn},{epi}>" for t in ("__nv_bfloat16", "float")
                 for na, nb in na_nb)


# The MLP backward's stages (csrc/ln_mlp_bwd.cuh) by kernel name; #10 adds
# its two ends: the conv recompute (the stencil #3's f32-and-bias epilogue)
# and the tap sums.
BWD_STAGE_KERNELS = (
    ("A rows", ("bwd_rows<",)),
    ("B hidden", _gemm(((2, 2),), "false", 0)),
    ("C g_y", _gemm(((1, 1), (1, 2)), "false", 1) + _gemm(((1, 1), (1, 2)), "false", 2)),
    ("L LayerNorm", ("ln_rows_bwd<",)),
    ("D weight grads", _gemm(((1, 1),), "true", 3) + ("reduce_rows", "colsum")),
    ("#10 conv", ("dw_stencil<__nv_bfloat16,float,true>",)),
    ("#10 taps", ("tap_sums<",)),
)
# The block forward #1's launches (csrc/convnext_block.cu).
FWD_STAGE_KERNELS = (
    ("P stencil+LN", ("block_prologue<",)),
    ("F1 hidden", _gemm(((1, 1), (1, 2)), "false", 4)),
    ("F2 out", _gemm(((1, 1), (1, 2)), "false", 5)),
)
# The row forms' launches (csrc/row_mlp.cu): #7's LayerNorm rows, then #1's
# products; #5's F2 without its tail is EPI_BIAS (6).
ROW_STAGE_KERNELS = (
    ("L LN rows", ("mlp_ln_rows<",)),
    FWD_STAGE_KERNELS[1],
    ("F2 out", FWD_STAGE_KERNELS[2][1] + _gemm(((1, 1), (1, 2)), "false", 6)),
)


# The dwconv+LN backward #4's launches (csrc/dwconv_bwd.cu): the statistics
# S, the tile T and the column sums; and the stencil #3's one launch.
DW_BWD_STAGE_KERNELS = (
    ("S statistics", ("dw_bwd_stats<",)),
    ("T tile", ("dw_bwd_tile<",)),
    ("colsum", ("colsum",)),
)
DW_STENCIL_STAGE_KERNELS = (
    ("stencil", ("dw_stencil<__nv_bfloat16,__nv_bfloat16,false>",
                 "dw_stencil<float,float,false>")),)
# #2's one launch (csrc/dwconv_ln.cu).
DW_LN_STAGE_KERNELS = (("#2 tile", ("dw_ln_tile<",)),)


def _dw_bwd_stage_bounds(m: int, c: int, parts: int) -> dict:
    """Each launch of #4 (bf16) beside its bound (ms, what bounds it): S reads
    x and g and writes 16 bytes a token against the conv's 98 and the
    LayerNorm statistics' 8 f32 operations a channel of a token; T reads x, g
    and the statistics and writes da and its ``parts`` workspace rows against
    the conv's and dk's 98 each and the LayerNorm backward's 10; colsum reads
    the workspace and writes the 52 sums a channel."""
    ws = parts * 52 * c * 4
    return {
        "S statistics": _bound_ms(4 * m * c + 16 * m + 98 * c * 2 + 8 * c, 0, 106 * m * c),
        "T tile": _bound_ms(6 * m * c + 16 * m + 98 * c * 2 + 8 * c + ws, 0, 206 * m * c),
        "colsum": _bound_ms(ws + 52 * c * 4, 0, parts * 52 * c),
    }


def _dw_stencil_bounds(m: int, c: int) -> dict:
    """The stencil #3 (bf16) beside its bound: x read, out written, the
    filter read, against 98 f32 operations a channel of a token."""
    return {"stencil": _bound_ms(4 * m * c + 98 * c, 0, 98 * m * c)}


def _bwd_stage_bounds(m: int, c: int, ln: bool, u32: bool = False) -> dict:
    """Each stage's bound (ms, what bounds it): the bytes it must move
    (inputs read once, outputs written once) against its bf16 products; with
    ``u32`` (#10) its two ends: the conv recompute reads bf16 x and writes
    the f32 u, the tap sums read bf16 x and the f32 g_u and write dk and
    ddwb, each against 98 f32 operations a channel of a token."""
    t_bytes = 4 if u32 else 2
    ends = {
        "#10 conv": _bound_ms(6 * m * c + 98 * c + 4 * c, 0, 98 * m * c),
        "#10 taps": _bound_ms(6 * m * c + 50 * c * 4, 0, 99 * m * c),
    } if u32 else {}
    return {
        **ends,
        # Without the LayerNorm stage A reads g and writes g * gamma only.
        "A rows": _bound_ms(m * c * ((t_bytes + 2 + 2 + 2 + 8 / c) if ln else 4), 0, 0),
        "B hidden": _bound_ms(4 * m * c + 16 * m * c + 16 * c * c, 16 * m * c * c, 0),
        "C g_y": _bound_ms(8 * m * c + 8 * c * c + (4 if ln else 2) * m * c, 8 * m * c * c, 0),
        "L LayerNorm": _bound_ms(m * c * (4 + t_bytes + 2 + (4 if u32 else 0)) + 8 * m, 0, 0),
        "D weight grads": _bound_ms(20 * m * c + 32 * c * c, 16 * m * c * c, 0),
    }


def _fwd_stage_bounds(m: int, c: int, emit: bool) -> dict:
    """Each launch of #1 beside its bound (ms, what bounds it): P the bytes it
    must move (x read, y and, emitting, t written) against its 98 f32
    operations a channel of a token; F1 and F2 their bytes against their
    bf16 products."""
    return {
        "P stencil+LN": _bound_ms(m * c * (6 if emit else 4) + 98 * c + 12 * c, 0, 98 * m * c),
        "F1 hidden": _bound_ms(10 * m * c + 8 * c * c + 16 * c, 8 * m * c * c, 0),
        "F2 out": _bound_ms(12 * m * c + 8 * c * c + 8 * c, 8 * m * c * c, 0),
    }


def _row_stage_bounds(m: int, c: int, tail: bool = True) -> dict:
    """Each launch of the row forms beside its bound (ms, what bounds it): L
    the bytes it must move (x read, y written); F1 and F2 as #1's, F2 without
    the tail reading no residual."""
    fwd = _fwd_stage_bounds(m, c, emit=False)
    return {
        "L LN rows": _bound_ms(4 * m * c + 8 * c, 0, 0),
        "F1 hidden": fwd["F1 hidden"],
        "F2 out": fwd["F2 out"] if tail else _bound_ms(10 * m * c + 8 * c * c + 4 * c,
                                                       8 * m * c * c, 0),
    }


def _stage_times(what: str, call, bounds: dict, table=BWD_STAGE_KERNELS,
                 calls: int = 5) -> dict:
    """Device time a call of each stage in ``table`` (the MLP backward's by
    default), from a profile of ``calls`` calls, beside its bound; prints one
    line a stage and returns the times (ms) by stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    events = _device_events(prof)
    total = sum(_dev_us(e) for e in events) / calls / 1e3
    print(f"[stage] {what}: device ms a call {total:.4f}")
    times = {}
    for label, parts in table:
        group = [e for e in events if any(p in e.key.replace(" ", "") for p in parts)]
        if not group:
            continue
        ms = sum(_dev_us(e) for e in group) / calls / 1e3
        times[label] = ms
        line = f"[stage] {what} {label}: ms={ms:.4f} ({ms / total:.1%} of the call's device time)"
        if label in bounds:
            bound, by = bounds[label]
            line += f" bound_ms={bound:.4f} ({by}) roofline_share={bound / ms:.3f}"
        print(line)
    return times


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

        emit_rows.append(_timed_row(
            f"convnext_block emit_conv C={c}", count, max(err_out, err_t),
            lambda: cb.convnext_block(*args, emit_conv=True),
            lambda: cb.block_reference(*args, emit_conv=True), library_fwd,
            3 * m * c * 2 + 2 * 4 * c * c * 2 + 49 * c * 2 + (4 * c + 6 * c) * 4,
            2 * 2 * m * c * 4 * c, 2 * 49 * m * c, "per_train_step"))
        _stage_times(f"convnext_block emit_conv C={c}",
                     lambda: cb.convnext_block(*args, emit_conv=True),
                     _fwd_stage_bounds(m, c, emit=True), FWD_STAGE_KERNELS)
        cb.convnext_block.launches, cb.convnext_block.emit_launches = saved

        # 2. The LN+MLP backward from t and an output gradient g.
        g = _rand(gen, (TRAIN_BATCH, hw, hw, c), 1.0, device, bf16)
        bargs = (t, args[3], args[4], args[5], args[6], args[7], args[8], args[9], g)
        saved = fm.ln_mlp_bwd.launches
        got = fm.ln_mlp_bwd(*bargs)
        want = fm.ln_mlp_bwd_reference(*bargs)
        torch.cuda.synchronize()
        errs = _check_outputs(f"ln_mlp_bwd B={TRAIN_BATCH} {hw}x{hw} C={c}",
                              ("dt", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma"),
                              got, want, BWD_REL_TOL)
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

        bwd_rows.append(_timed_row(
            f"ln_mlp_bwd C={c}", count, max(errs), lambda: fm.ln_mlp_bwd(*bargs),
            lambda: fm.ln_mlp_bwd_reference(*bargs), library_bwd,
            3 * m * c * 2 + 2 * 4 * c * c * 2 + 2 * 4 * c * c * 4 + 10 * c * 4 + 4 * c * 8,
            5 * 2 * m * c * 4 * c, 15 * m * 4 * c + 20 * m * c, "per_train_step"))
        _stage_times(f"ln_mlp_bwd C={c}", lambda: fm.ln_mlp_bwd(*bargs),
                     _bwd_stage_bounds(m, c, ln=True))
        fm.ln_mlp_bwd.launches = saved
        del t, g, bargs, leaves, t_leaf, out
        torch.cuda.empty_cache()
    report["convnext_block_emit_conv"] = emit_rows
    report["ln_mlp_bwd"] = bwd_rows


def dwconv_train_kernel_phase(device, report: dict) -> None:
    """The all-kernel block's backward kernels at the train step's shapes:
    the dwconv+LN backward (#4) and the depthwise stencil (#3, on #4's da with
    the flipped filter, as the backward runs it) at every width, the MLP
    backward (#6) at C <= 512. Each against its plain version, #4 and #6 also
    against a second run bit for bit, timed beside the plain version, a
    PyTorch yardstick and the bound, and each launch of #4, #3 and #6 from a
    profile (``[stage]`` lines). Rows go into ``report``."""
    import torch
    import torch.nn.functional as F

    from spine_vision_torch.ops import dwconv as dw
    from spine_vision_torch.ops import fused_mlp as fm

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(2)
    rows = {"mlp_bwd": [], "dw_ln_bwd": [], "depthwise_conv7x7": []}
    for hw, c, count in TRAIN_DW_SHAPES:
        m = TRAIN_BATCH * hw * hw
        x = _rand(gen, (TRAIN_BATCH, hw, hw, c), 1.0, device, bf16)
        k49 = _rand(gen, (49, c), 0.1, device, bf16)
        bias, beta = _rand(gen, (c,), 0.1, device, f32), _rand(gen, (c,), 0.1, device, f32)
        scale = _rand(gen, (c,), 0.1, device, f32, 1.0)
        g = _rand(gen, (TRAIN_BATCH, hw, hw, c), 1.0, device, bf16)
        args = (x, k49, bias, scale, g)

        # Kernel #4: da and the parameter sums.
        saved = dw.dw_ln_bwd_sums.launches, dw.depthwise_conv7x7.launches
        got = dw.dw_ln_bwd_sums(*args)
        again = dw.dw_ln_bwd_sums(*args)
        want = dw.dw_ln_bwd_sums_reference(*args)
        torch.cuda.synchronize()
        errs = _check_outputs(f"dw_ln_bwd B={TRAIN_BATCH} {hw}x{hw} C={c}",
                              ("da", "dk", "dbias", "dscale", "dbeta"), got, want, BWD_REL_TOL,
                              again)
        da = got[0]
        del again, want
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_(True)  # channels_last view
        kl = k49.t().reshape(c, 1, 7, 7).contiguous().requires_grad_(True)
        vl = [v.to(bf16).requires_grad_(True) for v in (bias, scale, beta)]

        def library4():
            t = F.conv2d(xl, kl, vl[0], padding=3, groups=c).permute(0, 2, 3, 1)
            y = F.layer_norm(t, (c,), vl[1], vl[2], 1e-6)
            return torch.autograd.grad(y, [xl, kl, *vl], g)

        # x and g read, da written (bf16), filter and vectors in, 52 sums out;
        # conv recompute 98, dk 98, LayerNorm statistics and backward 17 f32
        # operations a channel of a token.
        rows["dw_ln_bwd"].append(_timed_row(
            f"dw_ln_bwd C={c}", count, max(errs), lambda: dw.dw_ln_bwd_sums(*args),
            lambda: dw.dw_ln_bwd_sums_reference(*args), library4,
            3 * m * c * 2 + 49 * c * 2 + 2 * c * 4 + 52 * c * 4, 0, 213 * m * c,
            "per_train_step"))
        parts = dw.bwd_geometry(TRAIN_BATCH, hw, hw, c, bf16)["parts"]
        _stage_times(f"dw_ln_bwd C={c}", lambda: dw.dw_ln_bwd_sums(*args),
                     _dw_bwd_stage_bounds(m, c, parts), DW_BWD_STAGE_KERNELS)

        # Kernel #3: dx = the stencil on da with the flipped filter.
        kf = k49.flip(0).contiguous()
        dx = dw.depthwise_conv7x7(da, kf)
        want_dx = dw.depthwise_conv7x7_reference(da, kf)
        torch.cuda.synchronize()
        err = (dx.float() - want_dx).abs().max().item()
        tol = KERNEL_REL_TOL * want_dx.abs().max().item()
        print(f"[kernel] depthwise_conv7x7 B={TRAIN_BATCH} {hw}x{hw} C={c}: max_abs_err={err:.4g} "
              f"tol={KERNEL_REL_TOL}*max|plain|={tol:.4g} {'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            raise AssertionError(f"depthwise_conv7x7 disagrees with its plain version at C={c}")
        kf_oihw = kf.t().reshape(c, 1, 7, 7).contiguous()
        da_nchw = da.permute(0, 3, 1, 2)
        rows["depthwise_conv7x7"].append(_timed_row(
            f"depthwise_conv7x7 C={c}", count, err, lambda: dw.depthwise_conv7x7(da, kf),
            lambda: dw.depthwise_conv7x7_reference(da, kf),
            lambda: F.conv2d(da_nchw, kf_oihw, padding=3, groups=c),
            2 * m * c * 2 + 49 * c * 2, 0, 98 * m * c, "per_train_step"))
        _stage_times(f"depthwise_conv7x7 C={c}", lambda: dw.depthwise_conv7x7(da, kf),
                     _dw_stencil_bounds(m, c), DW_STENCIL_STAGE_KERNELS)
        dw.dw_ln_bwd_sums.launches, dw.depthwise_conv7x7.launches = saved
        del got, da, dx, want_dx, xl, kl, vl

        # Kernel #6: the MLP backward from the block's y, at C <= 512.
        if c <= 512:
            margs = (
                _rand(gen, (TRAIN_BATCH, hw, hw, c), 1.0, device, bf16),
                _rand(gen, (4 * c, c), c ** -0.5, device, bf16),
                _rand(gen, (4 * c,), 0.1, device, f32),
                _rand(gen, (c, 4 * c), (4 * c) ** -0.5, device, bf16),
                _rand(gen, (c,), 0.1, device, f32),
                _rand(gen, (c,), 0.1, device, f32, 1.0),
                g,
            )
            saved = fm.mlp_bwd.launches
            got = fm.mlp_bwd(*margs)
            again = fm.mlp_bwd(*margs)
            want = fm.mlp_bwd_reference(*margs)
            torch.cuda.synchronize()
            errs = _check_outputs(f"mlp_bwd B={TRAIN_BATCH} {hw}x{hw} C={c}",
                                  ("dy", "dw1t", "db1", "dw2t", "db2", "dgamma"), got, want,
                                  BWD_REL_TOL, again)
            del got, again, want
            leaves = [a.detach().clone().to(bf16).requires_grad_(True) for a in margs[:6]]

            def library6():
                y, w1t, b1, w2t, b2, gamma = leaves
                h = F.gelu(F.linear(y, w1t, b1), approximate="tanh")
                return torch.autograd.grad(F.linear(h, w2t, b2) * gamma, leaves, g)

            rows["mlp_bwd"].append(_timed_row(
                f"mlp_bwd C={c}", count, max(errs), lambda: fm.mlp_bwd(*margs),
                lambda: fm.mlp_bwd_reference(*margs), library6,
                3 * m * c * 2 + 2 * 4 * c * c * 2 + 2 * 4 * c * c * 4 + 7 * c * 4 + 4 * c * 8,
                5 * 2 * m * c * 4 * c, 15 * m * 4 * c + 6 * m * c, "per_train_step"))
            _stage_times(f"mlp_bwd C={c}", lambda: fm.mlp_bwd(*margs),
                         _bwd_stage_bounds(m, c, ln=False))
            fm.mlp_bwd.launches = saved
            del margs, leaves
        del x, g, args
        torch.cuda.empty_cache()
    report.update(rows)


def _mlp_args(gen, hw: int, c: int, device, batch: int = TRAIN_BATCH) -> dict:
    """Inputs of the MLP forwards at a block's shape (bf16 rows)."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    shape = (batch, hw, hw, c)
    return {
        "x": _rand(gen, shape, 1.0, device, bf16),
        "ln_scale": _rand(gen, (c,), 0.1, device, f32, 1.0),
        "ln_bias": _rand(gen, (c,), 0.1, device, f32),
        "w1t": _rand(gen, (4 * c, c), c ** -0.5, device, bf16),
        "b1": _rand(gen, (4 * c,), 0.1, device, f32),
        "w2t": _rand(gen, (c, 4 * c), (4 * c) ** -0.5, device, bf16),
        "b2": _rand(gen, (c,), 0.1, device, f32),
        "gamma": _rand(gen, (c,), 0.1, device, f32, 1.0),
        "residual": _rand(gen, shape, 1.0, device, bf16),
    }


def mlp_kernel_phase(device, report: dict) -> None:
    """The MLP forwards: the LN+MLP forward (#7) at the train step's shapes
    and the MLP forward (#5) in both forms at those shapes and at the shapes
    of its path, the gradient check without LayerScale (B = 2 at 128^2). Each
    against its plain version, timed beside the plain version, a PyTorch
    yardstick and the bound (#5 in its tail form, the one the ConvNeXt block
    runs). #7's train-step rows and #5's grad-check rows go into ``report``."""
    import torch
    import torch.nn.functional as F

    from spine_vision_torch.ops import fused_mlp as fm

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(3)
    rows = {"ln_mlp": [], "mlp_fwd": []}
    shapes = [(TRAIN_BATCH, hw, c, count, "per_train_step") for hw, c, count in BLOCK_SHAPES]
    shapes += [(GRAD_BATCH, hw, c, count, "per_grad_check_step")
               for hw, c, count in GRAD_BLOCK_SHAPES]
    for batch, hw, c, count, per in shapes:
        m = batch * hw * hw
        a = _mlp_args(gen, hw, c, device, batch)
        largs = tuple(a[k] for k in ("x", "ln_scale", "ln_bias", "w1t", "b1", "w2t", "b2",
                                     "gamma", "residual"))
        margs = tuple(a[k] for k in ("x", "w1t", "b1", "w2t", "b2"))
        tail = {"gamma": a["gamma"], "residual": a["residual"]}
        saved = fm.ln_mlp.launches, fm.mlp_fwd.launches
        shape = f"B={batch} {hw}x{hw} C={c}"
        train = batch == TRAIN_BATCH
        if train:
            (err7,) = _check_outputs(f"ln_mlp {shape}", ("out",), (fm.ln_mlp(*largs),),
                                     (fm.ln_mlp_reference(*largs),), KERNEL_REL_TOL)
        err5, err5n = _check_outputs(
            f"mlp_fwd {shape}", ("tail", "no_tail"),
            (fm.mlp_fwd(*margs, **tail), fm.mlp_fwd(*margs)),
            (fm.mlp_reference(*margs, **tail), fm.mlp_reference(*margs)), KERNEL_REL_TOL)
        vec = {k: a[k].to(bf16) for k in ("ln_scale", "ln_bias", "b1", "b2", "gamma")}

        def mlp_lib(y):
            h = F.gelu(F.linear(y, a["w1t"], vec["b1"]), approximate="tanh")
            return F.linear(h, a["w2t"], vec["b2"]) * vec["gamma"] + a["residual"]

        def library7():
            return mlp_lib(F.layer_norm(a["x"].float(), (c,), a["ln_scale"], a["ln_bias"],
                                        1e-6).to(bf16))

        # x and the residual read, the output written, the weights read once;
        # 16 M C^2 tensor flops; GELU and bias 15 f32 operations a hidden
        # value, the LayerNorm and the tail about 10 a channel.
        nbytes = 3 * m * c * 2 + 2 * 4 * c * c * 2 + (4 * c + 5 * c) * 4
        if train:
            rows["ln_mlp"].append(_timed_row(
                f"ln_mlp {shape}", count, err7, lambda: fm.ln_mlp(*largs),
                lambda: fm.ln_mlp_reference(*largs), library7, nbytes, 16 * m * c * c,
                15 * m * 4 * c + 10 * m * c, per))
            _stage_times(f"ln_mlp {shape}", lambda: fm.ln_mlp(*largs), _row_stage_bounds(m, c),
                         ROW_STAGE_KERNELS)
        row5 = _timed_row(
            f"mlp_fwd {shape}", count, max(err5, err5n), lambda: fm.mlp_fwd(*margs, **tail),
            lambda: fm.mlp_reference(*margs, **tail), lambda: mlp_lib(a["x"]), nbytes,
            16 * m * c * c, 15 * m * 4 * c + 4 * m * c,
            per if not train else "blocks_of_this_shape")
        if not train:
            rows["mlp_fwd"].append(row5)
        _stage_times(f"mlp_fwd {shape}", lambda: fm.mlp_fwd(*margs, **tail),
                     _row_stage_bounds(m, c), ROW_STAGE_KERNELS)
        no_tail_ms = _time_ms(lambda: fm.mlp_fwd(*margs))
        print(f"[kernel] mlp_fwd no tail {shape}: ms={no_tail_ms:.4f}")
        _stage_times(f"mlp_fwd no tail {shape}", lambda: fm.mlp_fwd(*margs),
                     _row_stage_bounds(m, c, tail=False), ROW_STAGE_KERNELS)
        fm.ln_mlp.launches, fm.mlp_fwd.launches = saved
        del a, largs, margs, tail, vec
        torch.cuda.empty_cache()
    report.update(rows)


def block_train_kernel_phase(device, report: dict) -> None:
    """The whole-block backward (#10) at the train step's shapes: every output
    against its plain version, and against a second run bit for bit, timed
    beside the plain version, a PyTorch yardstick and the bound; then its two
    ends alone (:func:`_block_end_rows`). The rows go into ``report``, the
    ends' under ``block_train_bwd#conv`` and ``#taps``."""
    import torch
    import torch.nn.functional as F

    from spine_vision_torch.ops import block_train as bt

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(4)
    rows, end_rows = [], {"#10 conv": [], "#10 taps": []}
    for hw, c, count in BLOCK_SHAPES:
        m = TRAIN_BATCH * hw * hw
        a = _mlp_args(gen, hw, c, device)
        args = (a["x"], _rand(gen, (49, c), 0.1, device, bf16), _rand(gen, (c,), 0.1, device, f32),
                a["ln_scale"], a["ln_bias"], a["w1t"], a["b1"], a["w2t"], a["b2"], a["gamma"])
        g = a["residual"]
        saved = bt.block_train_bwd.launches
        got = bt.block_train_bwd(*args, g)
        again = bt.block_train_bwd(*args, g)
        want = bt.block_train_bwd_reference(*args, g)
        torch.cuda.synchronize()
        errs = _check_outputs(
            f"block_train_bwd B={TRAIN_BATCH} {hw}x{hw} C={c}",
            ("g_u", "dk", "ddwb", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma"),
            got, want, BWD_REL_TOL, again)
        del got, again, want
        xl = a["x"].permute(0, 3, 1, 2).detach().requires_grad_(True)  # channels_last view
        kl = args[1].t().reshape(c, 1, 7, 7).contiguous().requires_grad_(True)
        leaves = [v.detach().clone().to(bf16).requires_grad_(True) for v in args[2:]]

        def library10():
            bias, ls, lb, w1t, b1, w2t, b2, gamma = leaves
            t = F.conv2d(xl, kl, bias, padding=3, groups=c).permute(0, 2, 3, 1)
            y = F.layer_norm(t, (c,), ls, lb, 1e-6)
            h = F.gelu(F.linear(y, w1t, b1), approximate="tanh")
            out = F.linear(h, w2t, b2) * gamma + xl.permute(0, 2, 3, 1)
            return torch.autograd.grad(out, [xl, kl, *leaves], g)

        # x and g read, g_u written (bf16), the weights read once and their f32
        # gradients written; five products, 40 M C^2 tensor flops; the
        # stencil recompute and the tap sums 98 f32 operations each a channel
        # of a token, GELU and its derivative about 20 a hidden value, the
        # LayerNorm and its backward about 20 a channel.
        rows.append(_timed_row(
            f"block_train_bwd C={c}", count, max(errs), lambda: bt.block_train_bwd(*args, g),
            lambda: bt.block_train_bwd_reference(*args, g), library10,
            3 * m * c * 2 + 2 * 4 * c * c * 2 + 49 * c * 2 + 2 * 4 * c * c * 4
            + (49 * c + 14 * c) * 4, 40 * m * c * c, 216 * m * c + 20 * m * 4 * c,
            "per_train_step"))
        bounds = _bwd_stage_bounds(m, c, ln=True, u32=True)
        times = _stage_times(f"block_train_bwd C={c}", lambda: bt.block_train_bwd(*args, g),
                             bounds)
        bt.block_train_bwd.launches = saved
        del xl, kl, leaves
        _block_end_rows(args, g, count, times, bounds, end_rows)
        del a, args, g
        torch.cuda.empty_cache()
    report["block_train_bwd"] = rows
    report["block_train_bwd#conv"] = end_rows["#10 conv"]
    report["block_train_bwd#taps"] = end_rows["#10 taps"]


def _block_end_rows(args, g, count: int, times: dict, bounds: dict, end_rows: dict) -> None:
    """#10's two ends alone, from one call's buffers (``bt.bwd_launch``): the
    conv recompute u against its plain stage within 1e-5 * max |plain| (f32
    sums in another order), the tap sums of the call's own f32 g_u within
    1e-4; each beside its plain stage, one PyTorch call of the same function
    (the grouped ``F.conv2d`` with bias; ``conv2d_weight`` on f32 x and g_u
    and ``g_u.sum``) and its bound, its device time from the profile
    (``times``). Appends a row to each of ``end_rows``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    from spine_vision_torch.ops import block_train as bt

    x, k49, bias = args[0], args[1], args[2]
    c = x.shape[-1]
    o = bt.bwd_launch(*args, g)
    u, gu = o["u"].view(x.shape), o["gu32"].view(x.shape)
    want_u = bt.conv_bias_reference(x, k49, bias)
    want_taps = bt.tap_sums_reference(x, gu)
    torch.cuda.synchronize()
    err_u = (u - want_u).abs().max().item()
    taps = (o["taps"][: 49 * c].view(49, c), o["taps"][49 * c:])
    err_t = [(a - b).abs().max().item() for a, b in zip(taps, want_taps)]
    scale_u = want_u.abs().max().item()
    scale_t = [b.abs().max().item() for b in want_taps]
    print(f"[stage] block_train_bwd C={c} ends: u max_abs_err={err_u:.4g} (tol 1e-5*max|plain|="
          f"{1e-5 * scale_u:.4g}), dk {err_t[0]:.4g} (tol {1e-4 * scale_t[0]:.4g}), ddwb "
          f"{err_t[1]:.4g} (tol {1e-4 * scale_t[1]:.4g})")
    if err_u > 1e-5 * scale_u or any(e > 1e-4 * s for e, s in zip(err_t, scale_t)):
        raise AssertionError(f"#10's ends disagree with their plain stages at C={c}")
    del o, want_u, want_taps, taps
    x_nchw = x.permute(0, 3, 1, 2)  # channels_last views
    k_oihw = k49.t().reshape(c, 1, 7, 7).contiguous()
    x32, gu_nchw = x.float().permute(0, 3, 1, 2), gu.permute(0, 3, 1, 2)
    bias16 = bias.to(torch.bfloat16)
    calls = {
        "#10 conv": (err_u, lambda: bt.conv_bias_reference(x, k49, bias),
                     lambda: F.conv2d(x_nchw, k_oihw, bias16, padding=3, groups=c)),
        "#10 taps": (max(err_t), lambda: bt.tap_sums_reference(x, gu),
                     lambda: (conv2d_weight(x32, (c, 1, 7, 7), gu_nchw, padding=3, groups=c),
                              gu.sum(dim=(0, 1, 2)))),
    }
    for stage, (err, plain, library) in calls.items():
        plain_ms = _time_ms(plain, iters=3, warmup=1)
        library_ms = _time_ms(library)
        bound, by = bounds[stage]
        ms = times[stage]
        print(f"[stage] block_train_bwd C={c} {stage}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound:.4f} ({by}) "
              f"roofline_share={bound / ms:.3f} per_train_step={count}")
        end_rows[stage].append((count, err, ms, plain_ms, bound, by, library_ms))


def probe_phase(device, batch: int = 32) -> tuple[dict, dict]:
    """The measurement probes' entry point at the scripts' shapes, with every
    counter at 0 before it and read after it (each probe kernel must have
    launched); then every variant of every probe kernel against its plain
    version, the plain version timed (3 launches after 1). Returns the
    counts and, by kernel, ``(row, max_abs_err, plain_ms)`` triples, the rows
    rid of their inputs."""
    import torch

    from spine_vision_torch import probes

    _zero_counts()
    tables = probes.run("all", device=device, batch=batch)
    counts = _counts()
    print(f"[probes] launches in the probe run {({k: v for k, v in counts.items() if v})}")
    idle = [k for k in PROBE_SOURCES if counts[k] == 0]
    if idle:
        raise AssertionError(f"the probe run launched no {idle}")
    checked: dict = {}
    for rows in tables.values():
        for row in rows:
            if row.kernel == "torch":
                continue
            what = f"{row.probe} {row.variant} ({row.kernel})"
            try:
                err = probes.max_error(row.call(), row.plain(), row.tol)
            except AssertionError as exc:
                raise AssertionError(f"probe {what}: {exc}") from None
            torch.cuda.synchronize()
            plain_ms = _time_ms(row.plain, iters=3, warmup=1)
            checked.setdefault(row.kernel, []).append((row, err, plain_ms))
            tol = {None: "bit for bit", "ulp": "within 1 bf16 ulp"}.get(
                row.tol, f"within {row.tol}*max|plain|")
            print(f"[probes] check {what}: max_abs_err={err:.4g} ({tol}) plain_ms={plain_ms:.4f}")
    _set_counts(counts)
    for rows in tables.values():  # the later phases get the card's memory back
        for row in rows:
            row.call = row.plain = row.library = None
    del tables, rows
    gc.collect()
    torch.cuda.empty_cache()
    return counts, checked


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


def _device_events(prof) -> list:
    """Device-side events (kernels, copies) by name: operator rows would count
    their kernels a second time, and so would a user annotation's range on
    the device timeline (e.g. the optimizer step's)."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _profile_groups(launches: dict) -> tuple:
    """Kernel groups of a train step's profile, (label, name fragments), for
    a step with these launch counts. #1 and the row forms #7 and #5 launch
    the same products (F1, F2) under the same names; no training mode runs
    both (the routes of models/convnext.py), so the step's counters say whose
    they are."""
    products = sum((parts for _, parts in ROW_STAGE_KERNELS[1:]), ())
    rows = launches["ln_mlp"] + launches["mlp_fwd"]
    if rows and launches["convnext_block"]:
        raise AssertionError("a step runs #1 and the row forms, whose products share names")
    return (("block forward #1 (P, F1, F2)", ("block_prologue<",) + (() if rows else products)),
            ("LN+MLP and MLP forwards #7, #5 (L, F1, F2)",
             ("mlp_ln_rows<",) + (products if rows else ())),
            *PROFILE_GROUPS)


# The other kernel groups of a train step's profile: (label, name fragments).
PROFILE_GROUPS = (
    ("dwconv+LN #2", DW_LN_STAGE_KERNELS[0][1]),
    ("MLP backward per token #6, #8/#9, #10",
     sum((dict(BWD_STAGE_KERNELS)[s] for s in ("A rows", "B hidden", "C g_y", "L LayerNorm")),
         ())),
    ("their weight-gradient products", _gemm(((1, 1),), "true", 3) + ("reduce_rows",)),
    ("#10's conv recompute (#3's stencil, f32+bias epilogue)", dict(BWD_STAGE_KERNELS)["#10 conv"]),
    ("#10's tap sums", dict(BWD_STAGE_KERNELS)["#10 taps"]),
    ("dwconv+LN backward #4", DW_BWD_STAGE_KERNELS[0][1] + DW_BWD_STAGE_KERNELS[1][1]),
    ("stencil #3", DW_STENCIL_STAGE_KERNELS[0][1]),
    ("column sums of #4, #6, #8/#9, #10", ("colsum",)),
    ("PyTorch depthwise-conv gradients", ("conv_depthwise2d",)),
    ("cuDNN depthwise conv, its data and weight gradients",
     ("conv2d_c1_k1", "dgrad2d_c1_k1", "wgrad2d_c1_k1")),
)


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
    events = _device_events(prof)
    dev = _dev_us
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


# Each seeded regressor's loaded weights on the host, by (backbone,
# layer_scale_init, seed): the tree is drawn and converted once, and every
# later build of the same weights (another mode, dtype or device) copies them.
_REGRESSOR_STATES: dict = {}


def _regressor(device, seed: int, dropout: float, use_pallas="hybrid",
               layer_scale_init: float | None = None, backbone: str = "convnext_base",
               dtype=None):
    """ConvNeXt-base (or ``backbone``) CoordinateRegressor for training in
    ``dtype`` (default bf16) on f32 masters, the given kernel mode, weights
    from a seeded Flax-layout tree. With ``layer_scale_init``, the backbone
    is ConvNeXt-base's depths and widths with that LayerScale (0: none). The
    modules are built on the meta device, so the constructor's own initial
    draws (all replaced by the tree's) cost nothing; the weights of a seed
    are drawn once (``_REGRESSOR_STATES``)."""
    import torch

    from spine_vision_torch.models.classifier import CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
    from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS, ConvNeXt, ConvNeXtConfig

    kw = {"dtype": dtype or torch.bfloat16, "device": "meta", "use_pallas": use_pallas,
          "param_dtype": torch.float32}
    with torch.device("meta"):
        model = CoordinateRegressor(backbone, dropout=dropout, **kw)
        if layer_scale_init is not None:
            base = CONVNEXT_CONFIGS["convnext_base"]
            model.backbone = ConvNeXt(
                ConvNeXtConfig(base.depths, base.dims, layer_scale_init=layer_scale_init), **kw)
    model = model.to_empty(device=device)
    key = (backbone, layer_scale_init, seed)
    if key in _REGRESSOR_STATES:
        model.load_state_dict(_REGRESSOR_STATES[key])
        return model
    params, _ = random_flax_variables(model, seed)
    load_flax_variables(model, params)
    _REGRESSOR_STATES[key] = {k: v.detach().to("cpu", copy=True)
                              for k, v in model.state_dict().items()}
    return model


def _counters() -> dict:
    """Each kernel's wrapper and the attribute of its launch counter."""
    from spine_vision_torch.ops import block_train as bt
    from spine_vision_torch.ops import convnext_block as cb
    from spine_vision_torch.ops import dwconv as dw
    from spine_vision_torch.ops import fused_mlp as fm
    from spine_vision_torch.probes import ablate_mlp, copy_bw, gelu_cost

    probes = {name: (getattr(copy_bw, name), "launches") for name in
              ("copy_tiled", "copy_staged", "copy_bulk", "read_only", "write_only", "inc_copy")}
    probes["gelu_map"] = (gelu_cost.gelu_map, "launches")
    probes["mlp_ablate"] = (ablate_mlp.mlp_ablate, "launches")
    return {"convnext_block": (cb.convnext_block, "launches"),
            "convnext_block_emit_conv": (cb.convnext_block, "emit_launches"),
            "dw_ln": (dw.dw_ln, "launches"), "ln_mlp": (fm.ln_mlp, "launches"),
            "mlp_fwd": (fm.mlp_fwd, "launches"), "ln_mlp_bwd": (fm.ln_mlp_bwd, "launches"),
            "mlp_bwd": (fm.mlp_bwd, "launches"), "dw_ln_bwd": (dw.dw_ln_bwd_sums, "launches"),
            "depthwise_conv7x7": (dw.depthwise_conv7x7, "launches"),
            "block_train_bwd": (bt.block_train_bwd, "launches"), **probes,
            "convnext_block_f32": (cb.convnext_block, "f32_launches"),
            "convnext_block_emit_conv_f32": (cb.convnext_block, "emit_f32_launches"),
            "ln_mlp_f32": (fm.ln_mlp, "f32_launches"), "mlp_fwd_f32": (fm.mlp_fwd, "f32_launches"),
            "ln_mlp_bwd_f32": (fm.ln_mlp_bwd, "f32_launches"),
            "mlp_bwd_f32": (fm.mlp_bwd, "f32_launches"),
            "block_train_bwd_f32": (bt.block_train_bwd, "f32_launches")}


def _counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def _zero_counts() -> None:
    _set_counts(dict.fromkeys(KERNEL_COUNTERS, 0))


def _set_counts(counts: dict) -> None:
    for name, (fn, attr) in _counters().items():
        setattr(fn, attr, counts[name])


# The training paths: (trainer flags, the model's use_pallas when the script
# builds the model from a seeded Flax-layout tree, None when the trainer
# builds it from its seed).
TRAIN_PATHS = {
    "train_step": ({}, "hybrid"),
    "train_step_dwconv": ({"use_pallas_dwconv": True}, None),
    "train_step_mlp": ({"use_pallas_mlp": True, "use_pallas_dwconv": False}, None),
    "train_step_block": ({}, "block"),
}


def train_phase(device, card: str, path: str, profile: bool = False) -> dict:
    """LocalizationTrainer.train() at full width; return the launch counts of
    one train step. ``path`` (``TRAIN_PATHS``): "train_step" trains the hybrid
    block, "train_step_dwconv" the all-kernel block of ``use_pallas_dwconv=True``,
    "train_step_mlp" the LN-fused MLP mode of ``use_pallas_mlp=True``,
    "train_step_block" the whole-block training kernel (a ``use_pallas="block"``
    model handed to the trainer)."""
    import math

    import numpy as np
    import torch

    from spine_vision_torch.models.convnext import ConvNeXtBlock
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    flags, use_pallas = TRAIN_PATHS[path]
    tag = f"[{path}]"
    t0 = time.perf_counter()
    model = None if use_pallas is None else _regressor(device, seed=0, dropout=0.2,
                                                       use_pallas=use_pallas)
    train_set, val_set = _Images(96, 512, 10), _Images(32, 512, 11)
    run = RUN_DIR / path
    shutil.rmtree(run, ignore_errors=True)
    cfg = LocalizationConfig(
        backbone="convnext_base", image_size=(512, 512), batch_size=TRAIN_BATCH, num_epochs=2,
        augment=True, dropout=0.2, mixed_precision=True, output_path=run, num_workers=8,
        pretrained=False, profile_steps=True, seed=0, **flags,
    )
    trainer = LocalizationTrainer(cfg, model=model, train_dataset=train_set,
                                  val_dataset=val_set, device=device)
    blocks = [b for b in trainer.model.modules() if isinstance(b, ConvNeXtBlock)]
    routes = dict(Counter(b.route for b in blocks))
    print(f"{tag} model and data built in {time.perf_counter() - t0:.1f} s; blocks by route "
          f"{routes}, of {len(blocks)}")
    step_counts = []
    inner = trainer.train_step_fn

    def counted_step(state, batch):
        _zero_counts()
        loss = inner(state, batch)
        step_counts.append(_counts())
        return loss

    trainer.train_step_fn = counted_step
    gc.collect()  # earlier phases' trainers sit in reference cycles
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = trainer.train()
    wall = time.perf_counter() - t0
    want = TRAIN_LAUNCHES[path]
    print(f"{tag} {len(step_counts)} train steps, 2 epochs in {wall:.1f} s; launches in "
          f"the first step {step_counts[0]}")
    if len(step_counts) != 6:
        raise AssertionError(f"expected 6 train steps (2 epochs of 96 / 32), got {len(step_counts)}")
    for i, counts in enumerate(step_counts):
        if counts != want:
            raise AssertionError(f"{path} {i}: launches {counts}, expected {want}")
    for name in ("best_model/state.pt", "best_model.meta.json", "config.yaml", "logs"):
        if not (run / name).exists():
            raise AssertionError(f"run dir lacks {name}")
    for key in ("train_loss", "val_loss", "lr", "med"):
        values = result.history[key]
        if len(values) != 2 or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"history[{key!r}] = {values}")
    print(f"{tag} history: train_loss {result.history['train_loss']}, val_loss "
          f"{result.history['val_loss']}, med {result.history['med']}, lr {result.history['lr']}")
    steps = trainer.step_times[1:]  # the first step allocates and tunes
    p50 = float(np.percentile(steps, 50)) * 1e3
    print(f"{tag} train step p50 {p50:.3f} ms = {TRAIN_BATCH / p50 * 1e3:.2f} img/s "
          f"(ConvNeXt-base 512^2 b{TRAIN_BATCH} bf16; upload, augmentation and the optimizer "
          f"included, the loader's prefetch not; {len(steps)} steps after the first; steps ms "
          f"{[round(t * 1e3, 3) for t in trainer.step_times]}) on {card}")
    print(f"{tag} peak device memory of the training run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, of which "
          f"{held / 2**30:.2f} GiB were held before it (the model, the kernel phases' leftovers)")
    if profile:
        profile_train(trainer, train_set, p50, path)
    shutil.rmtree(run, ignore_errors=True)
    return {"launches": step_counts[0], "p50_ms": p50}


def profile_train(trainer, dataset, p50_ms: float, path: str) -> None:
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
    events = _device_events(prof)
    dev = _dev_us
    busy_ms = sum(dev(e) for e in events) / 1e3 / 2
    print(f"[profile] {path}: traced wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}); against the untraced p50 {p50_ms:.3f} ms the idle "
          f"share is {1 - busy_ms / p50_ms:.1%}")
    for e in sorted(events, key=dev, reverse=True)[:20]:
        print(f"[profile] {path}: {dev(e) / 1e3 / 2:9.3f} ms/step x{e.count // 2:<5d} "
              f"{e.key[:90]}")
    rest = list(events)
    for label, parts in _profile_groups(TRAIN_LAUNCHES[path]):
        group = [e for e in rest if any(p in e.key.replace(" ", "") for p in parts)]
        rest = [e for e in rest if e not in group]
        print(f"[profile] {path} group: {sum(dev(e) for e in group) / 1e3 / 2:9.3f} ms/step "
              f"x{sum(e.count for e in group) // 2:<5d} {label}")
    print(f"[profile] {path} group: {sum(dev(e) for e in rest) / 1e3 / 2:9.3f} ms/step "
          f"x{sum(e.count for e in rest) // 2:<5d} everything else (PyTorch's own kernels)")


def _step_grads(dev, use_pallas, layer_scale, batch, seed: int = 3, dtype=None) -> tuple:
    """One train step of the gradient check's model (weights from ``seed``,
    in ``dtype``, default bf16) on ``dev``: ``(grads by parameter name, loss,
    seconds, launch counts)``."""
    import torch

    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    run = RUN_DIR / f"grad_{dev.type}"
    shutil.rmtree(run, ignore_errors=True)
    cfg = LocalizationConfig(
        backbone="convnext_base", image_size=(128, 128), batch_size=GRAD_BATCH, num_epochs=1,
        augment=False, dropout=0.0, output_path=run, num_workers=1, pretrained=False,
        grad_clip=None, seed=0, use_pallas_dwconv=use_pallas is True,
        mixed_precision=dtype in (None, torch.bfloat16),
    )
    model = _regressor(dev, seed=seed, dropout=0.0, use_pallas=use_pallas,
                       layer_scale_init=layer_scale, dtype=dtype)
    trainer = LocalizationTrainer(cfg, model=model, train_dataset=_Images(GRAD_BATCH, 128, 12),
                                  val_dataset=_Images(GRAD_BATCH, 128, 13), device=dev)
    t0 = time.perf_counter()
    _zero_counts()
    loss = float(trainer.train_step_fn(trainer.state, batch))
    out = ({n: p.grad.detach().float().cpu() for n, p in trainer.model.named_parameters()},
           loss, time.perf_counter() - t0, _counts())
    shutil.rmtree(run, ignore_errors=True)
    return out


def _card_vs_cpu(device, use_pallas, layer_scale, seed: int, dtype=None) -> tuple:
    """One step on the card and on the CPU from the same weights and batch, in
    ``dtype`` (default bf16): ``(per-parameter ||g_card - g_cpu|| /
    ||g_cpu||, card step, CPU step)``."""
    import torch

    from spine_vision_torch.data.loader import collate_localization

    data = _Images(GRAD_BATCH, 128, 9 + seed)
    batch = collate_localization([data[i] for i in range(GRAD_BATCH)])
    card = _step_grads(device, use_pallas, layer_scale, batch, seed, dtype)
    cpu = _step_grads(torch.device("cpu"), use_pallas, layer_scale, batch, seed, dtype)
    rel = {n: (torch.linalg.vector_norm(card[0][n] - cpu[0][n]) /
               torch.linalg.vector_norm(cpu[0][n]).clamp_min(1e-30)).item() for n in cpu[0]}
    return rel, card, cpu


def grad_check(device, mode, dtype=None) -> dict:
    """One step's gradients, card against CPU: ConvNeXt-base at full width,
    batch 2 at 128^2 (stages 32^2 .. 4^2 reach all four widths), augmentation
    and dropout off, the same weights and batch, the same entry point; the
    hybrid block ("hybrid"), the all-kernel block (True), the LN-fused MLP
    mode ("mlp"), the whole-block training kernel ("block"), or the "mlp" mode
    on ConvNeXt-base without LayerScale, whose blocks run the fused MLP
    ("mlp_no_layer_scale": in bf16 every seed of NO_LAYER_SCALE_SEEDS, each
    beside PyTorch's own ops on the same model). In bf16 (the default) each
    parameter within GRAD_REL_TOL; in f32 (``dtype=torch.float32``, the f32
    forms) within F32_GRAD_TOL on one seed, the launches counted again as
    f32's. Returns the launch counts of the card's step."""
    import numpy as np
    import torch

    f32 = dtype == torch.float32
    no_ls = mode == "mlp_no_layer_scale"
    use_pallas, layer_scale = ("mlp", 0.0) if no_ls else (mode, None)
    want = _f32_twins(GRAD_LAUNCHES[mode]) if f32 else GRAD_LAUNCHES[mode]
    tag = f"{mode!r} f32" if f32 else repr(mode)
    for seed in NO_LAYER_SCALE_SEEDS if no_ls and not f32 else (3,):
        rel, card, cpu = _card_vs_cpu(device, use_pallas, layer_scale, seed, dtype)
        counts = card[3]
        if counts != want:
            raise AssertionError(f"grad check {tag}: launches {counts}, expected {want}")
        worst = sorted(rel.items(), key=lambda kv: kv[1], reverse=True)[:4]
        tol, yardstick = (F32_GRAD_TOL if f32 else GRAD_REL_TOL), ""
        if no_ls and not f32:
            plain = _card_vs_cpu(device, False, layer_scale, seed)[0]
            tol = max(GRAD_REL_TOL, PLAIN_MARGIN * max(plain.values()))
            yardstick = (f"; PyTorch's own ops on the same model (use_pallas=False): median "
                         f"{np.median(list(plain.values())):.4g}, max {max(plain.values()):.4g}")
        print(f"[grad] {tag} seed {seed}: card vs CPU, one step of {len(rel)} parameters "
              f"(CPU step {cpu[2]:.1f} s): loss {card[1]:.6f} vs {cpu[1]:.6f}; per-parameter "
              f"||g_card - g_cpu|| / ||g_cpu||: median {np.median(list(rel.values())):.4g}, "
              f"max {worst[0][1]:.4g} ({worst[0][0]}), tol {tol:.4g}{yardstick}; card "
              f"launches {counts}")
        print(f"[grad] largest: {[(n, round(v, 5)) for n, v in worst]}")
        if worst[0][1] > tol:
            raise AssertionError(f"card and CPU gradients differ beyond {tol}: {worst}")
    return counts


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


# The classification phase (cls_train): ResNet-18 at 256^2, batch 256, all
# 8 tasks, bf16 on f32 masters, as bench.py:152-221 and the JAX trainer's
# defaults; 3 batches of train images a epoch, 1 of validation, 1 of test.
CLS_BATCH = 256
CLS_HW = 256
# Card against CPU, one classification step (batch 8 at 64^2), the CPU's f32
# run the reference. The card's f32 run: every parameter's gradient within
# CLS_F32_WORST of its norm, the median over the parameters within
# CLS_F32_MEDIAN (a ReLU input within f32 rounding of 0 can take the other
# side and move what is upstream of it by a few per cent: 2.6e-2 in the CPU
# tests against JAX). The card's bf16 run (on f32 masters, the trainer's
# default): with training BatchNorm at this batch, bf16 rounding moves the
# gradients by a third of their norm (median) in the CPU's own bf16 run and
# in the JAX package's alike; so the card's bf16 gradients, loss and running
# statistics are held within CLS_BF16_MARGIN times that run's distance from
# the reference, median and worst, or within GRAD_REL_TOL where larger: two
# bf16 implementations that round independently may each sit that far.
CLS_F32_WORST = 5e-2
CLS_F32_MEDIAN = 1e-2
CLS_GRAD_BATCH = 8
CLS_GRAD_HW = 64
CLS_BF16_MARGIN = 2.0
# Overfit one fixed batch of 16 at 256^2 (dropout and augmentation off):
# with label smoothing 0.1 the multi-task loss cannot fall below about 0.9
# (the two multiclass tasks' smoothed targets), from about 7 at the start;
# below CLS_OVERFIT_FRACTION of the first loss the model must fit each image.
CLS_OVERFIT_STEPS = 40
CLS_OVERFIT_LR = 1e-3
CLS_OVERFIT_FRACTION = 0.35
# The kernel route through the classifier: a ConvNeXt-base Classifier with
# use_pallas="hybrid" trains through ClassificationTrainer (batch 8 at
# 256^2, 3 steps); each step launches #1's emit_conv form and #8/#9 on its
# 33 blocks of C <= 512, as the localization hybrid step does.
CLS_CONVNEXT_STEPS = 3
CLS_CONVNEXT_LAUNCHES = TRAIN_LAUNCHES["train_step"]


class _Grades:
    """In-memory classification samples from a seed: uint8 images, a label
    per task for each (uniform over the task's classes), a level index. The
    tasks in ``one_class`` get label 0 throughout (their AUC is undefined)."""

    def __init__(self, n: int, hw: int, seed: int, one_class: tuple = ()) -> None:
        import numpy as np

        from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, get_task

        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
        self.targets = {}
        for name in AVAILABLE_TASK_NAMES:
            task = get_task(name)
            k = task.num_classes if task.is_multiclass else 2
            self.targets[name] = np.zeros(n, np.int64) if name in one_class else \
                rng.integers(0, k, n)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> dict:
        return {"image": self.images[i], "targets": {k: v[i] for k, v in self.targets.items()},
                "level_idx": i % 5, "metadata": {"image_path": f"synthetic/{i}.png"}}

    def sample_label_values(self, label: str) -> list:
        return list(self.targets[label])


def _cls_config(name: str, **kw):
    from spine_vision_torch.train.classification import ClassificationConfig

    base = dict(backbone="resnet18", output_size=(CLS_HW, CLS_HW), batch_size=CLS_BATCH,
                num_epochs=2, output_path=RUN_DIR / name, num_workers=8, pretrained=False,
                seed=0)
    shutil.rmtree(RUN_DIR / name, ignore_errors=True)
    return ClassificationConfig(**{**base, **kw})


def _bn_stats(model) -> dict:
    from spine_vision_torch.ops.batchnorm import BatchNorm

    return {n: (m.mean.detach().clone(), m.var.detach().clone())
            for n, m in model.named_modules() if isinstance(m, BatchNorm)}


def cls_train_phase(device, card: str, profile: bool = False) -> dict:
    """ClassificationTrainer.train() for 2 epochs of ResNet-18 at 256^2, batch
    256, all 8 tasks, bf16 on f32 masters, augmentation, dropout 0.3 and
    weighted sampling, then evaluate() on a seeded test set. Returns the
    launch counts of one train step (ResNet-18 runs no kernel of this
    package: all zero)."""
    import math

    import numpy as np
    import torch

    from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, get_task
    from spine_vision_torch.train.classification import ClassificationTrainer

    tag = "[cls_train]"
    t0 = time.perf_counter()
    train_set = _Grades(3 * CLS_BATCH, CLS_HW, 20)
    val_set = _Grades(CLS_BATCH, CLS_HW, 21, one_class=("spondy",))
    test_set = _Grades(CLS_BATCH, CLS_HW, 22)
    cfg = _cls_config("cls_train", augment=True, dropout=0.3, use_weighted_sampling=True,
                      mixed_precision=True, profile_steps=True)
    trainer = ClassificationTrainer(cfg, train_dataset=train_set, val_dataset=val_set,
                                    device=device)
    stats0 = _bn_stats(trainer.model)
    print(f"{tag} model and data built in {time.perf_counter() - t0:.1f} s; "
          f"{trainer.count_parameters():,} parameters, weighted sampling on 'pfirrmann'")
    step_counts = []
    inner = trainer.train_step_fn

    def counted_step(state, batch):
        _zero_counts()
        loss = inner(state, batch)
        step_counts.append(_counts())
        return loss

    trainer.train_step_fn = counted_step
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = trainer.train()
    wall = time.perf_counter() - t0
    if len(step_counts) != 6:
        raise AssertionError(f"expected 6 train steps (2 epochs of 3 batches), got "
                             f"{len(step_counts)}")
    if any(c != _launches() for c in step_counts):
        raise AssertionError(f"a ResNet-18 step launched a kernel of the package: {step_counts}")
    for name in ("best_model/state.pt", "best_model.meta.json", "config.yaml", "logs"):
        if not (RUN_DIR / "cls_train" / name).exists():
            raise AssertionError(f"run dir lacks {name}")
    history = result.history
    for key in ("train_loss", "val_loss", "lr", "macro_f1", "overall_accuracy", "macro_auc"):
        if len(history[key]) != 2 or not all(math.isfinite(v) for v in history[key]):
            raise AssertionError(f"history[{key!r}] = {history.get(key)}")
    moved = [n for n, (m, v) in _bn_stats(trainer.model).items()
             if not (torch.equal(m, stats0[n][0]) or torch.equal(v, stats0[n][1]))]
    if len(moved) != len(stats0):
        raise AssertionError(f"BatchNorm running statistics moved in {len(moved)} of "
                             f"{len(stats0)} layers")
    print(f"{tag} {len(step_counts)} train steps, 2 epochs in {wall:.1f} s; history: "
          f"train_loss {history['train_loss']}, val_loss {history['val_loss']}, macro_f1 "
          f"{history['macro_f1']}, macro_auc {history['macro_auc']}, lr {history['lr']}; "
          f"running statistics moved in all {len(moved)} BatchNorms")

    def check_metrics(metrics: dict, data: _Grades, what: str) -> None:
        for name in AVAILABLE_TASK_NAMES:
            key = f"{name}_auc"
            defined = len(np.unique(data.targets[name])) > 1
            if get_task(name).task_type not in ("binary", "multiclass"):
                continue
            if defined != (key in metrics) or (defined and not math.isfinite(metrics[key])):
                raise AssertionError(f"{what}: {key} = {metrics.get(key)}, defined {defined}")
            if f"{name}_accuracy" not in metrics:
                raise AssertionError(f"{what}: no {name}_accuracy")
        if not math.isfinite(metrics.get("macro_f1", float("nan"))):
            raise AssertionError(f"{what}: macro_f1 = {metrics.get('macro_f1')}")

    val_metrics = {k: v[-1] for k, v in history.items() if k not in ("train_loss", "lr")}
    check_metrics(val_metrics, val_set, "validation (spondy single-class: no AUC)")
    test_metrics = trainer.evaluate(test_dataset=test_set)
    check_metrics(test_metrics, test_set, "test")
    print(f"{tag} evaluate: macro_f1 {test_metrics['macro_f1']:.4f}, macro_auc "
          f"{test_metrics['macro_auc']:.4f}, overall_accuracy "
          f"{test_metrics['overall_accuracy']:.4f} on {len(test_set)} seeded images (random "
          f"labels: chance level expected)")
    steps = np.asarray(trainer.step_times[1:]) * 1e3  # the first step allocates and tunes
    p50 = float(np.percentile(steps, 50))
    print(f"{tag} train step p50 {p50:.3f} ms = {CLS_BATCH / p50 * 1e3:.2f} img/s (ResNet-18 "
          f"256^2 b{CLS_BATCH} bf16, 8 tasks; upload, augmentation and AdamW included); spread "
          f"over {len(steps)} steps after the first: min {steps.min():.3f}, max "
          f"{steps.max():.3f} ms ({(steps.max() - steps.min()) / p50:.1%} of the p50); all "
          f"steps ms {[round(t * 1e3, 3) for t in trainer.step_times]} on {card}")
    print(f"{tag} peak device memory of the training run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, of which {held / 2**30:.2f} "
          f"GiB were held before it")
    if profile:
        profile_cls(trainer, train_set, p50)
    shutil.rmtree(RUN_DIR / "cls_train", ignore_errors=True)
    return {"launches": step_counts[0], "p50_ms": p50}


def profile_cls(trainer, dataset, p50_ms: float) -> None:
    """Two traced classification steps: device busy time, the idle share and
    the groups (cuDNN convolutions, BatchNorm passes, the losses' forward,
    AdamW, everything else), each from the device time of the kernels that
    its CPU range launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from spine_vision_torch.data.loader import collate_classification
    from spine_vision_torch.ops import batchnorm as bn

    batch = collate_classification([dataset[i] for i in range(CLS_BATCH)])
    trainer.train_step_fn(trainer.state, batch)
    torch.cuda.synchronize()
    fwd, bwd, loss_fn = bn.BatchNorm.forward, bn._BatchNormTrain.backward, trainer._multitask_loss

    def labelled(label, fn):
        def run(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return run

    bn.BatchNorm.forward = labelled("cls::batchnorm", fwd)
    bn._BatchNormTrain.backward = staticmethod(labelled("cls::batchnorm", bwd))
    trainer._multitask_loss = labelled("cls::losses", loss_fn)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(2):
                trainer.train_step_fn(trainer.state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3 / 2
    finally:
        bn.BatchNorm.forward, bn._BatchNormTrain.backward = fwd, staticmethod(bwd)
        trainer._multitask_loss = loss_fn
    events = _device_events(prof)
    busy_ms = sum(_dev_us(e) for e in events) / 1e3 / 2
    print(f"[profile] cls_train: traced wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}); against the untraced p50 {p50_ms:.3f} ms the idle "
          f"share is {1 - busy_ms / p50_ms:.1%}")
    for e in sorted(events, key=_dev_us, reverse=True)[:15]:
        print(f"[profile] cls_train: {_dev_us(e) / 1e3 / 2:9.3f} ms/step x{e.count // 2:<5d} "
              f"{e.key[:90]}")
    ranges = {e.key: e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CUDA}

    def total_ms(keys) -> float:
        return sum(getattr(ranges[k], "device_time_total", 0) for k in keys if k in ranges) \
            / 1e3 / 2

    groups = (("cuDNN convolutions (forward, data and weight gradients)",
               ("aten::convolution", "ConvolutionBackward0")),
              ("BatchNorm passes (statistics, scale-shift, three-term backward)",
               ("cls::batchnorm",)),
              ("losses (their forward; the backward's few kernels are in the rest)",
               ("cls::losses",)),
              ("AdamW", tuple(k for k in ranges if k.startswith("Optimizer.step#"))))
    rest = busy_ms
    for label, keys in groups:
        ms = total_ms(keys)
        rest -= ms
        print(f"[profile] cls_train group: {ms:9.3f} ms/step {label}")
    print(f"[profile] cls_train group: {rest:9.3f} ms/step everything else (upload, "
          f"augmentation, pooling, heads, residual adds, ReLUs, casts, clipping)")


def _cls_step(dev, dtype, batch) -> tuple:
    """One classification step of ResNet-18 (weights from a seeded Flax-layout
    tree, dropout 0) on ``dev`` in ``dtype`` (bf16: on f32 masters): ``(grads
    by parameter name, loss, running statistics by name)``."""
    import torch

    from spine_vision_torch.models.classifier import Classifier
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
    from spine_vision_torch.train.classification import (
        ClassificationTrainer,
        create_tasks_for_training,
    )

    model = Classifier("resnet18", tasks=tuple(create_tasks_for_training()), dtype=dtype,
                       device=dev, dropout=0.0, param_dtype=torch.float32)
    load_flax_variables(model, *random_flax_variables(model, 31))
    cfg = _cls_config(f"cls_grad_{dev.type}", output_size=(CLS_GRAD_HW, CLS_GRAD_HW),
                      batch_size=CLS_GRAD_BATCH, num_epochs=1, augment=False, dropout=0.0,
                      grad_clip=None, num_workers=1, use_weighted_sampling=False,
                      mixed_precision=dtype == torch.bfloat16)
    data = _Grades(CLS_GRAD_BATCH, CLS_GRAD_HW, 32)
    trainer = ClassificationTrainer(cfg, model=model, train_dataset=data, val_dataset=data,
                                    device=dev)
    _zero_counts()
    loss = float(trainer.train_step_fn(trainer.state, batch))
    if _counts() != _launches():
        raise AssertionError(f"a ResNet-18 step launched a kernel of the package: {_counts()}")
    grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    stats = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
    shutil.rmtree(RUN_DIR / f"cls_grad_{dev.type}", ignore_errors=True)
    return grads, loss, stats


def cls_grad_check(device) -> None:
    """One classification step's parameter gradients, loss and updated
    running statistics: the card in f32 and in bf16 on f32 masters against
    the CPU's f32 run (see CLS_F32_WORST and CLS_BF16_MARGIN)."""
    import numpy as np
    import torch

    from spine_vision_torch.data.loader import collate_classification

    data = _Grades(CLS_GRAD_BATCH, CLS_GRAD_HW, 33)
    batch = collate_classification([data[i] for i in range(CLS_GRAD_BATCH)])
    cpu = torch.device("cpu")
    ref = _cls_step(cpu, torch.float32, batch)
    cpu16 = _cls_step(cpu, torch.bfloat16, batch)
    card32 = _cls_step(device, torch.float32, batch)
    card16 = _cls_step(device, torch.bfloat16, batch)

    def rel(a: dict, b: dict) -> dict:
        return {n: (torch.linalg.vector_norm(a[n] - b[n]) /
                    torch.linalg.vector_norm(b[n]).clamp_min(1e-30)).item() for n in b}

    def summary(errs: dict) -> tuple:
        worst = max(errs.items(), key=lambda kv: kv[1])
        return float(np.median(list(errs.values()))), worst

    med, worst = summary(rel(card32[0], ref[0]))
    print(f"[cls_grad] f32 gradients, card vs CPU over {len(ref[0])} parameters: median "
          f"{med:.4g} (tol {CLS_F32_MEDIAN}), worst {worst[1]:.4g} ({worst[0]}; tol "
          f"{CLS_F32_WORST}); loss {card32[1]:.6f} vs {ref[1]:.6f}")
    if med > CLS_F32_MEDIAN or worst[1] > CLS_F32_WORST:
        raise AssertionError(f"card and CPU f32 gradients differ: median {med}, worst {worst}")
    for what, i in (("gradients", 0), ("running statistics", 2)):
        med, worst = summary(rel(card16[i], ref[i]))
        yard_med, yard_worst = summary(rel(cpu16[i], ref[i]))
        tol_med = max(GRAD_REL_TOL, CLS_BF16_MARGIN * yard_med)
        tol_worst = max(GRAD_REL_TOL, CLS_BF16_MARGIN * yard_worst[1])
        print(f"[cls_grad] bf16 {what}, card vs CPU f32 over {len(ref[i])} tensors: median "
              f"{med:.4g} (tol {tol_med:.4g}), worst {worst[1]:.4g} ({worst[0]}; tol "
              f"{tol_worst:.4g}); the CPU's own bf16 run: median {yard_med:.4g}, worst "
              f"{yard_worst[1]:.4g} ({yard_worst[0]})")
        if med > tol_med or worst[1] > tol_worst:
            raise AssertionError(f"card bf16 {what} beyond the bound: median {med}, {worst}")
    loss_err, loss_yard = abs(card16[1] - ref[1]) / ref[1], abs(cpu16[1] - ref[1]) / ref[1]
    loss_tol = max(GRAD_REL_TOL, CLS_BF16_MARGIN * loss_yard)
    print(f"[cls_grad] bf16 loss: card {card16[1]:.6f}, CPU f32 {ref[1]:.6f}, CPU bf16 "
          f"{cpu16[1]:.6f}; relative {loss_err:.4g}, tol {loss_tol:.4g}")
    if loss_err > loss_tol:
        raise AssertionError(f"card and CPU losses differ beyond {loss_tol}")


def cls_overfit_check(device) -> None:
    """CLS_OVERFIT_STEPS steps of ResNet-18 on one fixed batch of 16 at
    256^2: the loss must fall below CLS_OVERFIT_FRACTION of its first value."""
    import torch

    from spine_vision_torch.data.loader import collate_classification
    from spine_vision_torch.train.classification import ClassificationTrainer

    data = _Grades(16, CLS_HW, 34)
    batch = collate_classification([data[i] for i in range(16)])
    cfg = _cls_config("cls_overfit", batch_size=16, num_epochs=1, augment=False, dropout=0.0,
                      learning_rate=CLS_OVERFIT_LR, scheduler_type="none", num_workers=1,
                      use_weighted_sampling=False)
    trainer = ClassificationTrainer(cfg, train_dataset=data, val_dataset=data, device=device)
    losses = [float(trainer.train_step_fn(trainer.state, batch))
              for _ in range(CLS_OVERFIT_STEPS)]
    shutil.rmtree(RUN_DIR / "cls_overfit", ignore_errors=True)
    print(f"[cls_overfit] {CLS_OVERFIT_STEPS} steps at lr {CLS_OVERFIT_LR} on one batch of 16: "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f} ({losses[-1] / losses[0]:.3f} of the "
          f"first; must be < {CLS_OVERFIT_FRACTION}); every 5th: "
          f"{[round(v, 4) for v in losses[::5]]}")
    if not all(torch.isfinite(torch.tensor(losses))) or \
            losses[-1] >= CLS_OVERFIT_FRACTION * losses[0]:
        raise AssertionError("the classification loss did not fall on a fixed batch")


def cls_convnext_check(device) -> dict:
    """A ConvNeXt-base Classifier (use_pallas="hybrid", built by the trainer
    from its seed) through ClassificationTrainer: batch 8 at 256^2,
    CLS_CONVNEXT_STEPS steps; every step launches #1's emit_conv form and
    #8/#9 on each block of C <= 512. Returns one step's launch counts."""
    import math

    from spine_vision_torch.models.convnext import ConvNeXtBlock
    from spine_vision_torch.train.classification import ClassificationTrainer

    cfg = _cls_config("cls_convnext", backbone="convnext_base", batch_size=8, num_epochs=1,
                      num_workers=2, use_weighted_sampling=True)
    trainer = ClassificationTrainer(cfg, train_dataset=_Grades(8 * CLS_CONVNEXT_STEPS, CLS_HW, 35),
                                    val_dataset=_Grades(8, CLS_HW, 36), device=device)
    routes = dict(Counter(b.route for b in trainer.model.modules()
                          if isinstance(b, ConvNeXtBlock)))
    step_counts = []
    inner = trainer.train_step_fn

    def counted_step(state, batch):
        _zero_counts()
        loss = inner(state, batch)
        step_counts.append(_counts())
        return loss

    trainer.train_step_fn = counted_step
    result = trainer.train()
    shutil.rmtree(RUN_DIR / "cls_convnext", ignore_errors=True)
    print(f"[cls_convnext] blocks by route {routes}; {len(step_counts)} steps, launches in "
          f"each {step_counts}; train_loss {result.history['train_loss']}, macro_f1 "
          f"{result.history['macro_f1']}")
    if len(step_counts) != CLS_CONVNEXT_STEPS:
        raise AssertionError(f"expected {CLS_CONVNEXT_STEPS} steps, got {len(step_counts)}")
    for i, counts in enumerate(step_counts):
        if counts != CLS_CONVNEXT_LAUNCHES:
            raise AssertionError(f"cls_convnext step {i}: launches {counts}, expected "
                                 f"{CLS_CONVNEXT_LAUNCHES}")
    if not all(math.isfinite(v) for v in result.history["train_loss"]):
        raise AssertionError(f"train_loss {result.history['train_loss']}")
    return step_counts[0]


# The f32 forms of #1 and #5-#10: the kernels as the JAX package runs them
# with mixed_precision=False. Each f32 form against its plain f32 version
# (TF32 off) within 1e-4 of max |plain| per output, the f32 bound of
# tests/test_torch_kernels_gpu.py; one f32 step's gradients card against CPU
# in every mode within 1e-3 of each parameter's norm (f32 arithmetic has no
# rounding point to flip, so no mode needs a wider bound); the trainer's f32
# steps at full width in every mode within 1e-4 (relative) of the same steps
# on PyTorch's own ops (use_pallas=False) from the same weights and batches.
F32_REL_TOL = 1e-4
F32_GRAD_TOL = 1e-3
F32_LOSS_TOL = 1e-4
F32_TRAIN_HW = 512  # the localization trainer's images
F32_TRAIN_BATCH = 32  # its batch at 512^2
F32_TRAIN_STEPS = 3
F32_MODES = (False, "hybrid", True, "mlp", "block")  # False first: PyTorch's own ops, the yardstick
F32_TRAIN_PATHS = {"hybrid": "train_step", True: "train_step_dwconv", "mlp": "train_step_mlp",
                   "block": "train_step_block"}
F32_GRAD_MODES = ("hybrid", True, "mlp", "block", "mlp_no_layer_scale")
F32_PROB_TOL = 1e-3
F32_COORD_TOL = 1e-4


def _f32_args(gen, batch: int, hw: int, c: int, device) -> tuple:
    """(x, k49, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma), g: f32,
    LayerScale about 1 so that the MLP shows."""
    import torch

    f32 = torch.float32
    x = _rand(gen, (batch, hw, hw, c), 1.0, device, f32)
    args = (x, _rand(gen, (49, c), 0.1, device, f32), _rand(gen, (c,), 0.1, device, f32),
            _rand(gen, (c,), 0.1, device, f32, 1.0), _rand(gen, (c,), 0.1, device, f32),
            _rand(gen, (4 * c, c), c ** -0.5, device, f32), _rand(gen, (4 * c,), 0.1, device, f32),
            _rand(gen, (c, 4 * c), (4 * c) ** -0.5, device, f32),
            _rand(gen, (c,), 0.1, device, f32), _rand(gen, (c,), 0.1, device, f32, 1.0))
    return args, _rand(gen, (batch, hw, hw, c), 1.0, device, f32)


def _f32_check(what: str, names, got, want) -> float:
    """Each output within F32_REL_TOL * max |plain|; the largest error."""
    import torch

    torch.cuda.synchronize()
    errs = []
    for name, a, b in zip(names, got, want):
        if a.dtype != torch.float32 or a.shape != b.shape:
            raise AssertionError(f"{what} {name}: {a.dtype} {tuple(a.shape)}, want f32 "
                                 f"{tuple(b.shape)}")
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        if not err <= F32_REL_TOL * scale:
            raise AssertionError(f"{what} {name} disagrees with its plain f32 version: "
                                 f"{err:.4g} > {F32_REL_TOL} * {scale:.4g}")
        errs.append(err)
    print(f"[f32] {what}: max_abs_err " + " ".join(f"{n}={e:.3g}" for n, e in zip(names, errs))
          + f" (tol {F32_REL_TOL}*max|plain| each) ok")
    return max(errs)


def f32_kernel_phase(device, report: dict) -> None:
    """Each f32 form at its main-path shapes against its plain f32 version,
    timed beside the plain version, one PyTorch call of the same function
    (TF32 off) and the bound (the products as 3xTF32 work, ``simt_bound_ms``
    at the f32 rate beside it): #1 at the study graph's (B16),
    its emit_conv form, #7, #5, #8/#9, #6 and #10 at the train step's (B32),
    #5 also at its path's, the LayerScale-free gradient check's (B2). Rows go
    into ``report`` under each kernel's name + "_f32" (#5's of its path)."""
    import torch
    import torch.nn.functional as F

    from spine_vision_torch.ops import block_train as bt
    from spine_vision_torch.ops import convnext_block as cb
    from spine_vision_torch.ops import fused_mlp as fm

    gen = torch.Generator(device=device).manual_seed(21)
    saved = _counts()
    rows = {f"{k}_f32": [] for k in F32_TWINS}

    def leaves(ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    for hw, c, count in BLOCK_SHAPES:
        args, g = _f32_args(gen, BATCH, hw, c, device)
        x, k49, dwb, ls, lb, w1t, b1, w2t, b2, gamma = args
        m, weights = BATCH * hw * hw, (8 * c * c + 49 * c + 10 * c) * 4
        err = _f32_check(f"convnext_block f32 B={BATCH} {hw}x{hw} C={c}", ("out",),
                         (cb.convnext_block(*args),), (cb.block_reference(*args),))
        k_oihw, x_nchw = k49.t().reshape(c, 1, 7, 7).contiguous(), x.permute(0, 3, 1, 2)

        def library():
            t = F.conv2d(x_nchw, k_oihw, dwb, padding=3, groups=c).permute(0, 2, 3, 1)
            y = F.layer_norm(t, (c,), ls, lb, 1e-6)
            return F.linear(F.gelu(F.linear(y, w1t, b1), approximate="tanh"), w2t, b2) * gamma + x

        rows["convnext_block_f32"].append(_timed_row(
            f"convnext_block f32 C={c}", count, err, lambda: cb.convnext_block(*args),
            lambda: cb.block_reference(*args), library, 2 * m * c * 4 + weights, 0,
            98 * m * c, "per_forward", tf32_flops=16 * m * c * c))
        del args, g, x
        torch.cuda.empty_cache()

    for hw, c, count in BLOCK_SHAPES:
        args, g = _f32_args(gen, TRAIN_BATCH, hw, c, device)
        x, k49, dwb, ls, lb, w1t, b1, w2t, b2, gamma = args
        m, weights = TRAIN_BATCH * hw * hw, (8 * c * c + 49 * c + 10 * c) * 4
        shape = f"B={TRAIN_BATCH} {hw}x{hw} C={c}"
        k_oihw, x_nchw = k49.t().reshape(c, 1, 7, 7).contiguous(), x.permute(0, 3, 1, 2)
        xr, gr = x.reshape(-1, c), g.reshape(-1, c)
        vec = (b1, w2t, b2, gamma)

        # #1's emit_conv form (the hybrid block's forward): out and t.
        got, want = cb.convnext_block(*args, emit_conv=True), cb.block_reference(*args,
                                                                                emit_conv=True)
        err = _f32_check(f"convnext_block emit_conv f32 {shape}", ("out", "t"), got, want)
        del got, want

        def lib_emit():
            t = F.conv2d(x_nchw, k_oihw, dwb, padding=3, groups=c).permute(0, 2, 3, 1)
            y = F.layer_norm(t, (c,), ls, lb, 1e-6)
            return F.linear(F.gelu(F.linear(y, w1t, b1), approximate="tanh"), w2t, b2) * gamma + x, t

        rows["convnext_block_emit_conv_f32"].append(_timed_row(
            f"convnext_block emit_conv f32 C={c}", count, err,
            lambda: cb.convnext_block(*args, emit_conv=True),
            lambda: cb.block_reference(*args, emit_conv=True), lib_emit,
            3 * m * c * 4 + weights, 0, 98 * m * c, "per_train_step", tf32_flops=16 * m * c * c))

        # #7, the LN+MLP rows ("mlp" mode's forward), with x as the residual.
        largs = (xr, ls, lb, w1t, b1, w2t, b2, gamma, gr)
        err = _f32_check(f"ln_mlp f32 {shape}", ("out",), (fm.ln_mlp(*largs),),
                         (fm.ln_mlp_reference(*largs),))

        def lib_ln_mlp():
            y = F.layer_norm(xr, (c,), ls, lb, 1e-6)
            return F.linear(F.gelu(F.linear(y, w1t, b1), approximate="tanh"), w2t, b2) * gamma + gr

        rows["ln_mlp_f32"].append(_timed_row(
            f"ln_mlp f32 C={c}", count, err, lambda: fm.ln_mlp(*largs),
            lambda: fm.ln_mlp_reference(*largs), lib_ln_mlp, 3 * m * c * 4 + weights, 0,
            8 * m * c, "per_train_step", tf32_flops=16 * m * c * c))

        # #5 with its tail (the fused MLP route of blocks without LayerScale
        # runs it with the residual and gamma of ones): printed here, its
        # path's rows below.
        _f32_mlp_fwd_row(xr, w1t, b1, w2t, b2, gamma, gr, shape, count, "blocks_of_this_shape")

        # #8/#9 from t = x, and #6 from y = x.
        names = ("dt", "dls", "dlb", "dw1t", "db1", "dw2t", "db2", "dgamma")
        bargs = (x, ls, lb, w1t, b1, w2t, b2, gamma, g)
        err = _f32_check(f"ln_mlp_bwd f32 {shape}", names, fm.ln_mlp_bwd(*bargs),
                         fm.ln_mlp_bwd_reference(*bargs))
        bl = leaves((x, ls, lb, w1t, b1, w2t, b2, gamma))

        def lib_ln_bwd():
            xx, lsl, lbl, w1l, b1l, w2l, b2l, gml = bl
            y = F.layer_norm(xx, (c,), lsl, lbl, 1e-6)
            o = F.linear(F.gelu(F.linear(y, w1l, b1l), approximate="tanh"), w2l, b2l) * gml
            return torch.autograd.grad(o, bl, g)

        grads = 8 * c * c * 4 + 10 * c * 4
        rows["ln_mlp_bwd_f32"].append(_timed_row(
            f"ln_mlp_bwd f32 C={c}", count, err, lambda: fm.ln_mlp_bwd(*bargs),
            lambda: fm.ln_mlp_bwd_reference(*bargs), lib_ln_bwd,
            3 * m * c * 4 + weights + grads, 0, 35 * m * c, "per_train_step",
            tf32_flops=40 * m * c * c))
        del bl
        mbargs = (x, w1t, b1, w2t, b2, gamma, g)
        err = _f32_check(f"mlp_bwd f32 {shape}", ("dy", "dw1t", "db1", "dw2t", "db2", "dgamma"),
                         fm.mlp_bwd(*mbargs), fm.mlp_bwd_reference(*mbargs))
        ml = leaves((x, w1t, b1, w2t, b2, gamma))

        def lib_mlp_bwd():
            xx, w1l, b1l, w2l, b2l, gml = ml
            o = F.linear(F.gelu(F.linear(xx, w1l, b1l), approximate="tanh"), w2l, b2l) * gml
            return torch.autograd.grad(o, ml, g)

        rows["mlp_bwd_f32"].append(_timed_row(
            f"mlp_bwd f32 C={c}", count, err, lambda: fm.mlp_bwd(*mbargs),
            lambda: fm.mlp_bwd_reference(*mbargs), lib_mlp_bwd, 3 * m * c * 4 + weights + grads,
            0, 15 * m * c, "per_train_step", tf32_flops=40 * m * c * c))
        del ml

        # #10, the whole-block backward ("block" mode).
        targs = (*args, g)
        err = _f32_check(f"block_train_bwd f32 {shape}",
                         ("g_u", "dk", "ddwb", "dls", "dlb", "dw1t", "db1", "dw2t", "db2",
                          "dgamma"), bt.block_train_bwd(*targs), bt.block_train_bwd_reference(*targs))
        tl = leaves((x, k49, dwb, ls, lb, w1t, b1, w2t, b2, gamma))

        def lib_block_bwd():
            xx, kl, dl, lsl, lbl, w1l, b1l, w2l, b2l, gml = tl
            t = F.conv2d(xx.permute(0, 3, 1, 2), kl.t().reshape(c, 1, 7, 7), dl, padding=3,
                         groups=c).permute(0, 2, 3, 1)
            y = F.layer_norm(t, (c,), lsl, lbl, 1e-6)
            o = F.linear(F.gelu(F.linear(y, w1l, b1l), approximate="tanh"), w2l, b2l) * gml
            return torch.autograd.grad(o, tl[1:], g)

        rows["block_train_bwd_f32"].append(_timed_row(
            f"block_train_bwd f32 C={c}", count, err, lambda: bt.block_train_bwd(*targs),
            lambda: bt.block_train_bwd_reference(*targs), lib_block_bwd,
            3 * m * c * 4 + weights + grads + 50 * c * 4, 0,
            2 * 98 * m * c + 35 * m * c, "per_train_step", tf32_flops=40 * m * c * c))
        del tl, args, g, x, xr, gr, targs, bargs, mbargs, largs
        torch.cuda.empty_cache()
    for hw, c, count in GRAD_BLOCK_SHAPES:  # #5's path: the gradient check without LayerScale
        args, g = _f32_args(gen, GRAD_BATCH, hw, c, device)
        x, _, _, _, _, w1t, b1, w2t, b2, gamma = args
        rows["mlp_fwd_f32"].append(_f32_mlp_fwd_row(
            x.reshape(-1, c), w1t, b1, w2t, b2, gamma, g.reshape(-1, c),
            f"B={GRAD_BATCH} {hw}x{hw} C={c}", count, "per_grad_check_step"))
    _set_counts(saved)
    report.update(rows)


def _f32_mlp_fwd_row(x, w1t, b1, w2t, b2, gamma, res, shape: str, count: int,
                     per: str) -> tuple:
    """#5 in f32 with its tail on the rows ``x`` against its plain version,
    timed: the report row."""
    import torch.nn.functional as F

    from spine_vision_torch.ops import fused_mlp as fm

    m, c = x.shape
    args = (x, w1t, b1, w2t, b2, gamma, res)
    err = _f32_check(f"mlp_fwd f32 {shape}", ("out",), (fm.mlp_fwd(*args),),
                     (fm.mlp_reference(*args),))

    def library():
        return F.linear(F.gelu(F.linear(x, w1t, b1), approximate="tanh"), w2t, b2) * gamma + res

    return _timed_row(f"mlp_fwd f32 {shape}", count, err, lambda: fm.mlp_fwd(*args),
                      lambda: fm.mlp_reference(*args), library,
                      3 * m * c * 4 + (8 * c * c + 6 * c) * 4, 0, 0, per,
                      tf32_flops=16 * m * c * c)


def f32_train_check(device, card: str) -> dict:
    """ConvNeXt-base localization at 512^2 through LocalizationTrainer with
    mixed_precision=False, F32_TRAIN_STEPS steps on fixed batches (no
    augmentation or dropout) in each of F32_MODES from the same seeded
    weights: each step's launches, each mode's losses within F32_LOSS_TOL of
    PyTorch's own ops (use_pallas=False), step p50 and peak memory. Returns
    one step's launch counts by path ("f32_" + the bf16 path's name)."""
    import numpy as np
    import torch

    from spine_vision_torch.data.loader import collate_localization
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    data = _Images(F32_TRAIN_BATCH * F32_TRAIN_STEPS, F32_TRAIN_HW, 41, shade=True)
    batches = [collate_localization([data[i] for i in range(k * F32_TRAIN_BATCH,
                                                             (k + 1) * F32_TRAIN_BATCH)])
               for k in range(F32_TRAIN_STEPS)]
    losses, paths = {}, {}
    for mode in F32_MODES:
        run = RUN_DIR / "f32_train"
        shutil.rmtree(run, ignore_errors=True)
        cfg = LocalizationConfig(
            backbone="convnext_base", image_size=(F32_TRAIN_HW, F32_TRAIN_HW),
            batch_size=F32_TRAIN_BATCH, num_epochs=1, augment=False, dropout=0.0,
            mixed_precision=False, output_path=run,
            num_workers=1, pretrained=False, seed=0, use_pallas_dwconv=mode is True,
        )
        trainer = LocalizationTrainer(
            cfg, model=_regressor(device, seed=6, dropout=0.0, use_pallas=mode,
                                  dtype=torch.float32),
            train_dataset=data, val_dataset=data, device=device)
        want = _f32_twins(TRAIN_LAUNCHES[F32_TRAIN_PATHS[mode]]) if mode is not False \
            else _launches()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        times, losses[mode] = [], []
        for k, batch in enumerate(batches):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            losses[mode].append(float(trainer.train_step_fn(trainer.state, batch)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts = _counts()
            if counts != want:
                raise AssertionError(f"f32 train {mode!r} step {k}: launches {counts}, "
                                     f"expected {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[mode], losses[False])]
        print(f"[f32_train] use_pallas={mode!r}: ConvNeXt-base {F32_TRAIN_HW}^2 b{F32_TRAIN_BATCH} f32, "
              f"{F32_TRAIN_STEPS} steps: losses {losses[mode]}, relative to use_pallas=False "
              f"{[f'{r:.3g}' for r in rel]} (tol {F32_LOSS_TOL}); step p50 "
              f"{float(np.percentile(times[1:], 50)):.3f} ms (steps ms "
              f"{[round(t, 3) for t in times]}; the first allocates); peak "
              f"{peak:.2f} GiB; on {card}")
        if not all(np.isfinite(losses[mode])) or max(rel) > F32_LOSS_TOL:
            raise AssertionError(f"f32 train {mode!r}: losses {losses[mode]} against "
                                 f"{losses[False]}")
        if mode is not False:
            paths[f"f32_{F32_TRAIN_PATHS[mode]}"] = counts
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(run, ignore_errors=True)
    return paths


def f32_cls_check(device) -> dict:
    """One f32 step of a ConvNeXt-base Classifier (use_pallas="hybrid", built
    by the trainer from its seed, mixed_precision=False) through
    ClassificationTrainer at batch 8, 256^2: #1's emit_conv form and #8/#9 in
    f32 on each block of C <= 512, a finite loss. Returns its launch
    counts."""
    import math

    from spine_vision_torch.data.loader import collate_classification
    from spine_vision_torch.train.classification import ClassificationTrainer

    cfg = _cls_config("cls_convnext_f32", backbone="convnext_base", batch_size=8, num_epochs=1,
                      num_workers=1, mixed_precision=False)
    data = _Grades(8, CLS_HW, 37)
    trainer = ClassificationTrainer(cfg, train_dataset=data, val_dataset=data, device=device)
    batch = collate_classification([data[i] for i in range(8)])
    _zero_counts()
    loss = float(trainer.train_step_fn(trainer.state, batch))
    counts = _counts()
    shutil.rmtree(RUN_DIR / "cls_convnext_f32", ignore_errors=True)
    want = _f32_twins(CLS_CONVNEXT_LAUNCHES)
    print(f"[f32_cls] ConvNeXt-base Classifier (hybrid) f32 step: loss {loss:.6f}, launches "
          f"{counts}")
    if counts != want or not math.isfinite(loss):
        raise AssertionError(f"f32 cls step: loss {loss}, launches {counts}, expected {want}")
    return counts


def _f32_study_models(pool) -> tuple:
    """The f32 study graph's models (ConvNeXt-base localization, ResNet-18
    grading, seeded trees) on the host, the 8 studies, and their run through
    the pipeline on the CPU, started on ``pool`` (the card's work goes on
    meanwhile): ``(loc, cls, studies, config, future of (results,
    seconds))``."""
    import torch

    from spine_vision_torch.infer.pipeline import StudyInferencePipeline, StudyPipelineConfig
    from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables

    f32 = torch.float32
    with torch.device("meta"):
        loc = CoordinateRegressor("convnext_base", dtype=f32, device="meta")
        cls = Classifier("resnet18", dtype=f32, device="meta")
    loc, cls = loc.to_empty(device="cpu"), cls.to_empty(device="cpu")
    for model, seed in ((loc, 0), (cls, 1)):
        params, stats = random_flax_variables(model, seed)
        load_flax_variables(model, params, stats)
    studies, cfg = _studies(8, 0), StudyPipelineConfig(padded_hw=(768, 768))
    cpu_pipe = StudyInferencePipeline(copy.deepcopy(loc), copy.deepcopy(cls), config=cfg,
                                      device="cpu")

    def cpu_run():
        t0 = time.perf_counter()
        return cpu_pipe.run(studies, fetch_crops=False), time.perf_counter() - t0

    return loc, cls, studies, cfg, pool.submit(cpu_run)


def f32_study_check(device, loc, cls, studies, cfg, cpu_future) -> dict:
    """StudyInferencePipeline on f32 models (``_f32_study_models``) on the 8
    studies on the card against the same pipeline on the CPU: coordinates
    within F32_COORD_TOL, probabilities within F32_PROB_TOL, the same grades
    but where the CPU's two largest probabilities lie within F32_PROB_TOL of
    each other; #1 (f32) 33 and #2 3 launches a forward. Returns the launch
    counts of a forward."""
    import numpy as np

    from spine_vision_torch.core.tasks import get_tasks
    from spine_vision_torch.infer.pipeline import StudyInferencePipeline

    tasks = get_tasks()
    pipe = StudyInferencePipeline(loc, cls, config=cfg, device=device)
    pipe.run(studies, fetch_crops=False)  # warm
    _zero_counts()
    got = pipe.run(studies, fetch_crops=False)
    counts = _counts()
    expected = _f32_twins(INFERENCE_LAUNCHES)
    if counts != expected:
        raise AssertionError(f"f32 study inference: launches {counts}, expected {expected}")
    _check_results(got, len(studies), tasks)
    want, cpu_s = cpu_future.result()
    coord = max(float(np.abs(a.coords - b.coords).max()) for a, b in zip(got, want))
    prob, flips, ties = 0.0, 0, 0
    for a, b in zip(got, want):
        for t in tasks:
            pa, pb = a.probabilities[t.name], b.probabilities[t.name]
            prob = max(prob, float(np.abs(pa - pb).max()))
            if pb.shape[-1] == 1:  # a binary task: the classes' probabilities 1 - p and p
                pb = np.concatenate([1 - pb, pb], axis=-1)
            top2 = np.sort(pb, axis=-1)[..., -2:]
            near = (top2[..., 1] - top2[..., 0]) <= F32_PROB_TOL
            off = a.predictions[t.name] != b.predictions[t.name]
            ties += int(np.sum(off & near))
            flips += int(np.sum(off & ~near))
    print(f"[f32_study] {len(studies)} studies, f32, card vs CPU ({cpu_s:.1f} s on the CPU): coords "
          f"max_abs_err={coord:.4g} (tol {F32_COORD_TOL}), probabilities max_abs_err={prob:.4g} "
          f"(tol {F32_PROB_TOL}), grades apart {flips} (+{ties} at CPU near-ties); launches "
          f"a forward {counts}")
    if coord > F32_COORD_TOL or prob > F32_PROB_TOL or flips:
        raise AssertionError("f32 study inference: the card and the CPU disagree")
    return counts


def f32_phase(device, card: str) -> dict:
    """The f32 forms on their paths (``--f32-only``, and in the whole run):
    the gradient check in every mode, full-width training in every mode, a
    Classifier step and study inference, whose CPU reference runs on a
    thread beside the rest. Returns the launch counts by path."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    paths = {}
    with ThreadPoolExecutor(1) as pool:
        study = _f32_study_models(pool)
        for mode in F32_GRAD_MODES:
            counts = grad_check(device, mode, torch.float32)
            if mode == "mlp_no_layer_scale":
                paths["f32_grad_check_mlp_no_layer_scale"] = counts
        paths.update(f32_train_check(device, card))
        paths["f32_cls_convnext_hybrid"] = f32_cls_check(device)
        paths["f32_study_inference"] = f32_study_check(device, *study)
    return paths


# The quality-parity suite (``spine_vision_torch/utils/parity.py``) at
# run_parity's defaults for the seeds of PARITY_SEEDS.json's tpu/flax records,
# the port's one BatchNorm and pool pair.
PARITY_SEEDS = (0, 1)
PARITY_REFERENCE = Path(__file__).resolve().parent / "PARITY_SEEDS.json"
# The gates every tpu/flax reference record passes (e2e_rotated_pass holds
# e2e_rotated_materially_differs).
PARITY_GATES = ("loc_pass", "e2e_pass", "e2e_auc_defined", "e2e_rotated_pass")
PARITY_SHOWN = ("loc_med", "cls_f1", "cls_macro_auc", "e2e_loc_med", "e2e_grade_accuracy",
                "e2e_rotated_grade_accuracy", "e2e_pfirrmann_macro_auc", "e2e_herniation_auc",
                "e2e_rotated_mean_abs_angle_deg", "e2e_crop_mode_mean_abs_pixel_delta")


def parity_phase(device, card: str, seeds=PARITY_SEEDS) -> dict:
    """``run_parity`` on the card at its defaults (96 localization images, 120
    patients, 24 held-out studies, 14 + 16 epochs of ResNet-18 in f32) for
    each of ``seeds``; each record printed beside the reference's record for
    the same seed and BatchNorm/pool pair (``PARITY_SEEDS.json``, a data file
    of the repo; seeds 0 and 1 have one), with the seed's wall time.

    Raises unless both trained models' parameters lie on the card, the
    record has the reference's keys, and every gate of PARITY_GATES passes:
    the gates every tpu/flax reference record passes. ``cls_pass`` and
    ``all_pass`` are printed, not asserted: the reference's own seed 0 fails
    ``cls_pass`` at F1 0.8129, so the 0.85 bar lies inside the band the
    seeds span. Returns the launch counts of the seeds' runs (ResNet-18 and
    the crop run no kernel of this package: all zero)."""
    from spine_vision_torch.utils import parity

    refs = {r["seed"]: r for r in json.loads(PARITY_REFERENCE.read_text())["records"]
            if (r["norm_impl"], r["pool_impl"]) == ("tpu", "flax")}
    keys = set(refs[PARITY_SEEDS[0]]) - {"runtime_s"}
    trainers: list = []

    def recorded(cls):
        class Recorded(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                trainers.append(self)
        Recorded.__name__ = cls.__name__
        return Recorded

    originals = parity.LocalizationTrainer, parity.ClassificationTrainer
    parity.LocalizationTrainer, parity.ClassificationTrainer = map(recorded, originals)
    counts = dict.fromkeys(KERNEL_COUNTERS, 0)
    failures = []
    try:
        for seed in seeds:
            tag = f"[parity seed {seed}]"
            out = RUN_DIR / f"parity_{seed}"
            shutil.rmtree(out, ignore_errors=True)
            trainers.clear()
            _zero_counts()
            t0 = time.perf_counter()
            record = parity.run_parity(out, seed=seed, device=device)
            wall = time.perf_counter() - t0
            for name, n in _counts().items():
                counts[name] += n
            ref = refs.get(seed, {})
            print(f"{tag} port record: {json.dumps(record)}")
            print(f"{tag} reference record (PARITY_SEEDS.json, tpu/flax): "
                  f"{json.dumps(ref) if ref else 'none for this seed'}")
            print(f"{tag} wall {wall:.1f} s on {card}; port vs reference: " + ", ".join(
                f"{k} {record[k]:.4f} / {ref.get(k, float('nan')):.4f}" for k in PARITY_SHOWN))
            print(f"{tag} gates {', '.join(f'{g} {record[g]}' for g in PARITY_GATES)}; "
                  f"printed only: cls_pass {record['cls_pass']} (reference "
                  f"{ref.get('cls_pass')}), all_pass {record['all_pass']} (reference "
                  f"{ref.get('all_pass')})")
            off_card = [type(t).__name__ for t in trainers
                        if any(p.device.type != "cuda" for p in t.model.parameters())]
            if len(trainers) != 2 or off_card:
                failures.append(f"seed {seed}: {len(trainers)} trainers, parameters off the "
                                f"card in {off_card}")
            if set(record) != keys:
                failures.append(f"seed {seed}: keys differ from the reference's: "
                                f"{sorted(set(record) ^ keys)}")
            failed = [g for g in PARITY_GATES if record[g] is not True]
            if failed:
                failures.append(f"seed {seed}: gates failed {failed}")
            shutil.rmtree(out, ignore_errors=True)
    finally:
        parity.LocalizationTrainer, parity.ClassificationTrainer = originals
    if failures:
        raise AssertionError("parity: " + "; ".join(failures))
    if any(counts.values()):
        raise AssertionError(f"parity launched a kernel of the package: {counts}")
    return counts


# The file_backed phase: the flow a user runs, from a data directory of PNGs
# to checkpoints to inference from them.
FILE_IMAGES = 80  # localization PNGs: 60 train, 16 val, 4 test
FILE_HW = 512
FILE_BACKBONE = "convnext_base"
FILE_BATCH = 16
FILE_CLS_HW = 256  # ClassificationConfig's crop size
FILE_CLS_PATIENTS = 12  # x 5 levels x (T1, T2) gray 256^2 crops
LEVELS = ("L1/L2", "L2/L3", "L3/L4", "L4/L5", "L5/S1")
# Row filters by image: Paeth, Paeth, Sub, then the encoder's own choice.
FILE_FILTERS = (4, 4, 1, None)
# #1's P and #8/#9's LayerNorm-form stages, as the Chrome trace names them.
TRACE_KERNELS = {"#1": ("block_prologue<",), "#8/#9": ("bwd_rows<", "ln_rows_bwd<")}


def _write_loc_dir(root: Path, n: int, hw: int, seed: int) -> None:
    """Seeded synthetic sagittal slices as gray PNGs (the port's encoder):
    noise with a bright disc at each annotated level centre, and
    ``annotations.csv``; about one level in ten unannotated."""
    import numpy as np

    from spine_vision_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    yy, xx = np.mgrid[0:hw, 0:hw]
    rows = ["image_path,level,relative_x,relative_y,series_type,source"]
    for i in range(n):
        img = rng.integers(0, 96, (hw, hw), dtype=np.uint8)
        name = f"images/slice_{i:03d}.png"
        for level in LEVELS:
            x, y = rng.uniform(0.2, 0.8, 2)
            img[(yy - y * hw) ** 2 + (xx - x * hw) ** 2 < (hw / 40) ** 2] = 255
            if rng.uniform() > 0.1:
                rows.append(f"{name},{level},{x:.6f},{y:.6f},sag_t{1 + i % 2},synth")
        write_png(root / name, img, FILE_FILTERS[i % len(FILE_FILTERS)])
    (root / "annotations.csv").write_text("\n".join(rows) + "\n")


def _write_cls_dir(root: Path, n_patients: int, hw: int, seed: int) -> None:
    """Gray PNG crops of T1 and T2 for each patient and level, with all 8
    label columns, as the classification builder writes them."""
    import numpy as np

    from spine_vision_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    rows = ["image_path,patient_id,ivd_level,series_type,source,pfirrmann_grade,"
            "disc_herniation,disc_narrowing,disc_bulging,spondylolisthesis,modic,"
            "up_endplate,low_endplate"]
    for p in range(n_patients):
        for level in range(1, 6):
            labels = [rng.integers(1, 6), *rng.integers(0, 2, 4), rng.integers(0, 4),
                      *rng.integers(0, 2, 2)]
            for series in ("sag_t1", "sag_t2"):
                name = f"images/synth_p{p:02d}_{series}_L{level}.png"
                write_png(root / name, rng.integers(0, 256, (hw, hw), dtype=np.uint8))
                rows.append(",".join(map(str, [name, f"p{p:02d}", level, series, "synth",
                                               *labels])))
    (root / "annotations.csv").write_text("\n".join(rows) + "\n")


def _timm_convnext_state_dict(seed: int, depths, dims) -> dict:
    """A seeded ConvNeXt v1 state dict under timm's names (``stem.N``,
    ``stages.N.downsample.N``, ``stages.N.blocks.N.{conv_dw,norm,mlp.fc1,
    mlp.fc2,gamma}``, ``head.norm``, ``head.fc``)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rand(*shape, scale=0.02, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    def ln(prefix, c):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = rand(c, shift=1.0), rand(c)

    sd["stem.0.weight"], sd["stem.0.bias"] = rand(dims[0], 3, 4, 4, scale=0.1), rand(dims[0])
    ln("stem.1", dims[0])
    for s, (depth, c) in enumerate(zip(depths, dims)):
        if s:
            ln(f"stages.{s}.downsample.0", dims[s - 1])
            sd[f"stages.{s}.downsample.1.weight"] = rand(c, dims[s - 1], 2, 2)
            sd[f"stages.{s}.downsample.1.bias"] = rand(c)
        for b in range(depth):
            p = f"stages.{s}.blocks.{b}"
            sd[f"{p}.conv_dw.weight"], sd[f"{p}.conv_dw.bias"] = rand(c, 1, 7, 7, scale=0.1), rand(c)
            ln(f"{p}.norm", c)
            sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = rand(4 * c, c), rand(4 * c)
            sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = rand(c, 4 * c), rand(c)
            sd[f"{p}.gamma"] = rand(c, shift=0.1)
    ln("head.norm", dims[-1])
    sd["head.fc.weight"], sd["head.fc.bias"] = rand(1000, dims[-1]), rand(1000)
    return sd


def _torchvision_resnet18_state_dict(seed: int) -> dict:
    """A seeded state dict under torchvision's ``resnet18()`` names."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rand(*shape, scale=0.05):
        return torch.randn(*shape, generator=g) * scale

    def bn(prefix, c):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = 1 + rand(c), rand(c)
        sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = rand(c), 1 + rand(c).abs()
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    sd["conv1.weight"] = rand(64, 3, 7, 7)
    bn("bn1", 64)
    cin = 64
    for s, c in enumerate((64, 128, 256, 512)):
        for b in range(2):
            p = f"layer{s + 1}.{b}"
            sd[f"{p}.conv1.weight"] = rand(c, cin if b == 0 else c, 3, 3)
            bn(f"{p}.bn1", c)
            sd[f"{p}.conv2.weight"] = rand(c, c, 3, 3)
            bn(f"{p}.bn2", c)
            if b == 0 and s:
                sd[f"{p}.downsample.0.weight"] = rand(c, cin, 1, 1)
                bn(f"{p}.downsample.1", c)
        cin = c
    sd["fc.weight"], sd["fc.bias"] = rand(1000, 512), rand(1000)
    return sd


class _LogRecords(logging.Handler):
    """The package logger's messages while attached (at INFO)."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.messages: list = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger = logging.getLogger("spine_vision_torch")
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def _trees_equal(got: dict, want: dict) -> bool:
    import numpy as np

    if set(got) != set(want):
        return False
    return all(_trees_equal(g, want[k]) if isinstance(g, dict)
               else np.array_equal(np.asarray(g), np.asarray(want[k])) for k, g in got.items())


def file_backed_phase(device, card: str) -> dict:
    """Train from files, then serve from the checkpoints (``file_backed``).

    A localization directory of 80 gray 512^2 PNGs (the port's encoder, most
    rows Paeth or Sub) and a seeded timm-named ConvNeXt-base ``.pth``
    converted to ``.npz``; ``LocalizationTrainer`` from that directory (b16,
    2 epochs, hybrid block, bf16) with ``pretrained_path``,
    ``sample_cache_dir`` and ``profile_trace``, then ``evaluate()`` on the test
    split from disk; a second trainer reusing the cache; host input rates;
    ResNet-18 ``ClassificationTrainer`` from a directory of 256^2 crops with a
    torchvision-named ``.pth``; ``StudyInferencePipeline.from_checkpoints`` of
    both runs in both crop modes, bit for bit against a pipeline over the
    trainers' in-memory models. Returns the launch counts of the main path
    (both training runs, ``evaluate`` and the two inference runs)."""
    import math

    import numpy as np
    import torch

    from spine_vision_torch.core.tasks import get_tasks
    from spine_vision_torch.data.cache import PackedDataset
    from spine_vision_torch.data.datasets import PngStore
    from spine_vision_torch.infer.pipeline import StudyInferencePipeline, StudyPipelineConfig
    from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor
    from spine_vision_torch.models.convert import (
        convert_checkpoint,
        export_flax_variables,
        load_backbone_npz,
        load_pretrained_backbone,
    )
    from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS
    from spine_vision_torch.train import trainer as trainer_mod
    from spine_vision_torch.train.classification import ClassificationConfig, ClassificationTrainer
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    tag = "[file_backed]"
    root = RUN_DIR / "file_backed"
    shutil.rmtree(root, ignore_errors=True)
    total = dict.fromkeys(KERNEL_COUNTERS, 0)

    def add_counts() -> None:
        for name, n in _counts().items():
            total[name] += n

    t0 = time.perf_counter()
    _write_loc_dir(root / "loc", FILE_IMAGES, FILE_HW, seed=20)
    print(f"{tag} wrote {FILE_IMAGES} {FILE_HW}^2 PNGs + annotations.csv in "
          f"{time.perf_counter() - t0:.2f} s")
    cn = CONVNEXT_CONFIGS[FILE_BACKBONE]
    pth, npz = root / f"{FILE_BACKBONE}.pth", root / f"{FILE_BACKBONE}.npz"
    t0 = time.perf_counter()
    torch.save(_timm_convnext_state_dict(21, cn.depths, cn.dims), pth)
    t1 = time.perf_counter()
    convert_checkpoint(pth, FILE_BACKBONE, npz)
    print(f"{tag} timm-named {FILE_BACKBONE} .pth saved in {t1 - t0:.2f} s, converted to .npz "
          f"({npz.stat().st_size / 2**20:.1f} MiB) in {time.perf_counter() - t1:.2f} s")
    converted, _, arch = load_backbone_npz(npz)
    if arch != FILE_BACKBONE:
        raise AssertionError(f"the .npz records arch {arch!r}")

    # Time the cache build inside the trainer.
    build_s: list = []
    packed_view = trainer_mod.packed_view

    def timed_packed_view(*args, **kwargs):
        start = time.perf_counter()
        out = packed_view(*args, **kwargs)
        build_s.append(time.perf_counter() - start)
        return out

    def loc_trainer(name: str, epochs: int, **kw):
        cfg = LocalizationConfig(
            data_path=root / "loc", backbone=FILE_BACKBONE, image_size=(FILE_HW, FILE_HW),
            batch_size=FILE_BATCH, num_epochs=epochs, output_path=root / name, num_workers=8,
            sample_cache_dir=root / "cache", pretrained=False, profile_steps=True, seed=0, **kw)
        return LocalizationTrainer(cfg, device=device)

    def counted(trainer, step_counts: list, epoch_s: list) -> None:
        """Record each train step's launches (a difference of the counts,
        which keep running over the validation passes) and each epoch's
        training wall time."""
        inner_step, inner_epoch = trainer.train_step_fn, trainer._train_epoch

        def step(state, batch):
            start = _counts()
            loss = inner_step(state, batch)
            step_counts.append({k: n - start[k] for k, n in _counts().items()})
            return loss

        def epoch():
            start = time.perf_counter()
            out = inner_epoch()
            epoch_s.append(time.perf_counter() - start)
            return out

        trainer.train_step_fn, trainer._train_epoch = step, epoch

    trainer_mod.packed_view = timed_packed_view
    try:
        with _LogRecords() as log:
            t0 = time.perf_counter()
            first = loc_trainer("run1", 2, pretrained_path=npz, profile_trace=True)
            init_s = time.perf_counter() - t0
    finally:
        trainer_mod.packed_view = packed_view
    built = [m for m in log.messages if m.startswith("Packed ")]
    print(f"{tag} trainer built in {init_s:.2f} s, of which the cache build (train, val) "
          f"{[round(b, 3) for b in build_s]} s: {built}")
    if len(built) != 2 or not (root / "cache" / "train" / "index.json").exists():
        raise AssertionError(f"the first run did not build the cache: {log.messages}")
    if not any(m.startswith("Loaded pretrained backbone weights") for m in log.messages):
        raise AssertionError("the pretrained backbone was not logged as loaded")
    before, _ = export_flax_variables(first.model.backbone)
    if not _trees_equal(before, converted):
        raise AssertionError("the backbone differs from the converted weights before training")
    step_counts: list = []
    epoch_s: list = []
    counted(first, step_counts, epoch_s)
    _zero_counts()
    t0 = time.perf_counter()
    result = first.train()
    wall = time.perf_counter() - t0
    add_counts()
    want = TRAIN_LAUNCHES["train_step"]
    if len(step_counts) != 2 * (60 // FILE_BATCH) or any(c != want for c in step_counts):
        raise AssertionError(f"train steps {len(step_counts)}, launches {step_counts}; "
                             f"expected 6 steps of {want}")
    for key in ("train_loss", "val_loss", "med"):
        if not all(math.isfinite(v) for v in result.history[key]):
            raise AssertionError(f"history[{key!r}] = {result.history[key]}")
    after, _ = export_flax_variables(first.model.backbone)
    if _trees_equal(after, converted):
        raise AssertionError("training did not move the pretrained backbone")
    trace = root / "run1" / "logs" / "profile" / "trace.json"
    if not trace.exists():
        raise AssertionError("profile_trace wrote no trace under logs/profile")
    names = {e.get("name", "").replace(" ", "")
             for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "kernel"}
    for label, parts in TRACE_KERNELS.items():
        if not any(p in n for n in names for p in parts):
            raise AssertionError(f"the trace names no kernel of {label} {parts}")
    print(f"{tag} run 1: {len(step_counts)} steps, launches a step {step_counts[0]}; "
          f"train {wall:.2f} s; epoch 1 (traced) {epoch_s[0]:.2f} s, epoch 2 {epoch_s[1]:.2f} s "
          f"(each 3 steps with the loader; p50 step {np.percentile(first.step_times, 50) * 1e3:.3f} "
          f"ms); trace {trace.stat().st_size / 2**20:.1f} MiB, {len(names)} kernel names; "
          f"history {result.history['train_loss']}, med {result.history['med']}")
    _zero_counts()
    t0 = time.perf_counter()
    test_metrics = first.evaluate()
    add_counts()
    if not test_metrics or not math.isfinite(test_metrics["med"]):
        raise AssertionError(f"evaluate() from disk: {test_metrics}")
    print(f"{tag} evaluate() on the test split from disk ({len(first.train_dataset)} train "
          f"images cached): med {test_metrics['med']:.4f} in {time.perf_counter() - t0:.2f} s")

    with _LogRecords() as log:
        second = loc_trainer("run2", 1)
    reused = [m for m in log.messages if m.startswith("Reusing packed sample cache")]
    if any(m.startswith("Packed ") for m in log.messages) or len(reused) != 2:
        raise AssertionError(f"the second run did not reuse the cache: {log.messages}")
    step_counts2: list = []
    epoch_s2: list = []
    counted(second, step_counts2, epoch_s2)
    _zero_counts()
    second.train()
    add_counts()
    if any(c != want for c in step_counts2):
        raise AssertionError(f"second run launches {step_counts2}")
    print(f"{tag} run 2 reused the cache ({reused}); its epoch {epoch_s2[0]:.2f} s")

    # Host input rates, one thread each: PNG decode against the cache.
    store = PngStore(root / "loc", "color")
    keys = list(store)
    t0 = time.perf_counter()
    for key in keys:
        store[key]
    png_rate = len(keys) / (time.perf_counter() - t0)
    packed = PackedDataset(root / "cache" / "train")
    order = np.random.default_rng(0).permutation(len(packed))
    t0 = time.perf_counter()
    for _ in range(5):
        for i in range(0, len(order), FILE_BATCH):
            packed.get_batch(order[i:i + FILE_BATCH])
    cache_rate = 5 * len(order) / (time.perf_counter() - t0)
    print(f"{tag} host input, one thread: PNG decode through PngStore {png_rate:.2f} images/s "
          f"({FILE_HW}^2 gray as RGB), packed cache get_batch {cache_rate:.2f} images/s "
          f"(b{FILE_BATCH}, 5 passes over {len(order)}) on {card}")

    t0 = time.perf_counter()
    _write_cls_dir(root / "cls", FILE_CLS_PATIENTS, FILE_CLS_HW, seed=22)
    torch.save(_torchvision_resnet18_state_dict(23), root / "resnet18.pth")
    cls_cfg = ClassificationConfig(
        data_path=root / "cls", backbone="resnet18", batch_size=FILE_BATCH, num_epochs=1,
        output_path=root / "cls_run", num_workers=8, pretrained=False, seed=0,
        output_size=(FILE_CLS_HW, FILE_CLS_HW), pretrained_path=root / "resnet18.pth")
    cls_trainer = ClassificationTrainer(cls_cfg, device=device)
    want_params, want_stats = load_pretrained_backbone(root / "resnet18.pth", "resnet18")
    got_params, got_stats = export_flax_variables(cls_trainer.model.backbone)
    if not (_trees_equal(got_params, want_params) and _trees_equal(got_stats, want_stats)):
        raise AssertionError("the classifier's backbone differs from the converted .pth")
    _zero_counts()
    cls_result = cls_trainer.train()
    cls_metrics = cls_trainer.evaluate()
    add_counts()
    if not math.isfinite(cls_result.history["train_loss"][0]) or "macro_f1" not in cls_metrics:
        raise AssertionError(f"classification from files: {cls_result.history}, {cls_metrics}")
    print(f"{tag} classification from {2 * 5 * FILE_CLS_PATIENTS} {FILE_CLS_HW}^2 PNG crops: "
          f"{len(cls_trainer.train_dataset)} train records, torchvision .pth converted on the "
          f"fly; train_loss {cls_result.history['train_loss']}, test macro_f1 "
          f"{cls_metrics['macro_f1']:.4f}; {time.perf_counter() - t0:.2f} s")

    # Inference from the checkpoints, and from the trainers' models in memory.
    # from_checkpoints' default: the kernels on the card (plain ops on the CPU).
    kw = {"dtype": torch.bfloat16, "device": device,
          "use_pallas": torch.device(device).type == "cuda", "param_dtype": torch.float32}
    mem_loc = CoordinateRegressor(FILE_BACKBONE, **kw)
    mem_loc.load_state_dict(first.model.state_dict())
    mem_cls = Classifier("resnet18", tasks=tuple(get_tasks()), **kw)
    mem_cls.load_state_dict(cls_trainer.model.state_dict())
    studies = _studies(8, 0)
    for mode in ("horizontal", "rotated"):
        cfg = StudyPipelineConfig(padded_hw=(768, 768), crop_mode=mode)
        pipe = StudyInferencePipeline.from_checkpoints(
            root / "run1" / "best_model", root / "cls_run" / "best_model",
            loc_backbone=FILE_BACKBONE, config=cfg, device=device)
        _zero_counts()
        results = pipe.run(studies)
        counts = _counts()
        add_counts()
        if counts != INFERENCE_LAUNCHES:
            raise AssertionError(f"from_checkpoints {mode}: launches {counts}, expected "
                                 f"{INFERENCE_LAUNCHES}")
        _check_results(results, 8, get_tasks())
        memory = StudyInferencePipeline(mem_loc, mem_cls, config=cfg, device=device).run(studies)
        if not _same_results(results, memory):
            raise AssertionError(f"from_checkpoints {mode}: the results differ from the "
                                 "in-memory models' pipeline")
        print(f"{tag} from_checkpoints {mode}: launches {counts}, 8 studies equal bit for bit "
              "to the in-memory models' pipeline")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": total, "png_images_s": png_rate, "cache_images_s": cache_rate}


# The volume_io phase: study inference from volume files in every format the
# port reads, at a clinical lumbar sagittal geometry.
IO_SHAPE = (17, 512, 512)  # (z, y, x): 17 sagittal slices of 512^2
# (x, y, z) mm. 19/32 mm in-plane (a 304 mm field of view) is exact in binary
# and in every format's text, so each file holds the in-memory geometry
# exactly and its middle slice is the in-memory volume's.
IO_SPACING = (0.59375, 0.59375, 4.0)
IO_ORIGIN = (-150.0, -152.0, 34.0)
IO_FORMATS = ("dicom", "dicom", "dicom", "dicom_jpeg_lossless", ".nii.gz", ".nii.gz", ".mha",
              ".nrrd")
# This study's series are tilted 5 degrees about the S axis. A MetaImage
# stores the spacing apart from the direction, so the oblique geometry reads
# back with the exact spacing the slice depends on (a DICOM series derives
# the slice spacing from positions along the normal, 1e-8 mm off).
IO_OBLIQUE = 6
IO_REPS = 5
IO_ULPS = 4  # card vs CPU slices: bit for bit, else within 4 f32 ulps of max |slice|


def _io_direction(oblique: bool):
    """Sagittal: x index along P, y along I, the slice normal (z) along R,
    their cross product as in every DICOM series; optionally tilted 5
    degrees about S."""
    import numpy as np

    sagittal = np.array([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    if not oblique:
        return sagittal
    t = np.deg2rad(5.0)
    tilt = np.array([[np.cos(t), -np.sin(t), 0.0], [np.sin(t), np.cos(t), 0.0], [0.0, 0.0, 1.0]])
    return tilt @ sagittal


def _io_volume(rng, level: float):
    """A seeded int16 series: a smooth in-plane pattern, a ramp across the
    slices and noise."""
    import numpy as np

    d, h, w = IO_SHAPE
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    plane = level + 300.0 * np.sin(y / 40.0) * np.cos(x / 55.0)
    ramp = 20.0 * np.arange(d, dtype=np.float32)[:, None, None]
    vol = plane[None] + ramp + rng.normal(0.0, 80.0, IO_SHAPE).astype(np.float32)
    return np.clip(vol, 0, 4000).astype(np.int16)


def _write_io_study(root: Path, k: int, fmt: str, pair: dict) -> dict:
    from spine_vision_torch.io import write_medical_image
    from spine_vision_torch.io.dicom_write import write_dicom_series

    paths = {}
    for series, image in pair.items():
        if fmt.startswith("dicom"):
            path = root / f"study{k}_{series}"
            write_dicom_series(image, path, jpeg_lossless=fmt == "dicom_jpeg_lossless")
        else:
            path = root / f"study{k}_{series}{fmt}"
            write_medical_image(image, path)
        paths[series] = path
    return paths


def _io_files(tag: str) -> tuple[list, list]:
    """Write the volume_io phase's 8 studies under ``RUN_DIR/volume_io``;
    return their in-memory images and their paths."""
    import numpy as np

    from spine_vision_torch import io as tio

    root = RUN_DIR / "volume_io"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    images, paths = [], []
    write_s = encode_s = 0.0
    for k, fmt in enumerate(IO_FORMATS):
        pair = {series: tio.MedicalImage(array=_io_volume(rng, level), spacing=IO_SPACING,
                                         origin=IO_ORIGIN, direction=_io_direction(k == IO_OBLIQUE))
                for series, level in (("t1", 700.0), ("t2", 500.0))}
        t0 = time.perf_counter()
        paths.append(_write_io_study(root, k, fmt, pair))
        if fmt == "dicom_jpeg_lossless":
            encode_s += time.perf_counter() - t0
        else:
            write_s += time.perf_counter() - t0
        images.append(pair)
    print(f"{tag} wrote {len(IO_FORMATS)} studies x (T1, T2) of {IO_SHAPE} int16 in "
          f"{write_s:.2f} s; study 3's JPEG Lossless DICOM (encode included, left out of the "
          f"timed figures) in {encode_s:.2f} s")
    return images, paths


def _study_models(device) -> tuple:
    """The study phase's graph: ConvNeXt-base localization and ResNet-18
    grading in bf16 from seeded Flax-layout trees (seeds 0 and 1)."""
    import torch

    from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables

    loc = CoordinateRegressor("convnext_base", dtype=torch.bfloat16, device=device)
    cls = Classifier("resnet18", dtype=torch.bfloat16, device=device)
    for model, seed in ((loc, 0), (cls, 1)):
        params, stats = random_flax_variables(model, seed)
        load_flax_variables(model, params, stats)
    return loc, cls


def _same_results(got, want) -> bool:
    import numpy as np

    return all(
        np.array_equal(g.coords, w.coords) and np.array_equal(g.angles, w.angles)
        and np.array_equal(g.crops, w.crops)
        and all(np.array_equal(g.logits[k], w.logits[k]) for k in w.logits)
        and all(np.array_equal(g.probabilities[k], w.probabilities[k]) for k in w.logits)
        for g, w in zip(got, want, strict=True))


def volume_io_phase(device, card: str, keep_files: bool = False) -> dict:
    """Study inference from volume files (``--io-only`` runs it alone).

    Eight studies of seeded int16 T1 and T2 series (17 sagittal slices of
    512^2, ``IO_SPACING``, study ``IO_OBLIQUE`` tilted 5 degrees), written by
    the port's writers: studies 0-2 uncompressed DICOM directories, 3 a JPEG
    Lossless SV1 DICOM directory, 4-5 ``.nii.gz``, 6 ``.mha``, 7 ``.nrrd``.
    Checks: (a) every series reads back bit for bit with its geometry;
    (b) ``study_input_from_paths(device="cuda")`` gives each study's slices
    equal to ``extract_isotropic_middle_slice(device="cpu")`` of the
    in-memory volumes (bit for bit, else within ``IO_ULPS`` f32 ulps of max
    |slice|, printed); (c) one study's fast slice on the card against the
    whole-volume ``resample_to_isotropic`` on the card, ``orient("LPI")`` and
    the middle slice, within ``rtol=1e-4, atol=1e-2``; (d)
    ``StudyInferencePipeline.run`` (ConvNeXt-base 512^2 and ResNet-18 256^2,
    bf16, seeded Flax trees) on the 8 studies from files in both crop modes:
    the study phase's launch counts, and results equal bit for bit to a run
    on the slices of the in-memory volumes on the card. Prints, with the
    card's name and power limit, each format's decode ms a series, the C++
    entropy decode ms a slice, the card's middle-slice ms,
    ``study_input_from_paths`` ms a study, and files-to-results ms a study
    in each crop mode (host work included). With ``keep_files``, the files
    stay for the ``serve`` and ``builders`` phases, which the result names
    (``images``, ``paths``) with the graph's two models (``models``)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from spine_vision_torch import io as tio
    from spine_vision_torch import native
    from spine_vision_torch.core.tasks import get_tasks
    from spine_vision_torch.infer.pipeline import (
        StudyInferencePipeline,
        StudyInput,
        StudyPipelineConfig,
        study_input_from_paths,
    )
    from spine_vision_torch.io import jpeg_lossless as jl
    from spine_vision_torch.ops.resample import resample_to_isotropic

    tag = "[volume_io]"
    images, paths = _io_files(tag)

    # (a) Every series reads back as written.
    worst_geometry = 0.0
    decode_ms = {}
    for k, fmt in enumerate(IO_FORMATS):
        for series in ("t1", "t2"):
            got, want = tio.read_medical_image(paths[k][series]), images[k][series]
            if got.array.dtype != np.int16 or not np.array_equal(got.array, want.array):
                raise AssertionError(f"study {k} {series} ({fmt}): the array read back differs")
            for name in ("spacing", "origin", "direction"):
                gap = float(np.abs(np.asarray(getattr(got, name), float)
                                   - np.asarray(getattr(want, name), float)).max())
                worst_geometry = max(worst_geometry, gap)
                if gap > 1e-6:
                    raise AssertionError(f"study {k} {series} ({fmt}): {name} off by {gap}")
        if fmt not in decode_ms:
            decode_ms[fmt] = _host_ms(lambda: tio.read_medical_image(paths[k]["t1"]), IO_REPS)[0]
    print(f"{tag} (a) 16 series in {len(set(IO_FORMATS))} formats read back bit for bit; "
          f"geometry within {worst_geometry:.3g} (the oblique .mha's 6-digit text)")
    print(f"{tag} decode ms a series ({IO_SHAPE[0]} x {IO_SHAPE[1]}^2 int16): "
          + ", ".join(f"{f} {ms:.3f}" for f, ms in decode_ms.items()) + f" on {card}")

    frame = jl.encode_jpeg_lossless(images[3]["t1"].array[IO_SHAPE[0] // 2].view(np.uint16))
    _, scans = jl._parse_markers(frame)
    entropy, luts, ri = scans[0][4], scans[0][5], scans[0][6]
    entropy_ms = _host_ms(lambda: native.jpegls_decode_diffs(
        *native.jpegls_unstuff_split(entropy), luts, ri, IO_SHAPE[1] * IO_SHAPE[2], 1), 10)[0]
    slice_decode_ms = _host_ms(lambda: jl.decode_jpeg_lossless(frame), 10)[0]
    print(f"{tag} JPEG Lossless {IO_SHAPE[1]}^2 16-bit slice ({len(frame)} bytes): C++ entropy "
          f"decode {entropy_ms:.3f} ms, whole decode {slice_decode_ms:.3f} ms on {card}")

    # (b) Slices from files on the card against the in-memory volumes' on the CPU.
    slice_ms = _host_ms(lambda: tio.extract_isotropic_middle_slice(images[0]["t1"],
                                                                     device=device), 10)[0]
    print(f"{tag} card middle slice {slice_ms:.3f} ms a series (host blend, two products, the "
          f"slice back to the host) on {card}")
    cpu_slices = [{s: tio.extract_isotropic_middle_slice(images[k][s], device="cpu")[0]
                   for s in ("t1", "t2")} for k in range(len(IO_FORMATS))]
    side = round(IO_SHAPE[1] * IO_SPACING[1] / 0.3)  # the slice's rows and columns at 0.3 mm
    inputs_ms, worst_ulps = [], 0.0
    for k in range(len(IO_FORMATS)):
        t0 = time.perf_counter()
        study = study_input_from_paths(paths[k]["t1"], paths[k]["t2"], device=device)
        inputs_ms.append((time.perf_counter() - t0) * 1e3)
        for series, got in (("t1", study.t1_slice), ("t2", study.t2_slice)):
            want = cpu_slices[k][series]
            if got.shape != want.shape or got.shape != (side, side):
                raise AssertionError(f"study {k} {series}: slice {got.shape}, want {want.shape}")
            ulps = float(np.abs(got - want).max()) / (np.finfo(np.float32).eps
                                                       * float(np.abs(want).max()))
            worst_ulps = max(worst_ulps, ulps)
            if ulps > IO_ULPS:
                raise AssertionError(f"study {k} {series}: card vs CPU {ulps:.2f} ulps")
    verdict = "bit for bit" if worst_ulps == 0 else f"within {worst_ulps:.3f} f32 ulps of max|slice|"
    print(f"{tag} (b) study_input_from_paths on the card: 16 slices of {side}^2 equal the CPU's "
          f"from the in-memory volumes {verdict}; {float(np.median(inputs_ms)):.3f} ms a study "
          f"(median of 8, two threads) on {card}")

    # (c) The fast slice against the naive whole-volume path, on the card.
    image = images[IO_OBLIQUE]["t1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    volume, new = resample_to_isotropic(image.array, image.spacing_zyx, device=device)
    torch.cuda.synchronize()
    naive_ms = (time.perf_counter() - t0) * 1e3
    iso = replace(image, array=volume.cpu().numpy(), spacing=new[::-1])
    naive = iso.extract_middle_slice()
    fast = tio.extract_isotropic_middle_slice(image, device=device)[0]
    if fast.shape != naive.shape or not np.allclose(fast, naive, rtol=1e-4, atol=1e-2):
        raise AssertionError(f"fast slice {fast.shape} vs naive {naive.shape}: max gap "
                             f"{float(np.abs(fast - naive).max()) if fast.shape == naive.shape else None}")
    print(f"{tag} (c) study {IO_OBLIQUE}: fast slice within rtol 1e-4, atol 1e-2 of the whole "
          f"volume resampled on the card ({tuple(volume.shape)} f32, "
          f"{volume.numel() * 4 / 1e9:.2f} GB, {naive_ms:.1f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB), max gap "
          f"{float(np.abs(fast - naive).max()):.3g}")
    del volume, iso

    # (d) The study graph on the studies from files, both crop modes.
    loc, cls = _study_models(device)
    tasks = get_tasks()
    memory_inputs = [
        StudyInput(
            t1_slice=tio.extract_isotropic_middle_slice(images[k]["t1"], device=device)[0],
            t2_slice=tio.extract_isotropic_middle_slice(images[k]["t2"], device=device)[0],
            t1_spacing=(0.3, 0.3), t2_spacing=(0.3, 0.3), study_id=Path(paths[k]["t2"]).stem)
        for k in range(len(IO_FORMATS))]
    launches, e2e = {}, {}
    for mode in ("horizontal", "rotated"):
        pipe = StudyInferencePipeline(loc, cls, config=StudyPipelineConfig(crop_mode=mode),
                                      device=device)
        memory = pipe.run(memory_inputs)  # also warms the graph
        _check_results(memory, len(IO_FORMATS), tasks)
        _zero_counts()
        from_files = [study_input_from_paths(p["t1"], p["t2"], device=device) for p in paths]
        results = pipe.run(from_files)
        counts = _counts()
        if counts != INFERENCE_LAUNCHES:
            raise AssertionError(f"{mode}: expected {INFERENCE_LAUNCHES} launches, got {counts}")
        _check_results(results, len(IO_FORMATS), tasks)
        if not _same_results(results, memory):
            raise AssertionError(f"{mode}: results from files differ from those from memory")
        if [r.study_id for r in results] != [m.study_id for m in memory_inputs]:
            raise AssertionError(f"{mode}: study ids {[r.study_id for r in results]}")
        launches[mode] = counts
        e2e[mode] = _host_ms(lambda: pipe.run(
            [study_input_from_paths(p["t1"], p["t2"], device=device) for p in paths]),
            IO_REPS)[0] / len(IO_FORMATS)
        print(f"{tag} (d) {mode}: launches {counts}; 8 studies from files equal bit for bit to "
              f"the in-memory slices' run; files to results {e2e[mode]:.3f} ms a study "
              f"(median of {IO_REPS} runs of 8, host work included) on {card}")
    if not keep_files:
        shutil.rmtree(RUN_DIR / "volume_io", ignore_errors=True)
    return {"launches": launches["horizontal"], "files_to_results_ms": e2e,
            "decode_ms": decode_ms, "entropy_ms": entropy_ms, "slice_ms": slice_ms,
            "images": images, "paths": paths, "models": (loc, cls)}


# The serve phase: the directory server over the study graph, on volume_io's
# files (``infer/serve.py``).
SERVE_REPEATS = 4  # each of the 8 studies requested 4 times: 32 requests
SERVE_BATCH = 8


class _RecordingPipeline:
    """A study pipeline whose ``run`` also records each batch's study ids,
    so that the results can be held to ``run`` on the same batches."""

    def __init__(self, pipe) -> None:
        self.pipe, self.batches = pipe, []

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def run(self, studies, fetch_crops: bool = True):
        self.batches.append([s.study_id for s in studies])
        return self.pipe.run(studies, fetch_crops=fetch_crops)


def _serve_requests(watch: Path, paths: list) -> dict:
    """Write the 32 requests (each study under ``SERVE_REPEATS`` new ids)
    and, last, a malformed one; return {study id: series paths}."""
    watch.mkdir(parents=True)
    specs = {}
    for j in range(SERVE_REPEATS):
        for k, pair in enumerate(paths):
            sid = f"study{k}_r{j}"
            specs[sid] = pair
            (watch / f"{sid}.json").write_text(json.dumps(
                {"study_id": sid, "t1": str(pair["t1"]), "t2": str(pair["t2"])}))
    (watch / "malformed.json").write_text(json.dumps({"t1": str(paths[0]["t1"])}))
    return specs


def _serve_outcome(tag: str, watch: Path, specs: dict, stats: list, batches: list) -> None:
    """Every request served once (done/), the malformed one in failed/ with
    its error text, nothing left claimed."""
    processed = sum(s.processed for s in stats)
    served = sorted(sid for s in stats for sid in s.study_ids)
    batched = sorted(sid for b in batches for sid in b)
    if processed != len(specs) or served != sorted(specs) or batched != served:
        raise AssertionError(f"{tag} served {processed}: {served} (batches {batches})")
    if sum(s.failed for s in stats) != 1 or sum(s.batches for s in stats) != len(batches):
        raise AssertionError(f"{tag} failed {[s.failed for s in stats]}, batches "
                             f"{[s.batches for s in stats]} against {len(batches)} recorded")
    done = sorted(p.stem for p in (watch / "done").iterdir())
    error = (watch / "failed" / "malformed.error.txt").read_text()
    if done != sorted(specs) or "must carry 't1' and 't2'" not in error:
        raise AssertionError(f"{tag} done/ {done}; the malformed request's error: {error!r}")
    left = list(watch.glob("*.json")) + list((watch / "inflight").iterdir())
    if not (watch / "failed" / "malformed.json").exists() or left:
        raise AssertionError(f"{tag} requests left in the watch or inflight directory")


def serve_phase(device, card: str, profile: bool = False, io: dict | None = None) -> dict:
    """The directory server (``--serve-only`` runs it alone).

    ``volume_io``'s 8 studies of 17x512^2 int16 files (written anew when run
    alone) and the study phase's weights, horizontal crops: 32 requests
    (each study 4 times under new ids) and a malformed one. (a) One
    ``serve_directory(max_batch=8, once=True)``: every request served once,
    the malformed one in ``failed/`` with its error file, the study phase's
    launch counts a forward, ms a study from the first claim to the last
    result (with ``--profile``, a traced repeat gives the device's busy
    share);
    (b) every result JSON equal to ``run(..., fetch_crops=False)`` of
    ``study_input_from_paths`` of the same files in the same batches; (c)
    two server threads on the one pipeline over the same 32 requests: each
    served exactly once, none re-queued, every result equal to the
    one-server run's, or, where the two runs padded the study's batch to
    another size, to ``run`` on its two-server batch (both counted, and the
    latter's gaps to the one-server run printed)."""
    import threading

    import numpy as np
    import torch

    from spine_vision_torch.infer import serve as tserve
    from spine_vision_torch.infer.pipeline import StudyInferencePipeline, study_input_from_paths

    tag = "[serve]"
    if io is None:
        _, paths = _io_files(tag)
        loc, cls = _study_models(device)
    else:
        paths, (loc, cls) = io["paths"], io["models"]
    root = RUN_DIR / "serve"
    shutil.rmtree(root, ignore_errors=True)
    pipe = StudyInferencePipeline(loc, cls, device=device)
    pipe.run([study_input_from_paths(p["t1"], p["t2"], device=device) for p in paths],
             fetch_crops=False)  # warm the graph at the serve batch

    def reference(batch: list, specs: dict) -> dict:
        studies = [study_input_from_paths(specs[sid]["t1"], specs[sid]["t2"], study_id=sid,
                                          device=device) for sid in batch]
        return {r.study_id: json.dumps(tserve._result_payload(r), indent=2)
                for r in pipe.run(studies, fetch_crops=False)}

    # (a) One server.
    watch, out = root / "one" / "requests", root / "one" / "results"
    specs = _serve_requests(watch, paths)
    rec = _RecordingPipeline(pipe)
    _zero_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    stats = tserve.serve_directory(rec, watch, out, max_batch=SERVE_BATCH, once=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = _counts()
    _serve_outcome(f"{tag} (a)", watch, specs, [stats], rec.batches)
    per_forward = {k: v // stats.batches for k, v in counts.items()}
    if per_forward != INFERENCE_LAUNCHES or any(v % stats.batches for v in counts.values()):
        raise AssertionError(f"{tag} {stats.batches} forwards launched {counts}; expected "
                             f"{INFERENCE_LAUNCHES} a forward")
    ms_study = wall * 1e3 / len(specs)
    print(f"{tag} (a) one server: {len(specs)} requests and a malformed one in "
          f"{stats.batches} batches {[len(b) for b in rec.batches]}, {ms_study:.3f} ms a study "
          f"from the first claim to the last result ({wall:.3f} s); launches "
          f"{ {k: v for k, v in per_forward.items() if v} } a forward on {card}")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        traced = root / "traced" / "requests"
        _serve_requests(traced, paths)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            tserve.serve_directory(pipe, traced, traced.parent / "results",
                                   max_batch=SERVE_BATCH, once=True)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - start
        busy = sum(_dev_us(e) for e in _device_events(prof)) / 1e6
        print(f"{tag} (a) profile: the same run traced, {traced_s * 1e3 / len(specs):.3f} ms a "
              f"study ({traced_s:.3f} s); device busy {busy * 1e3:.3f} ms, "
              f"{busy / traced_s:.1%} of the traced window, {busy / wall:.1%} of the untraced "
              f"one ({card})")
        for e in sorted(_device_events(prof), key=_dev_us, reverse=True)[:8]:
            print(f"{tag} profile: {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")

    # (b) Each result is run's on the same files in the same batch.
    one = {sid: (out / f"{sid}.json").read_text() for sid in specs}
    for batch in rec.batches:
        for sid, text in reference(batch, specs).items():
            if one[sid] != text:
                raise AssertionError(f"{tag} (b) {sid}: the served result is not run's")
    print(f"{tag} (b) {len(specs)} result JSONs equal run(..., fetch_crops=False) of the same "
          "files in the same batches bit for bit")

    # (c) Two servers on the one pipeline and one watch directory.
    watch, out = root / "two" / "requests", root / "two" / "results"
    _serve_requests(watch, paths)
    recs = [_RecordingPipeline(pipe) for _ in range(2)]
    results: list = [None, None]
    errors: list = []

    def server(i: int) -> None:
        try:
            results[i] = tserve.serve_directory(recs[i], watch, out, max_batch=SERVE_BATCH,
                                                once=True)
        except Exception as exc:  # noqa: BLE001 -- raised below
            errors.append(exc)

    with _LogRecords() as logs:
        threads = [threading.Thread(target=server, args=(i,)) for i in range(2)]
        start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall2 = time.perf_counter() - start
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{tag} (c) servers failed: {errors}")
    requeued = [m for m in logs.messages if "Re-queueing" in m]
    if requeued:
        raise AssertionError(f"{tag} (c) re-queued: {requeued}")
    _serve_outcome(f"{tag} (c)", watch, specs, results, recs[0].batches + recs[1].batches)
    bucket = {sid: 1 << (len(b) - 1).bit_length() for b in rec.batches for sid in b}
    same, rebatched, coord_gap, probability_gap, predictions_equal = 0, 0, 0.0, 0.0, True
    for r in recs:
        for batch in r.batches:
            want = reference(batch, specs) if any(
                bucket[sid] != 1 << (len(batch) - 1).bit_length() for sid in batch) else {}
            for sid in batch:
                text = (out / f"{sid}.json").read_text()
                if text == one[sid]:
                    same += 1
                elif sid in want and text == want[sid]:
                    rebatched += 1
                    got, first = json.loads(text), json.loads(one[sid])
                    coord_gap = max(coord_gap, float(np.abs(
                        np.asarray(got["coords"]) - np.asarray(first["coords"])).max()))
                    probability_gap = max(probability_gap, max(float(np.abs(
                        np.asarray(got["probabilities"][k])
                        - np.asarray(first["probabilities"][k])).max())
                        for k in first["probabilities"]))
                    predictions_equal &= got["predictions"] == first["predictions"]
                else:
                    raise AssertionError(f"{tag} (c) {sid}: the two-server result differs")
    print(f"{tag} (c) two servers: {[s.processed for s in results]} served in "
          f"{[len(b) for b in recs[0].batches]} and {[len(b) for b in recs[1].batches]}, each "
          f"request once, none re-queued; {same} results equal the one-server run's bit for "
          f"bit, {rebatched} (padded to another batch size) run's on their batch, against the "
          f"one-server run max |coords| gap {coord_gap:.3g}, probabilities {probability_gap:.3g}, "
          f"predictions {'equal' if predictions_equal else 'NOT equal'}; "
          f"{wall2 * 1e3 / len(specs):.3f} ms a study ({wall2:.3f} s) on {card}")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": per_forward, "ms_study": ms_study, "batches": stats.batches,
            "two_server_ms_study": wall2 * 1e3 / len(specs)}


# The builders phase: the dataset builders at full width on volume_io's
# clinical geometry (``data/builders``, ``data/phenikaa``).
BUILD_PATIENTS = 4  # per source
BUILD_BATCH = 8  # series a crop batch: 16 series in 2 forwards
BUILD_CONFIG: dict = {}  # ClassificationDatasetConfig's crop geometry: its defaults
RSNA_INSTANCES = 3  # 512^2 DICOM instances a series, 4 studies x 2 series
PRETRAIN_IMAGES = 4  # 512^2 pretrain sources: 2 JPGs, 2 .npy


def _loc_checkpoint(device, path: Path) -> None:
    """A seeded ConvNeXt-base CoordinateRegressor (f32 parameters, bf16
    compute) saved with the port's ``save_checkpoint``, as the trainer saves
    ``best_model``."""
    import torch

    from spine_vision_torch.models.classifier import CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
    from spine_vision_torch.train.checkpoint import save_checkpoint
    from spine_vision_torch.train.state import TrainState

    model = CoordinateRegressor("convnext_base", dtype=torch.bfloat16, device=device,
                                param_dtype=torch.float32)
    load_flax_variables(model, random_flax_variables(model, 0)[0])
    state = TrainState(model=model, optimizer=torch.optim.AdamW(model.parameters()),
                       schedule=lambda step: 1e-4, generator=torch.Generator())
    save_checkpoint(path, state, {"epoch": 0})


def _write_csv(path: Path, rows: list) -> None:
    import csv

    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def _read_csv(path: Path) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _grades(rng) -> dict:
    return {"Pfirrman grade": int(rng.integers(1, 6)), "Disc herniation": int(rng.integers(0, 2)),
            "Disc narrowing": int(rng.integers(0, 2)), "Disc bulging": int(rng.integers(0, 2)),
            "Spondylolisthesis": int(rng.integers(0, 2)), "UP endplate": int(rng.integers(0, 2)),
            "LOW endplate": int(rng.integers(0, 2))}


def _classification_tree(root: Path, images: list, paths: list, rng) -> list:
    """SPIDER: 4 patients' T1/T2 ``.mha`` (volume_io's studies 4-7 volumes)
    and gradings; Phenikaa: 4 patients whose "SAG T1"/"SAG T2" directories
    are volume_io's DICOM series (studies 0-2 uncompressed, 3 JPEG Lossless)
    and labels with one-hot Modic. Returns the series in the builder's queue
    order: (crop file prefix, series path)."""
    from spine_vision_torch import io as tio

    order = []
    rows = []
    phenikaa = root / "interim" / "Phenikaa"
    for k in range(BUILD_PATIENTS):
        pid = f"25000000{k + 1}"
        for level in range(1, 6):
            modic = int(rng.integers(0, 4))
            rows.append({"Patient ID": pid, "IVD label": level, **_grades(rng),
                         **{f"Modic_{i}": int(i == modic) for i in range(4)}})
        for series in ("t1", "t2"):
            link = phenikaa / "images" / pid / f"SAG {series.upper()}"
            link.parent.mkdir(parents=True, exist_ok=True)
            link.symlink_to(Path(paths[k][series]).resolve(), target_is_directory=True)
            order.append((f"phenikaa_{pid}_sag_{series}", link))
    _write_csv(phenikaa / "radiological_labels.csv", rows)
    spider = root / "raw" / "SPIDER"
    rows = []
    for k in range(BUILD_PATIENTS):
        pid = k + 1
        for spider_level in range(1, 6):
            rows.append({"Patient": pid, "IVD label": spider_level, **_grades(rng),
                         "Modic": int(rng.integers(0, 4))})
        for series in ("t1", "t2"):
            path = spider / "images" / f"{pid}_{series}.mha"
            tio.write_medical_image(images[BUILD_PATIENTS + k][series], path)
            order.append((f"spider_{pid}_sag_{series}", path))
    _write_csv(spider / "radiological_gradings.csv", rows)
    return order


def _localization_tree(root: Path, rng, instances: int = RSNA_INSTANCES,
                       baseline_jpgs: bool = False) -> tuple[list, list, list]:
    """The lumbar-coords pretrain sources (2 JPGs, 2 ``.npy`` listed as
    ``.jpg``) and an RSNA tree: 4 studies x (Sagittal T1, Sagittal T2/STIR)
    x ``instances`` instances of 512^2 int16 DICOM at volume_io's geometry,
    with a subarticular (axial) row the builder drops. The JPGs are seeded
    noise as 8-bit JPEG Lossless, or with ``baseline_jpgs`` the committed
    baseline JPEG slices (what a trainer's image store reads, as cv2 does).
    Returns the JPG sources, the ``.npy`` sources and the DICOM instances."""
    import numpy as np

    from spine_vision_torch import io as tio
    from spine_vision_torch.io.dicom_write import write_dicom_series
    from spine_vision_torch.io.jpeg_lossless import encode_jpeg_lossless

    base = root / "raw" / "Lumbar Coords"
    data = base / "data"
    jpgs, npys, rows = [], [], []
    for i in range(PRETRAIN_IMAGES):
        level = LEVELS[i % len(LEVELS)]
        if i % 2 == 0:
            path = data / "processed_spider_jpgs" / f"p{i}.jpg"
            path.parent.mkdir(parents=True, exist_ok=True)
            pixels = rng.integers(0, 256, (512, 512)).astype(np.uint16)
            path.write_bytes((JPEG_FIXTURES / "series" / f"slice_{i:02d}.jpg").read_bytes()
                             if baseline_jpgs else encode_jpeg_lossless(pixels, precision=8))
            jpgs.append(path)
            rows.append({"filename": path.name, "source": "spider", "level": level,
                         "relative_x": 0.5, "relative_y": 0.2 + 0.1 * i})
        else:
            path = data / "processed_lsd" / f"p{i}.npy"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, rng.normal(0.0, 1.0, (512, 512)))
            npys.append(path)
            rows.append({"filename": f"p{i}.jpg", "source": "lsd", "level": level,
                         "relative_x": 0.45, "relative_y": 0.2 + 0.1 * i})
    _write_csv(base / "coords_pretrain.csv", rows)

    rsna = root / "raw" / "RSNA"
    descriptions, coords, dicoms = [], [], []
    for s in range(4):
        study = 4000 + s
        for series, desc, condition in (
                (10 * s + 1, "Sagittal T1", "Left Neural Foraminal Narrowing"),
                (10 * s + 2, "Sagittal T2/STIR", "Spinal Canal Stenosis")):
            descriptions.append(
                {"study_id": study, "series_id": series, "series_description": desc})
            vol = rng.normal(700, 150, (instances, 512, 512)).clip(0, 4000).astype(np.int16)
            staging = rsna / "staging"
            write_dicom_series(tio.MedicalImage(array=vol, spacing=IO_SPACING, origin=IO_ORIGIN,
                                                direction=_io_direction(False)), staging)
            for k in range(1, instances + 1):
                target = rsna / "train_images" / str(study) / str(series) / f"{k}.dcm"
                target.parent.mkdir(parents=True, exist_ok=True)
                (staging / f"slice_{k:04d}.dcm").rename(target)
                dicoms.append(target)
                coords.append({"study_id": study, "series_id": series, "instance_number": k,
                               "condition": condition, "level": LEVELS[k % len(LEVELS)],
                               "relative_x": 0.5, "relative_y": 0.3 + 0.1 * (k % len(LEVELS))})
            coords.append({"study_id": study, "series_id": series, "instance_number": 1,
                           "condition": "Right Subarticular Stenosis", "level": "L4/L5",
                           "relative_x": 0.5, "relative_y": 0.6})
            staging.rmdir()
    _write_csv(rsna / "train_series_descriptions.csv", descriptions)
    _write_csv(base / "coords_rsna_improved.csv", coords)
    return jpgs, npys, dicoms


def _phenikaa_raw_tree(root: Path) -> tuple[dict, list]:
    """Report pages (the OCR fixture's two report pages, each under a file
    name built from its record's name and birthday), a label table of their
    IDs and a decoy's, and a folder tree with each record's study folder
    (name and birth year) among decoys. Returns {ID: matching folder} and
    the record fields."""
    from spine_vision_torch.data.phenikaa.matching import ascii_fold

    manifest = json.loads((OCR_FIXTURES / "manifest.json").read_text())
    records = [p for p in manifest["pages"] if p["file"].startswith("report_")]
    reports = root / "labels" / "reports"
    reports.mkdir(parents=True)
    rows, matching, fields = [], {}, []
    for i, page in enumerate(records):
        f = page["truth"]["fields"]
        fields.append(f)
        day, month, year = f["birthday"].split("/")
        shutil.copy(OCR_FIXTURES / page["file"],
                    reports / ("_".join(f["name"].split()) + f"_{day}{month}{year}.png"))
        folder = "_".join(ascii_fold(f["name"]).upper().split())
        match = root / "images" / f"site{i}" / f"{folder}_{year}_2024010{i + 1}"
        for decoy in (f"{folder}_{int(year) + 10}_2024020{i + 1}",
                      f"PHAM_VAN_BINH_{year}_2024030{i + 1}"):
            (root / "images" / decoy).mkdir(parents=True)
            (root / "images" / decoy / "decoy.txt").write_text(decoy)
        (match / "SAG T1").mkdir(parents=True)
        (match / "SAG T1" / "slice_0001.txt").write_text(f"{f['id']} T1")
        (match / "notes.txt").write_text(f"{f['id']}")
        matching[f["id"]] = match
        rows += [{"Patient ID": f["id"], "IVD label": lvl, "Pfirrman grade": lvl, "Modic": lvl % 3}
                 for lvl in (1, 2)]
    rows.append({"Patient ID": "250000001", "IVD label": 1, "Pfirrman grade": 1, "Modic": 0})
    _write_csv(root / "labels" / "tables" / "labels.csv", rows)
    return matching, fields


def _tree_snapshot(root: Path, mtimes: bool = True) -> dict:
    """Each file under ``root``: its bytes and, with ``mtimes``, its mtime."""
    return {p.relative_to(root): (p.read_bytes(), p.stat().st_mtime_ns if mtimes else None)
            for p in sorted(root.rglob("*")) if p.is_file()}


def builders_phase(device, card: str, io: dict | None = None) -> dict:
    """The dataset builders (``--build-only`` runs it alone).

    (a) ``create_classification_dataset`` over a SPIDER tree (4 patients'
    T1/T2 ``.mha``) and a Phenikaa tree (4 patients' DICOM series, one JPEG
    Lossless), volume_io's 17x512^2 int16 series (written anew when run
    alone), with a seeded ConvNeXt-base saved by ``save_checkpoint`` and
    loaded through ``localization_model_path``, crop batch 8 at the config's
    defaults: 80 records, each crop PNG equal bit for bit to
    ``SeriesCropPipeline.run`` on ``prepare_series_slice`` of the same files
    in the same batches, the records CSV, the study phase's launch counts a
    forward; a second run (resume) writes no file, launches nothing and
    gives the same records. (b) ``create_localization_dataset`` over an
    RSNA-like tree and pretrain sources: the PNGs equal the CPU's
    normalisation of the same arrays, the JPGs byte copies, no kernel
    launched. (c) ``preprocess_phenikaa`` with the shipped OCR weights on the
    card over the two fixture report pages under patient-named file names:
    each record's ID matched to its folder among decoys, the folders copied,
    the table keeping those IDs alone. Prints each builder's wall time and
    the classification build's series and crops a second."""
    import numpy as np
    import torch

    from spine_vision_torch.data import builders
    from spine_vision_torch.data.phenikaa import PreprocessConfig, preprocess_phenikaa
    from spine_vision_torch.data.png import read_png
    from spine_vision_torch.infer.pipeline import SeriesCropPipeline, StudyPipelineConfig
    from spine_vision_torch.io.dicom import read_dicom_file
    from spine_vision_torch.io.series import prepare_series_slice
    from spine_vision_torch.models.classifier import CoordinateRegressor
    from spine_vision_torch.ops.image import normalize_to_uint8
    from spine_vision_torch.train.checkpoint import load_model_state

    tag = "[builders]"
    images, paths = _io_files(tag) if io is None else (io["images"], io["paths"])
    root = RUN_DIR / "builders"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(7)
    ckpt = root / "loc_run" / "best_model"
    _loc_checkpoint(device, ckpt)
    t0 = time.perf_counter()
    order = _classification_tree(root, images, paths, rng)
    print(f"{tag} trees: SPIDER {BUILD_PATIENTS} patients (.mha written in "
          f"{time.perf_counter() - t0:.2f} s), Phenikaa {BUILD_PATIENTS} patients (volume_io's "
          "DICOM series); ConvNeXt-base checkpoint saved")

    # (a) The classification builder.
    config = builders.ClassificationDatasetConfig(
        base_path=root, localization_model_path=ckpt, device_batch_size=BUILD_BATCH,
        **BUILD_CONFIG)
    _zero_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = builders.create_classification_dataset(config, device=device)
    torch.cuda.synchronize()
    cls_s = time.perf_counter() - start
    counts = _counts()
    forwards = -(-len(order) // BUILD_BATCH)
    per_forward = {k: v // forwards for k, v in counts.items()}
    if per_forward != INFERENCE_LAUNCHES or any(v % forwards for v in counts.values()):
        raise AssertionError(f"{tag} (a) {forwards} forwards launched {counts}; expected "
                             f"{INFERENCE_LAUNCHES} a forward")
    n_crops = 5 * len(order)
    if result.num_samples != n_crops or "0 recovered" not in result.summary:
        raise AssertionError(f"{tag} (a) {result}")
    model = CoordinateRegressor(config.localization_backbone, dtype=torch.bfloat16,
                                device=device, param_dtype=torch.float32)
    load_model_state(ckpt, model)
    pipe = SeriesCropPipeline(model, config=StudyPipelineConfig(
        loc_image_size=config.image_size, crop_size=config.crop_size,
        crop_delta_mm=config.crop_delta_mm, crop_mode=config.crop_mode,
        padded_hw=config.padded_hw), device=device)
    out_images = config.output_path / "images"
    for b in range(0, len(order), BUILD_BATCH):
        batch = order[b:b + BUILD_BATCH]
        inputs = [prepare_series_slice(path, device=device) for _, path in batch]
        _, _, crops = pipe.run([s for s, _ in inputs], [sp for _, sp in inputs])
        for (prefix, _), series_crops in zip(batch, crops):
            for level in range(1, 6):
                got = read_png(out_images / f"{prefix}_L{level}.png", mode="gray")
                if not np.array_equal(got, series_crops[level - 1]):
                    raise AssertionError(f"{tag} (a) {prefix}_L{level}.png differs from "
                                         "SeriesCropPipeline.run")
    rows = _read_csv(config.output_path / "annotations.csv")
    want = sorted((f"images/{prefix}_L{lvl}.png", prefix.split("_")[0]) for prefix, _ in order
                  for lvl in range(1, 6))
    if sorted((r["image_path"], r["source"]) for r in rows) != want or any(
            not 1 <= int(r["pfirrmann_grade"]) <= 5 or not 0 <= int(r["modic"]) <= 3
            for r in rows):
        raise AssertionError(f"{tag} (a) the records CSV: {rows[:3]} ...")
    print(f"{tag} (a) classification: {len(order)} series, {n_crops} crops of "
          f"{config.crop_size} in {cls_s:.3f} s ({len(order) / cls_s:.3f} series/s, "
          f"{n_crops / cls_s:.3f} crops/s; decode, crops and PNG writes included); every crop "
          f"equals SeriesCropPipeline.run on the same files bit for bit; launches "
          f"{ {k: v for k, v in per_forward.items() if v} } a forward over {forwards} forwards "
          f"on {card}")
    before = _tree_snapshot(out_images)
    _zero_counts()
    start = time.perf_counter()
    again = builders.create_classification_dataset(config, device=device)
    resume_s = time.perf_counter() - start
    rows_again = _read_csv(config.output_path / "annotations.csv")
    key = lambda r: r["image_path"]  # noqa: E731
    if (_tree_snapshot(out_images) != before or any(_counts().values())
            or f"0 new, {n_crops} recovered" not in again.summary
            or sorted(rows_again, key=key) != sorted(rows, key=key)):
        raise AssertionError(f"{tag} (a) resume: {again.summary}")
    print(f"{tag} (a) resume: no crop written, no kernel launched, the same {n_crops} records "
          f"(in file-name order) in {resume_s:.3f} s")

    # (b) The localization builder.
    jpgs, npys, dicoms = _localization_tree(root, rng)
    loc_config = builders.LocalizationDatasetConfig(base_path=root)
    start = time.perf_counter()
    loc_result = builders.create_localization_dataset(loc_config, device=device)
    torch.cuda.synchronize()
    loc_s = time.perf_counter() - start
    loc_images = loc_config.output_path / "images"
    for jpg in jpgs:
        if (loc_images / f"pretrain_spider_{jpg.name}").read_bytes() != jpg.read_bytes():
            raise AssertionError(f"{tag} (b) {jpg.name} is not a byte copy")
    normalised = [(loc_images / f"pretrain_lsd_{p.stem}.jpg", np.load(p)) for p in npys] + [
        (loc_images / f"rsna_{p.parent.parent.name}_{p.parent.name}_{p.stem}.png",
         read_dicom_file(p).array.reshape(512, 512)) for p in dicoms]
    for png, arr in normalised:
        want_u8 = normalize_to_uint8(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
        if not np.array_equal(read_png(png, mode="gray"), want_u8.numpy()):
            raise AssertionError(f"{tag} (b) {png.name} differs from the CPU's normalisation")
    n_loc = PRETRAIN_IMAGES + len(dicoms)
    if loc_result.num_samples != n_loc or any(_counts().values()):
        raise AssertionError(f"{tag} (b) {loc_result}, launches {_counts()}")
    print(f"{tag} (b) localization: {n_loc} annotations ({len(dicoms)} 512^2 DICOM instances "
          f"and {len(npys)} .npy normalised on the card, equal to the CPU's normalisation; "
          f"{len(jpgs)} JPGs copied byte for byte) in {loc_s:.3f} s on {card}")

    # (c) Phenikaa report preprocessing with the shipped OCR weights.
    matching, fields = _phenikaa_raw_tree(root / "phenikaa")
    pre_config = PreprocessConfig(data_path=root / "phenikaa",
                                  output_path=root / "phenikaa_interim")
    start = time.perf_counter()
    pre_result = preprocess_phenikaa(pre_config, device=device)
    torch.cuda.synchronize()
    ocr_s = time.perf_counter() - start
    copied = sorted(p.name for p in pre_config.output_image_path.iterdir())
    for pid, folder in matching.items():
        if _tree_snapshot(pre_config.output_image_path / pid, False) != _tree_snapshot(
                folder, False):
            raise AssertionError(f"{tag} (c) {pid}: not a copy of {folder.name}")
    table = _read_csv(pre_config.output_table_path)
    if (pre_result.num_samples != len(fields) or copied != sorted(matching)
            or sorted({r["Patient ID"] for r in table}) != sorted(matching)
            or len(table) != 2 * len(fields) or any(_counts().values())):
        raise AssertionError(f"{tag} (c) {pre_result}; copied {copied}; table {table}")
    print(f"{tag} (c) preprocess_phenikaa: {len(fields)} patient-named reports read by the "
          f"shipped OCR on the card, IDs {sorted(matching)} matched to their folders among "
          f"decoys and copied, the table kept to those IDs ({len(table)} rows) in {ocr_s:.3f} s "
          f"on {card}")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": per_forward, "classification_s": cls_s, "localization_s": loc_s,
            "phenikaa_s": ocr_s, "series_s": len(order) / cls_s, "crops_s": n_crops / cls_s}


# The cli phase: the port's command line (``spine_vision_torch.cli``) through
# every subcommand that reaches the card, on trees made by the builders'
# helpers and volume_io's files; the baseline JPEG decoder on the committed
# fixtures (``tests/fixtures/torch_jpeg``, Pillow's decodes in record.json).
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_jpeg"
CLI_RSNA_INSTANCES = 16  # 128 DICOM + 4 pretrain images: 100 train, 3 steps of TRAIN_BATCH
CLI_CLS_BATCH = 16
CLI_DECODE_REPS = 5
CLI_LOC = {"backbone": "convnext_base", "hw": 512}  # the trained regressor
CLI_TRAIN_ARGS: list = []  # more options of both train commands


def _jpeg_check(tag: str) -> dict:
    """Each committed JPEG decodes to the sha256 of Pillow's decode in the
    fixtures' record; ms a 512^2 gray frame and the 17-slice series (median
    of ``CLI_DECODE_REPS``), each with the C++ entropy decode's ms."""
    import hashlib

    import numpy as np

    from spine_vision_torch.io import jpeg

    record = json.loads((JPEG_FIXTURES / "record.json").read_text())
    t0 = time.perf_counter()
    for name, entry in record["files"].items():
        got = jpeg.decode_jpeg((JPEG_FIXTURES / name).read_bytes())
        if (list(got.shape) != entry["shape"]
                or hashlib.sha256(got.tobytes()).hexdigest() != entry["sha256"]):
            raise AssertionError(f"{tag} {name} does not decode to Pillow's record")
    first_s = time.perf_counter() - t0
    series = [(JPEG_FIXTURES / "series" / f"slice_{k:02d}.jpg").read_bytes()
              for k in range(IO_SHAPE[0])]
    entropy: list = []
    inner = jpeg._decode_entropy

    def timed(*args, **kw):
        start = time.perf_counter()
        out = inner(*args, **kw)
        entropy.append(time.perf_counter() - start)
        return out

    runs: dict = {"frame": [], "frame_entropy": [], "series": [], "series_entropy": []}
    jpeg._decode_entropy = timed
    try:
        for _ in range(CLI_DECODE_REPS):
            for key, frames in (("frame", series[:1]), ("series", series)):
                entropy.clear()
                start = time.perf_counter()
                for data in frames:
                    jpeg.decode_jpeg(data)
                runs[key].append(time.perf_counter() - start)
                runs[f"{key}_entropy"].append(sum(entropy))
    finally:
        jpeg._decode_entropy = inner
    ms = {k: float(np.median(v)) * 1e3 for k, v in runs.items()}
    print(f"{tag} JPEG: {len(record['files'])} committed files decode to Pillow "
          f"{record['pillow']}'s sha256 (first pass {first_s:.3f} s, the C++ build included); "
          f"512^2 gray frame {ms['frame']:.3f} ms (entropy decode {ms['frame_entropy']:.3f} ms), "
          f"17-slice series {ms['series']:.3f} ms (entropy decode {ms['series_entropy']:.3f} "
          f"ms), median of {CLI_DECODE_REPS}, one host thread")
    return ms


def _jpeg_dicom_series(out: Path) -> Path:
    """The committed 17-slice JPEG series wrapped as a baseline-JPEG DICOM
    series (transfer syntax .50, 8-bit) at volume_io's geometry."""
    frames = [(JPEG_FIXTURES / "series" / f"slice_{k:02d}.jpg").read_bytes()
              for k in range(IO_SHAPE[0])]
    return _encapsulated_series(out, frames, "1.2.840.10008.1.2.4.50", IO_SHAPE[1:], 8, 8)


def _encapsulated_series(out: Path, frames: list, ts: str, shape: tuple, allocated: int,
                         stored: int) -> Path:
    """One DICOM file a frame (each one fragment after an empty Basic Offset
    Table) of transfer syntax ``ts``: unsigned MONOCHROME2 ``shape`` (rows,
    cols) slices at volume_io's geometry, the pixel spacing scaled so that
    the field of view is volume_io's."""
    import struct

    import numpy as np

    from spine_vision_torch.io import dicom_write as dw

    rows, cols = shape
    direction = _io_direction(False)
    row_dir, col_dir, normal = direction[:, 0], direction[:, 1], direction[:, 2]
    sx, sy = IO_SPACING[0] * IO_SHAPE[2] / cols, IO_SPACING[1] * IO_SHAPE[1] / rows
    sz = IO_SPACING[2]
    study_uid, series_uid = dw._new_uid(), dw._new_uid()
    out.mkdir(parents=True)
    for k, data in enumerate(frames):
        frame = dw._even(data, b"\x00")
        items = (struct.pack("<HHI", 0xFFFE, 0xE000, 0) + struct.pack("<HHI", 0xFFFE, 0xE000,
                                                                       len(frame))
                 + frame + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
        sop = dw._new_uid()
        body = (
            dw._ui(0x0008, 0x0016, dw.SOP_CLASS_MR) + dw._ui(0x0008, 0x0018, sop)
            + dw._str(0x0008, 0x0060, b"CS", "MR") + dw._str(0x0018, 0x0050, b"DS", f"{sz:.10g}")
            + dw._ui(0x0020, 0x000D, study_uid) + dw._ui(0x0020, 0x000E, series_uid)
            + dw._str(0x0020, 0x0013, b"IS", str(k + 1))
            + dw._ds(0x0020, 0x0032, np.asarray(IO_ORIGIN) + k * sz * normal)
            + dw._ds(0x0020, 0x0037, np.concatenate([row_dir, col_dir]))
            + dw._us(0x0028, 0x0002, 1) + dw._str(0x0028, 0x0004, b"CS", "MONOCHROME2")
            + dw._us(0x0028, 0x0010, rows) + dw._us(0x0028, 0x0011, cols)
            + dw._ds(0x0028, 0x0030, (sy, sx)) + dw._us(0x0028, 0x0100, allocated)
            + dw._us(0x0028, 0x0101, stored) + dw._us(0x0028, 0x0102, stored - 1)
            + dw._us(0x0028, 0x0103, 0)
            + struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF) + items)
        (out / f"slice_{k + 1:04d}.dcm").write_bytes(dw._file_meta(sop, ts) + body)
    return out


@contextlib.contextmanager
def _recorded(cls, name: str, calls: list):
    """Record ``(instance, result)`` of each call of ``cls.name``."""
    inner, own = getattr(cls, name), name in vars(cls)

    def wrapper(self, *args, **kw):
        out = inner(self, *args, **kw)
        calls.append((self, out))
        return out

    setattr(cls, name, wrapper)
    try:
        yield calls
    finally:
        if own:
            setattr(cls, name, inner)
        else:
            delattr(cls, name)


def _same_metrics(tag: str, got: dict, want: dict) -> float:
    """The largest gap of two metric dicts (NaN == NaN); raises above 1e-6."""
    import math

    if sorted(got) != sorted(want) or not want:
        raise AssertionError(f"{tag} metrics {sorted(got)} against {sorted(want)}")
    gap = max(0.0 if (math.isnan(got[k]) and math.isnan(want[k])) else abs(got[k] - want[k])
              for k in want)
    if not gap <= 1e-6:
        raise AssertionError(f"{tag} metrics differ by {gap}: {got} against {want}")
    return gap


def cli_phase(device, card: str, io: dict | None = None) -> dict:
    """The port's CLI on the card (``--cli-only`` runs it alone), in process
    through ``spine_vision_torch.cli.cli(argv)`` with ``--device`` the card:

    the JPEG fixtures against Pillow's record, with the decode times; the
    CLI's own cost; ``convert`` (as ``python -m spine_vision_torch.cli``, one
    subprocess) of a seeded torchvision ResNet-18 ``.pth``; ``dataset
    localization`` over an RSNA-like tree (4 studies x 2 series x 16 512^2
    DICOM instances) and 4 pretrain sources (2 committed baseline JPEGs);
    ``train localization`` (ConvNeXt-base 512^2, b32, hybrid, bf16 on f32
    masters, one epoch of 3 steps, ``--pretrained-path`` a seeded timm
    ``.pth``, ``--use-tracker``, ``--profile-steps``) and ``evaluate`` of its
    checkpoint, the same metrics as the trainer's ``evaluate()``;
    ``dataset classification`` over the builders' SPIDER and Phenikaa trees
    of volume_io's series, cropped by that checkpoint; ``train
    classification`` (ResNet-18 256^2, b16, ``--pretrained-path`` the
    ResNet ``.npz``) and ``evaluate``; ``infer`` on volume_io's 8 studies and
    a ninth whose T2 is the JPEG series as baseline-JPEG DICOM, bit for bit
    ``StudyInferencePipeline.run`` at the same padded size; ``serve --once``
    on the same 9 requests, equal to ``infer``; ``test`` with the ConvNeXt-base
    regressor at 512^2 and the ResNet-18 classifier at 256^2 on committed
    JPEG and PNG files; ``dataset phenikaa`` on the builders' report pages,
    one of them a committed JPEG; ``bench`` raising item 6. The tracker
    loads no matplotlib; ``visualize_predictions`` stays off. Returns the
    launches of every command, summed, and the times."""
    import math
    import subprocess

    import numpy as np
    import torch

    from spine_vision_torch import cli
    from spine_vision_torch.cli import train as cli_train
    from spine_vision_torch.data import builders
    from spine_vision_torch.data.phenikaa import PreprocessConfig
    from spine_vision_torch.infer.pipeline import (
        StudyInferencePipeline,
        StudyPipelineConfig,
        study_input_from_paths,
    )
    from spine_vision_torch.io import read_medical_image
    from spine_vision_torch.io.jpeg import read_jpeg
    from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS
    from spine_vision_torch.train.classification import ClassificationTrainer
    from spine_vision_torch.train.localization import LocalizationTrainer

    tag = "[cli]"
    on_card = torch.device(device).type == "cuda"  # the CPU runs the plain versions
    backbone, hw = CLI_LOC["backbone"], CLI_LOC["hw"]
    had_matplotlib = "matplotlib" in sys.modules
    jpeg_ms = _jpeg_check(tag)
    images, paths = _io_files(tag) if io is None else (io["images"], io["paths"])
    root = RUN_DIR / "cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(11)
    total = dict.fromkeys(KERNEL_COUNTERS, 0)
    seconds: dict = {}

    def run(*argv, name: str | None = None) -> dict:
        """One command in process; its launches, added to the total."""
        _zero_counts()
        start = time.perf_counter()
        rc = cli.cli(["--device", torch.device(device).type, *map(str, argv)])
        if on_card:
            torch.cuda.synchronize()
        seconds[name or " ".join(map(str, argv[:2]))] = time.perf_counter() - start
        counts = _counts()
        for name, n in counts.items():
            total[name] += n
        if rc != 0:
            raise AssertionError(f"{tag} {argv[:2]} returned {rc}")
        return {k: v for k, v in counts.items() if v}

    # The CLI's own cost: the parser and a train command's config.
    from spine_vision_torch.cli.config_args import config_from_args
    from spine_vision_torch.train.localization import LocalizationConfig

    own = []
    for _ in range(CLI_DECODE_REPS):
        start = time.perf_counter()
        args = cli._build_parser().parse_args(["train", "localization", "--batch-size", "32"])
        config_from_args(LocalizationConfig, args)
        own.append(time.perf_counter() - start)
    print(f"{tag} the CLI's own cost: parser and a train config {np.median(own) * 1e3:.3f} ms "
          f"(median of {CLI_DECODE_REPS}; the first, imports included, "
          f"{own[0] * 1e3:.3f} ms)")

    # convert, through the module entry: the ResNet-18 .pth. The ConvNeXt
    # .pth goes to --pretrained-path as it is (converted on the fly, without
    # the .npz's compression of 350 MB, about 20 s on the card's host).
    cn = CONVNEXT_CONFIGS[backbone]
    t0 = time.perf_counter()
    torch.save(_timm_convnext_state_dict(21, cn.depths, cn.dims), root / f"{backbone}.pth")
    torch.save(_torchvision_resnet18_state_dict(23), root / "resnet18.pth")
    saved_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spine_vision_torch.cli", "--device", "cpu", "convert",
         "--checkpoint", str(root / "resnet18.pth"), "--arch", "resnet18", "--output",
         str(root / "resnet18.npz")],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=300)
    module_s = time.perf_counter() - t0
    if proc.returncode != 0 or not (root / "resnet18.npz").exists():
        raise AssertionError(f"{tag} python -m spine_vision_torch.cli convert: {proc.stderr}")
    print(f"{tag} convert: seeded .pth files saved in {saved_s:.2f} s; ResNet-18 converted by "
          f"python -m spine_vision_torch.cli in {module_s:.2f} s (interpreter start included)")

    # dataset localization -> train localization -> evaluate localization.
    t0 = time.perf_counter()
    jpgs, npys, dicoms = _localization_tree(root, rng, instances=CLI_RSNA_INSTANCES,
                                            baseline_jpgs=True)
    tree_s = time.perf_counter() - t0
    run("dataset", "localization", "--base-path", root)
    loc_data = builders.LocalizationDatasetConfig(base_path=root).output_path
    rows = _read_csv(loc_data / "annotations.csv")
    n_images = len(jpgs) + len(npys) + len(dicoms)
    if len(rows) != n_images or len(list((loc_data / "images").iterdir())) != n_images:
        raise AssertionError(f"{tag} dataset localization: {len(rows)} rows")
    print(f"{tag} dataset localization: {n_images} images ({len(dicoms)} 512^2 DICOM "
          f"instances, tree written in {tree_s:.2f} s) in {seconds['dataset localization']:.2f} s")
    loc_args = ["--data-path", loc_data, "--backbone", backbone, "--image-size", hw, hw,
                "--batch-size", TRAIN_BATCH, "--num-epochs", 1, "--num-workers", 8, "--seed", 0,
                "--no-pretrained", *CLI_TRAIN_ARGS]
    with _recorded(LocalizationTrainer, "train", []) as trained, \
            _recorded(LocalizationTrainer, "evaluate", []) as evaluated, _LogRecords() as log:
        counts = run("train", "localization", *loc_args, "--output-path", root / "loc_run",
                     "--pretrained-path", root / f"{backbone}.pth", "--use-tracker",
                     "--profile-steps")
        run("evaluate", "localization", *loc_args, "--output-path", root / "loc_eval",
            "--checkpoint-path", root / "loc_run" / "best_model")
    trainer, result = trained[0]
    steps = len(trainer.step_times)
    want = {k: v * steps for k, v in TRAIN_LAUNCHES["train_step"].items() if v}
    if (steps != 3 or on_card and any(counts.get(k, 0) < v for k, v in want.items())
            or not all(math.isfinite(v) for v in result.history["train_loss"])):
        raise AssertionError(f"{tag} train localization: {steps} steps, launches {counts}, "
                             f"history {result.history}")
    if not any(m.startswith("Loaded pretrained backbone weights") for m in log.messages):
        raise AssertionError(f"{tag} --pretrained-path was not loaded")
    if trainer.visualizer is not None or "matplotlib" in sys.modules and not had_matplotlib:
        raise AssertionError(f"{tag} the plots ran or loaded matplotlib on the card")
    records = [json.loads(line) for line in
               (root / "loc_run" / "logs" / "metrics.jsonl").read_text().splitlines()]
    logged = {"step", "time", "train/loss", "train/lr", "val/loss", "val/med"}
    if not (logged <= set(records[0]) and any("test/med" in r for r in records)
            and any(r.get("_finished") == 1.0 for r in records)):
        raise AssertionError(f"{tag} metrics.jsonl: {records}")
    p50 = float(np.percentile(trainer.step_times[1:], 50)) * 1e3  # the first allocates
    print(f"{tag} train localization: {steps} steps of {backbone} {hw}^2 b{TRAIN_BATCH} "
          f"(hybrid, {'f32' if CLI_TRAIN_ARGS else 'bf16 on f32 masters'}) in {seconds['train localization']:.2f} s, train_loss "
          f"{result.history['train_loss']}, step p50 {p50:.3f} ms after the first (steps ms "
          f"{[round(t * 1e3, 3) for t in trainer.step_times]}); launches "
          f"{counts} ({steps} steps of {want and {k: v // steps for k, v in want.items()}} and the "
          f"validation and test forwards); metrics.jsonl keys {sorted(records[0])} on {card}")
    # evaluated: the train command's evaluate(), then the evaluate command's.
    gap = _same_metrics(f"{tag} evaluate localization", evaluated[1][1], evaluated[0][1])
    print(f"{tag} evaluate localization: med {evaluated[1][1]['med']:.6f}, the train command's "
          f"evaluate() within {gap:g}, in {seconds['evaluate localization']:.2f} s")
    del trainer, trained, evaluated
    gc.collect()

    # dataset classification -> train classification -> evaluate classification.
    cls_root = root / "cls_tree"
    order = _classification_tree(cls_root, images, paths, rng)
    counts = run("dataset", "classification", "--base-path", cls_root,
                 "--localization-model-path", root / "loc_run" / "best_model",
                 "--localization-backbone", backbone, "--device-batch-size", BUILD_BATCH)
    cls_data = builders.ClassificationDatasetConfig(base_path=cls_root).output_path
    if len(_read_csv(cls_data / "annotations.csv")) != 5 * len(order) or on_card and not counts:
        raise AssertionError(f"{tag} dataset classification: launches {counts}")
    print(f"{tag} dataset classification: {len(order)} series, {5 * len(order)} crops with the "
          f"CLI-trained {backbone} in {seconds['dataset classification']:.2f} s; launches "
          f"{counts}")
    cls_args = ["--data-path", cls_data, "--backbone", "resnet18", "--output-size", 256, 256,
                "--batch-size", CLI_CLS_BATCH, "--num-epochs", 1, "--num-workers", 8,
                "--seed", 0, "--no-pretrained", *CLI_TRAIN_ARGS]
    with _recorded(ClassificationTrainer, "train", []) as trained, \
            _recorded(ClassificationTrainer, "evaluate", []) as evaluated, _LogRecords() as log:
        run("train", "classification", *cls_args, "--output-path", root / "cls_run",
            "--pretrained-path", root / "resnet18.npz")
        run("evaluate", "classification", *cls_args, "--output-path", root / "cls_eval",
            "--checkpoint-path", root / "cls_run" / "best_model")
    result = trained[0][1]
    if (not any(m.startswith("Loaded pretrained backbone weights") for m in log.messages)
            or not all(math.isfinite(v) for v in result.history["train_loss"])):
        raise AssertionError(f"{tag} train classification: {result.history}")
    gap = _same_metrics(f"{tag} evaluate classification", evaluated[1][1], evaluated[0][1])
    print(f"{tag} train classification: ResNet-18 256^2 b{CLI_CLS_BATCH} from the converted "
          f".npz, {len(trained[0][0].train_dataset)} train records, train_loss "
          f"{result.history['train_loss']} in {seconds['train classification']:.2f} s; "
          f"evaluate: macro_f1 {evaluated[1][1]['macro_f1']:.6f}, the train command's "
          f"within {gap:g}, in {seconds['evaluate classification']:.2f} s")
    del trained, evaluated
    gc.collect()

    # infer and serve --once: volume_io's 8 studies and a JPEG-baseline T2.
    jpeg_t2 = _jpeg_dicom_series(root / "jpeg_t2")
    volume = read_medical_image(jpeg_t2).array
    decoded = np.stack([read_jpeg(JPEG_FIXTURES / "series" / f"slice_{k:02d}.jpg")
                        for k in range(IO_SHAPE[0])])
    if not np.array_equal(np.asarray(volume).reshape(decoded.shape), decoded):
        raise AssertionError(f"{tag} the JPEG-baseline DICOM series reads back otherwise")
    pairs = [(p["t1"], p["t2"]) for p in paths] + [(paths[0]["t1"], jpeg_t2)]
    ckpts = ["--loc-checkpoint", root / "loc_run" / "best_model",
             "--cls-checkpoint", root / "cls_run" / "best_model", "--loc-backbone", backbone]
    counts = run("infer", *ckpts, "--t1", *[a for a, _ in pairs], "--t2", *[b for _, b in pairs],
                 "--output-json", root / "infer.json", name="infer")
    payload = json.loads((root / "infer.json").read_text())
    studies = [study_input_from_paths(a, b, study_id=f"study{i}", device=device)
               for i, (a, b) in enumerate(pairs)]
    pipe = StudyInferencePipeline.from_checkpoints(
        root / "loc_run" / "best_model", root / "cls_run" / "best_model", loc_backbone=backbone,
        config=StudyPipelineConfig(padded_hw=(1024, 1024)), device=device)
    want = [{"study_id": r.study_id, "coords": r.coords.tolist(),
             "predictions": {k: v.tolist() for k, v in r.predictions.items()},
             "probabilities": {k: v.tolist() for k, v in r.probabilities.items()}}
            for r in pipe.run(studies, fetch_crops=False)]
    forwards = counts.get("convnext_block", 0) // max(INFERENCE_LAUNCHES["convnext_block"], 1)
    if payload != want or on_card and (not forwards or counts != {
            k: v * forwards for k, v in INFERENCE_LAUNCHES.items() if v}):
        raise AssertionError(f"{tag} infer: launches {counts}; equal to run: {payload == want}")
    del pipe, studies
    watch = root / "watch"
    watch.mkdir()
    for i, (a, b) in enumerate(pairs):
        (watch / f"study{i}.json").write_text(json.dumps(
            {"study_id": f"study{i}", "t1": str(a), "t2": str(b)}))
    serve_counts = run("serve", *ckpts, "--watch-dir", watch, "--output-dir", root / "served",
                       "--once", "--padded-hw", 1024, 1024, name="serve")
    served = [json.loads((root / "served" / f"study{i}.json").read_text())
              for i in range(len(pairs))]
    if served != payload or serve_counts != counts:
        raise AssertionError(f"{tag} serve --once differs from infer (launches {serve_counts})")
    print(f"{tag} infer: {len(pairs)} studies (the ninth's T2 the committed JPEG series as "
          f"baseline-JPEG DICOM) auto-bucketed to 1024^2, bit for bit StudyInferencePipeline.run,"
          f" in {seconds['infer']:.2f} s; serve --once the same results in "
          f"{seconds['serve']:.2f} s; launches {counts} each")

    # test: the regressor at 512^2 and the classifier at 256^2 on image files.
    files = [JPEG_FIXTURES / "color_420.jpg", JPEG_FIXTURES / "series" / "slice_00.jpg",
             JPEG_FIXTURES / "report_clean.jpg", next((loc_data / "images").glob("*.png"))]
    results: list = []
    inner_test = cli_train.test_inference_command
    cli_train.test_inference_command = lambda **kw: results.append(inner_test(**kw)) or results[-1]
    try:
        test_counts = run("test", "--checkpoint-path", root / "loc_run" / "best_model",
                          "--images", *files, "--model-kind", "localization",
                          "--backbone", backbone, "--image-size", hw, hw,
                          name="test localization")
        run("test", "--checkpoint-path", root / "cls_run" / "best_model", "--images", *files,
            "--model-kind", "classification", "--backbone", "resnet18",
            "--image-size", 256, 256, name="test classification")
    finally:
        cli_train.test_inference_command = inner_test
    loc_out, cls_out = results
    if (loc_out["pixel_coordinates"].shape != (len(files), 5, 2)
            or not np.all(np.isfinite(loc_out["pixel_coordinates"]))
            or not all(np.all(np.isfinite(v)) for v in cls_out["probabilities"].values())
            or on_card and not test_counts):
        raise AssertionError(f"{tag} test: {loc_out['pixel_coordinates']}, launches {test_counts}")
    print(f"{tag} test: {backbone} regressor (f32) at {hw}^2 on {len(files)} files (3 JPEG, 1 PNG) in "
          f"{loc_out['inference_time_ms']:.3f} ms, launches {test_counts}; ResNet-18 classifier "
          f"in {cls_out['inference_time_ms']:.3f} ms")

    # dataset phenikaa: the report pages, one of them a committed JPEG.
    matching, fields = _phenikaa_raw_tree(root / "phenikaa")
    manifest = json.loads((OCR_FIXTURES / "manifest.json").read_text())
    if [p["file"] for p in manifest["pages"] if p["file"].startswith("report_")][0] != (
            "report_clean.png"):
        raise AssertionError(f"{tag} the first report page is not report_clean.png")
    day, month, year = fields[0]["birthday"].split("/")
    jpeg_page = (root / "phenikaa" / "labels" / "reports"
                 / ("_".join(fields[0]["name"].split()) + f"_{day}{month}{year}.png"))
    shutil.copy(JPEG_FIXTURES / "report_clean.jpg", jpeg_page.with_suffix(".jpg"))
    jpeg_page.unlink()
    pre = PreprocessConfig(data_path=root / "phenikaa", output_path=root / "phenikaa_out")
    run("dataset", "phenikaa", "--data-path", pre.data_path, "--output-path", pre.output_path)
    copied = sorted(p.name for p in pre.output_image_path.iterdir())
    if copied != sorted(matching):
        raise AssertionError(f"{tag} dataset phenikaa: copied {copied}, want {sorted(matching)}")
    print(f"{tag} dataset phenikaa: {len(fields)} reports ({jpeg_page.stem}.jpg the committed "
          f"JPEG page) matched to {copied} in {seconds['dataset phenikaa']:.2f} s")

    try:
        cli.cli(["bench"])
    except NotImplementedError as exc:
        if "Queue 1 item 6" not in str(exc):
            raise
    else:
        raise AssertionError(f"{tag} bench did not raise")
    if "matplotlib" in sys.modules and not had_matplotlib:
        raise AssertionError(f"{tag} the phase loaded matplotlib")
    shutil.rmtree(root, ignore_errors=True)
    print(f"{tag} commands' seconds {{{', '.join(f'{k!r}: {v:.2f}' for k, v in seconds.items())}}}"
          f"; launches of the phase {({k: v for k, v in total.items() if v})}; bench raised "
          f"item 6; no matplotlib loaded")
    return {"launches": total, "seconds": seconds, "step_p50_ms": p50, "jpeg_ms": jpeg_ms,
            "cli_own_ms": float(np.median(own)) * 1e3}


# The codecs phase: JPEG 2000 DICOM frames and progressive JPEG, decoded on
# the host as Pillow decodes them, into the study graph's kernels.
J2K_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_jpeg2000"
CODEC_REPS = 5
CODEC_SERIES = {"series90": "1.2.840.10008.1.2.4.90", "series91": "1.2.840.10008.1.2.4.91"}


def _codec_decode(data: bytes):
    from spine_vision_torch.io import jpeg, jpeg2000

    return jpeg2000.decode_jpeg2000(data) if jpeg2000.is_jpeg2000(data) else jpeg.decode_jpeg(data)


def _codec_check(tag: str, card: str) -> dict:
    """(a) Each committed JPEG 2000 and progressive JPEG fixture decodes to
    the sha256 of Pillow's decode in the record; ms a frame and a series of
    each kind (median of ``CODEC_REPS``), with the C++ tier-1 (JPEG 2000) or
    entropy decode (JPEG) apart from the rest."""
    import hashlib

    import numpy as np

    from spine_vision_torch.io import jpeg, jpeg2000

    record = json.loads((J2K_FIXTURES / "record.json").read_text())
    t0 = time.perf_counter()
    for name, entry in record["files"].items():
        got = _codec_decode((J2K_FIXTURES / name).read_bytes())
        if ([list(got.shape), str(got.dtype)] != [entry["shape"], entry["dtype"]]
                or hashlib.sha256(got.tobytes()).hexdigest() != entry["sha256"]):
            raise AssertionError(f"{tag} {name} does not decode to Pillow's record")
    first_s = time.perf_counter() - t0
    inner_t1, inner_entropy = jpeg2000._t1_decode, jpeg._decode_entropy
    spent: list = []

    def timed(inner):
        def wrapper(*args, **kw):
            start = time.perf_counter()
            out = inner(*args, **kw)
            spent.append(time.perf_counter() - start)
            return out
        return wrapper

    kinds = {kind: [(J2K_FIXTURES / name).read_bytes() for name in sorted(record["files"])
                    if name.startswith(kind + "/")] for kind in CODEC_SERIES}
    kinds["progressive"] = [(J2K_FIXTURES / "progressive" / "gray_512.jpg").read_bytes()]
    ms: dict = {}
    jpeg2000._t1_decode, jpeg._decode_entropy = timed(inner_t1), timed(inner_entropy)
    try:
        for kind, frames in kinds.items():
            for key, batch in (("frame", frames[:1]), ("series", frames)):
                if key == "series" and len(frames) == 1:
                    continue
                runs, inner_runs = [], []
                for _ in range(CODEC_REPS):
                    spent.clear()
                    start = time.perf_counter()
                    for data in batch:
                        _codec_decode(data)
                    runs.append(time.perf_counter() - start)
                    inner_runs.append(sum(spent))
                ms[f"{kind}_{key}"] = float(np.median(runs)) * 1e3
                ms[f"{kind}_{key}_entropy"] = float(np.median(inner_runs)) * 1e3
    finally:
        jpeg2000._t1_decode, jpeg._decode_entropy = inner_t1, inner_entropy
    shapes = {k: record["files"][n]["shape"] for k, n in (
        ("series90", "series90/slice_00.j2k"), ("series91", "series91/slice_00.j2k"),
        ("progressive", "progressive/gray_512.jpg"))}
    print(f"{tag} (a) {len(record['files'])} committed files decode to Pillow "
          f"{record['pillow']} (OpenJPEG {record['openjpeg']})'s sha256 (first pass "
          f"{first_s:.3f} s, the C++ build included)")
    for kind, what in (("series90", "lossless 12-bit JPEG 2000 (.90)"),
                       ("series91", "lossy 16-bit JPEG 2000 (.91, 9/7)"),
                       ("progressive", "progressive JPEG, gray")):
        side = "x".join(map(str, shapes[kind]))
        line = (f"{tag} decode {what} {side}: frame {ms[kind + '_frame']:.3f} ms "
                f"({'tier-1' if kind != 'progressive' else 'entropy decode'} "
                f"{ms[kind + '_frame_entropy']:.3f} ms)")
        if kind + "_series" in ms:
            line += (f", 17-slice series {ms[kind + '_series']:.3f} ms (tier-1 "
                     f"{ms[kind + '_series_entropy']:.3f} ms)")
        print(line + f", median of {CODEC_REPS}, on the host of {card}")
    return ms


def _codec_dicom_series(out: Path, kind: str) -> Path:
    """The committed JPEG 2000 series ``kind`` wrapped as a DICOM series of
    its transfer syntax (.90 12-bit, .91 16-bit) at volume_io's geometry."""
    record = json.loads((J2K_FIXTURES / "record.json").read_text())
    frames = [(J2K_FIXTURES / kind / f"slice_{k:02d}.j2k").read_bytes()
              for k in range(IO_SHAPE[0])]
    return _encapsulated_series(out, frames, CODEC_SERIES[kind],
                                tuple(record["files"][f"{kind}/slice_00.j2k"]["shape"]), 16,
                                12 if kind == "series90" else 16)


def codecs_phase(device, card: str, io: dict | None = None) -> dict:
    """JPEG 2000 DICOM frames and progressive JPEG on the card
    (``--codecs-only`` runs it alone).

    (a) the committed fixtures (``tests/fixtures/torch_jpeg2000``) against
    the record of Pillow's decodes, with the decode times; (b) the lossless
    12-bit series (256^2) and the lossy 16-bit one (512^2) wrapped as .90
    and .91 DICOM series at volume_io's geometry, and the same decoded
    arrays written as uncompressed DICOM series; (c)
    ``StudyInferencePipeline.run`` (ConvNeXt-base 512^2 and ResNet-18
    256^2, bf16, seeded Flax trees; volume_io's models when given) on two
    studies of them from files (T1 .90 with T2 .91, and T1 .91 with T2 .90)
    in both crop modes: #1 33 and #2 3 launches, results bit for bit the
    uncompressed series' run, files-to-results ms a study; (d) the ``test``
    command's path (``models.inference.regressor_test_inference``) with the
    f32 ConvNeXt-base regressor at 512^2 on a .90 slice, a .91 slice and two
    progressive JPEGs. Returns the launches of (c) and (d), summed."""
    import numpy as np
    import torch

    from spine_vision_torch import io as tio
    from spine_vision_torch.core.tasks import get_tasks
    from spine_vision_torch.infer.pipeline import (
        StudyInferencePipeline,
        StudyPipelineConfig,
        study_input_from_paths,
    )
    from spine_vision_torch.io.dicom_write import write_dicom_series
    from spine_vision_torch.models.classifier import CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
    from spine_vision_torch.models.inference import regressor_test_inference

    tag = "[codecs]"
    on_card = torch.device(device).type == "cuda"
    ms = _codec_check(tag, card)
    root = RUN_DIR / "codecs"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    # (b) The series as JPEG 2000 DICOM, and their decoded arrays uncompressed.
    compressed, plain = {}, {}
    for kind in CODEC_SERIES:
        compressed[kind] = _codec_dicom_series(root / f"{kind}_dicom", kind)
        image = tio.read_medical_image(compressed[kind])
        write_dicom_series(image, root / f"{kind}_plain")
        plain[kind] = root / f"{kind}_plain"
        again = tio.read_medical_image(plain[kind])
        if image.array.dtype != np.uint16 or not np.array_equal(again.array, image.array):
            raise AssertionError(f"{tag} {kind}: the uncompressed series differs")
        for name in ("spacing", "origin", "direction"):
            if not np.array_equal(np.asarray(getattr(again, name)),
                                  np.asarray(getattr(image, name))):
                raise AssertionError(f"{tag} {kind}: {name} {getattr(again, name)} against "
                                     f"{getattr(image, name)}")
        print(f"{tag} (b) {kind}: {image.array.shape} {image.array.dtype} (max "
              f"{int(image.array.max())}) as {CODEC_SERIES[kind]} DICOM and uncompressed, the "
              f"same arrays and geometry")
    series_ms = {kind: _host_ms(lambda k=kind: tio.read_medical_image(compressed[k]),
                                CODEC_REPS)[0] for kind in CODEC_SERIES}
    print(f"{tag} read_medical_image ms a series: "
          + ", ".join(f"{k} {v:.3f}" for k, v in series_ms.items()) + f" on the host of {card}")

    # (c) The study graph on the studies from files, both crop modes.
    loc, cls = io["models"] if io is not None else _study_models(device)
    tasks = get_tasks()
    pairs = [(compressed["series90"], compressed["series91"]),
             (compressed["series91"], compressed["series90"])]
    plain_pairs = [(plain["series90"], plain["series91"]),
                   (plain["series91"], plain["series90"])]
    total = dict.fromkeys(KERNEL_COUNTERS, 0)
    e2e = {}
    for mode in ("horizontal", "rotated"):
        pipe = StudyInferencePipeline(loc, cls, config=StudyPipelineConfig(crop_mode=mode),
                                      device=device)
        want = pipe.run([study_input_from_paths(a, b, device=device) for a, b in plain_pairs])
        _zero_counts()
        got = pipe.run([study_input_from_paths(a, b, device=device) for a, b in pairs])
        counts = _counts()
        if on_card and counts != INFERENCE_LAUNCHES:
            raise AssertionError(f"{tag} {mode}: expected {INFERENCE_LAUNCHES} launches, got "
                                 f"{counts}")
        _check_results(got, len(pairs), tasks)
        if not _same_results(got, want):
            raise AssertionError(f"{tag} {mode}: results from JPEG 2000 DICOM differ from the "
                                 "uncompressed series'")
        total = {k: total[k] + counts[k] for k in total}
        e2e[mode] = _host_ms(lambda: pipe.run(
            [study_input_from_paths(a, b, device=device) for a, b in pairs]),
            CODEC_REPS)[0] / len(pairs)
        print(f"{tag} (c) {mode}: launches {({k: v for k, v in counts.items() if v})}; 2 "
              f"studies from .90/.91 DICOM equal bit for bit to the uncompressed series' run; "
              f"files to results {e2e[mode]:.3f} ms a study (median of {CODEC_REPS}, host "
              f"decode included) on {card}")

    # (d) The test command's path on JPEG 2000 and progressive files, f32.
    regressor = CoordinateRegressor("convnext_base", dtype=torch.float32, device=device)
    load_flax_variables(regressor, *random_flax_variables(regressor, 2))
    files = [J2K_FIXTURES / "series90" / "slice_08.j2k", J2K_FIXTURES / "series91" / "slice_08.j2k",
             J2K_FIXTURES / "progressive" / "gray_512.jpg",
             J2K_FIXTURES / "progressive" / "color_420_rst.jpg"]
    _zero_counts()
    out = regressor_test_inference(regressor, files, image_size=(512, 512))
    counts = _counts()
    forwards = counts["convnext_block"] // max(INFERENCE_LAUNCHES["convnext_block"], 1)
    if on_card and (forwards < 1 or counts != {
            k: v * forwards for k, v in _f32_twins(INFERENCE_LAUNCHES).items()}):
        raise AssertionError(f"{tag} test path: launches {counts}")
    if (out["pixel_coordinates"].shape != (len(files), 5, 2)
            or not np.all(np.isfinite(out["pixel_coordinates"]))
            or out["images"].shape != (len(files), 512, 512, 3)):
        raise AssertionError(f"{tag} test path: {out['pixel_coordinates']}")
    total = {k: total[k] + counts[k] for k in total}
    print(f"{tag} (d) test path: f32 ConvNeXt-base regressor at 512^2 on {len(files)} files "
          f"(.90 and .91 slices, two progressive JPEGs) in {out['inference_time_ms']:.3f} ms, "
          f"launches {({k: v for k, v in counts.items() if v})}")
    del regressor
    shutil.rmtree(root, ignore_errors=True)
    print(f"{tag} launches of the phase {({k: v for k, v in total.items() if v})} on {card}")
    return {"launches": total, "decode_ms": ms, "series_ms": series_ms,
            "files_to_results_ms": e2e}


# The pdf phase: PDF report pages rendered by the port (io/pdf.py, no
# PyMuPDF) on the card's host, read by the OCR on the card, and driven
# through ``dataset phenikaa`` into the classification builder's forwards.
PDF_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_pdf"
PDF_REPS = 3
PDF_TIMED = {"vector A4 report": "report_type42.pdf", "scanned A4 page": "scan_a4_200.pdf"}


def _pdf_render_check(tag: str, card: str) -> dict:
    """(a) Every committed fixture at the record's dpi: each page's shape and
    sha256 those of ``tests/fixtures/torch_pdf/record.json`` and the C++ raster
    steps' pages equal to the plain numpy versions'; the C++ G4 decoder equal
    to the plain one on the bilevel page; each unsupported file raising
    ROADMAP Queue 1 item 13; a page tree with no pages giving None. Then ms a
    page (median of ``PDF_REPS``) of parsing, interpretation, image decode
    and rasterisation for a vector A4 report and a scanned A4 page."""
    import hashlib

    import numpy as np

    from spine_vision_torch import native
    from spine_vision_torch.io import pdf as tpdf
    from spine_vision_torch.io import pdf_parse, pdf_render

    record = json.loads((PDF_FIXTURES / "record.json").read_text())
    dpi = record["dpi"]
    t0 = time.perf_counter()
    n_pages = 0
    for name, want in record["pages"].items():
        got = tpdf.pdf_to_arrays(PDF_FIXTURES / name, dpi)
        plain = tpdf.pdf_to_arrays(PDF_FIXTURES / name, dpi, plain=True)
        if len(got) != len(want) or len(plain) != len(want):
            raise AssertionError(f"{tag} {name}: {len(got)} pages, the record {len(want)}")
        for page, page_plain, entry in zip(got, plain, want):
            if [list(page.shape), hashlib.sha256(page.tobytes()).hexdigest()] != [
                    entry["shape"], entry["sha256"]]:
                raise AssertionError(f"{tag} {name}: {page.shape} not the record's render")
            if not np.array_equal(page, page_plain):
                raise AssertionError(f"{tag} {name}: the C++ raster differs from the plain one")
            n_pages += 1
    for name, words in record["unsupported"].items():
        try:
            tpdf.pdf_to_arrays(PDF_FIXTURES / name, dpi)
        except NotImplementedError as exc:
            if "item 13" not in str(exc) or words.lower() not in str(exc).lower():
                raise AssertionError(f"{tag} {name}: {exc}") from exc
        else:
            raise AssertionError(f"{tag} {name} rendered; it must raise item 13")
    for name in record["no_pages"]:
        if tpdf.pdf_first_page_to_array(PDF_FIXTURES / name, dpi) is not None:
            raise AssertionError(f"{tag} {name}: a page from an empty page tree")
    doc = tpdf.open_pdf(PDF_FIXTURES / "raster_bilevel_200.pdf")
    image = doc.resolve(doc.resolve(doc.pages()[0]["Resources"])["XObject"]["image"])
    parm = pdf_parse.stream_filters(image)[1][0]
    fast = native.pdf_g4_decode(image.raw, int(parm["Columns"]), int(parm["Rows"]))
    if not np.array_equal(fast, pdf_parse.g4_decode_plain(image.raw, int(parm["Columns"]),
                                                          int(parm["Rows"]))):
        raise AssertionError(f"{tag} the C++ G4 decoder differs from the plain one")
    check_s = time.perf_counter() - t0
    print(f"{tag} (1) {n_pages} pages of {len(record['pages'])} fixtures at {dpi} dpi: the "
          f"record's shapes and sha256, C++ equal to plain (raster steps and G4) bit for bit; "
          f"{len(record['unsupported'])} unsupported files raise item 13 ({check_s:.2f} s, "
          "both renders of each)")
    ms: dict = {}
    for kind, name in PDF_TIMED.items():
        runs: dict = {"parse": [], "interpret": [], "decode": [], "raster": [], "page": []}
        for _ in range(PDF_REPS):
            start = time.perf_counter()
            doc = tpdf.open_pdf(PDF_FIXTURES / name)
            pages = doc.pages()
            parse = time.perf_counter() - start
            stats: dict = {}
            pdf_render.render_page(doc, pages[0], dpi, stats=stats)
            runs["parse"].append(parse)
            runs["decode"].append(stats["decode_s"])
            runs["raster"].append(stats["raster_s"])
            runs["interpret"].append(stats["render_s"] - stats["raster_s"] - stats["decode_s"])
            runs["page"].append(parse + stats["render_s"])
        ms[kind] = {k: float(np.median(v)) * 1e3 for k, v in runs.items()}
        print(f"{tag} {kind} ({name}, {dpi} dpi): page {ms[kind]['page']:.3f} ms = parse "
              f"{ms[kind]['parse']:.3f} + interpretation {ms[kind]['interpret']:.3f} + image "
              f"decode {ms[kind]['decode']:.3f} + rasterisation {ms[kind]['raster']:.3f} ms "
              f"(median of {PDF_REPS}) on the host of {card}")
    return ms


def pdf_phase(device, card: str, io: dict | None = None) -> dict:
    """PDF reports on the card (``--pdf-only`` runs it alone).

    (1) ``_pdf_render_check``: the committed fixtures rendered on the card's
    host against the record, C++ against plain, and the times a page. (2)
    ``DocumentExtractor`` on the card with the shipped weights: each report's
    ID through ``extract_from_pdf_crop`` with ``DEFAULT_PDF_ID_CROP_REGION``
    and its three fields through ``extract_from_pdf``, the record's; the
    OCR's ms of a crop and of a page. (3) ``spine-vision-torch --device cuda
    dataset phenikaa`` in process over the four patient-named PDF reports
    (three vector, one scanned) beside their study folders (volume_io's
    DICOM series 0-3) and decoys: every patient matched through the crop
    path's ID; then ``dataset classification`` over the matched patients
    with a seeded ConvNeXt-base checkpoint (the builders'), #1 33 and #2 3
    launches a forward, a crop for each level of each series. Returns the
    phase's launches and times."""
    import numpy as np
    import torch

    from spine_vision_torch import cli
    from spine_vision_torch.data import builders
    from spine_vision_torch.data.phenikaa import (
        DEFAULT_PDF_ID_CROP_REGION,
        PatientNamedReportProcessor,
        PreprocessConfig,
    )
    from spine_vision_torch.data.phenikaa.matching import ascii_fold
    from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor
    from spine_vision_torch.io import pdf as tpdf

    tag = "[pdf]"
    on_card = torch.device(device).type == "cuda"
    record = json.loads((PDF_FIXTURES / "record.json").read_text())
    ms = _pdf_render_check(tag, card)

    # (2) The OCR on the card.
    extractor = DocumentExtractor(device=device)
    for name, f in record["reports"].items():
        crop = extractor.extract_from_pdf_crop(PDF_FIXTURES / name, DEFAULT_PDF_ID_CROP_REGION)
        text = " ".join(extractor.extract_from_pdf(PDF_FIXTURES / name))
        if crop != [f"Số phiếu: {f['id']}"] or any(f[k] not in text
                                                   for k in ("id", "name", "birthday")):
            raise AssertionError(f"{tag} {name}: crop {crop}, page {text!r}; want {f}")
    page = tpdf.pdf_first_page_to_array(PDF_FIXTURES / "report_type42.pdf", record["dpi"])
    x1, y1, x2, y2 = DEFAULT_PDF_ID_CROP_REGION
    ocr_ms = {"crop": _host_ms(lambda: extractor.extract_from_image(page[y1:y2, x1:x2]),
                               PDF_REPS)[0],
              "page": _host_ms(lambda: extractor.extract_from_image(page), PDF_REPS)[0]}
    print(f"{tag} (2) the shipped OCR read the {len(record['reports'])} reports: "
          f"each ID through the {x2 - x1}x{y2 - y1} crop, name, birthday and ID on the page; "
          f"OCR {ocr_ms['crop']:.3f} ms a crop, {ocr_ms['page']:.3f} ms an A4 page (median of "
          f"{PDF_REPS}) on {card}")
    del extractor

    # (3) dataset phenikaa from PDF reports, then dataset classification.
    paths = _io_files(tag)[1] if io is None else io["paths"]
    root = RUN_DIR / "pdf"
    shutil.rmtree(root, ignore_errors=True)
    raw, base = root / "raw", root / "base"
    reports = raw / "labels" / "reports"
    reports.mkdir(parents=True)
    rng = np.random.default_rng(25)
    rows, want_ids = [], {}
    for k, (name, f) in enumerate(sorted(record["reports"].items())):
        day, month, year = f["birthday"].split("/")
        folder = "_".join(ascii_fold(f["name"]).upper().split())
        stem = f"{folder}_{day}{month}{year}"
        shutil.copy(PDF_FIXTURES / name, reports / f"{stem}.pdf")
        want_ids[stem] = int(f["id"])
        study = raw / "images" / f"{folder}_{year}_2024010{k + 1}"
        for series in ("t1", "t2"):
            (study / f"SAG {series.upper()}").parent.mkdir(parents=True, exist_ok=True)
            (study / f"SAG {series.upper()}").symlink_to(Path(paths[k][series]).resolve(),
                                                         target_is_directory=True)
        for decoy in (f"{folder}_{int(year) + 10}_2024020{k + 1}",
                      f"PHAM_VAN_BINH_{year}_2024030{k + 1}"):
            (raw / "images" / decoy).mkdir(parents=True, exist_ok=True)
        rows += [{"Patient ID": f["id"], "IVD label": level, **_grades(rng),
                  "Modic": int(rng.integers(0, 4))} for level in range(1, 6)]
    rows.append({"Patient ID": "250000001", "IVD label": 1, **_grades(rng), "Modic": 0})
    _write_csv(raw / "labels" / "tables" / "labels.csv", rows)
    crop_ids: dict = {}
    inner = PatientNamedReportProcessor._extract_id_from_pdf_crop

    def recorded(self, report_path, extractor):
        crop_ids[Path(report_path).stem] = inner(self, report_path, extractor)
        return crop_ids[Path(report_path).stem]

    total = dict.fromkeys(KERNEL_COUNTERS, 0)
    seconds = {}

    def run(*argv) -> dict:
        _zero_counts()
        start = time.perf_counter()
        rc = cli.cli(["--device", torch.device(device).type, *map(str, argv)])
        if on_card:
            torch.cuda.synchronize()
        seconds[" ".join(map(str, argv[:2]))] = time.perf_counter() - start
        counts = _counts()
        for key, n in counts.items():
            total[key] += n
        if rc != 0:
            raise AssertionError(f"{tag} {argv[:2]} returned {rc}")
        return counts

    pre = PreprocessConfig(data_path=raw, output_path=base / "interim" / "Phenikaa")
    PatientNamedReportProcessor._extract_id_from_pdf_crop = recorded
    try:
        run("dataset", "phenikaa", "--data-path", pre.data_path, "--output-path",
            pre.output_path)
    finally:
        PatientNamedReportProcessor._extract_id_from_pdf_crop = inner
    copied = sorted(p.name for p in pre.output_image_path.iterdir())
    if crop_ids != want_ids or copied != sorted(str(v) for v in want_ids.values()):
        raise AssertionError(f"{tag} dataset phenikaa: crop-path IDs {crop_ids}, want "
                             f"{want_ids}; copied {copied}")
    print(f"{tag} (3) dataset phenikaa: {len(want_ids)} patient-named PDF reports, every ID "
          f"read through the crop path ({sorted(crop_ids.values())}), each patient's study "
          f"folder copied among decoys, in {seconds['dataset phenikaa']:.2f} s on {card}")
    ckpt = root / "loc_run" / "best_model"
    _loc_checkpoint(device, ckpt)
    counts = run("dataset", "classification", "--base-path", base,
                 "--localization-model-path", ckpt, "--localization-backbone", "convnext_base",
                 "--device-batch-size", BUILD_BATCH, "--no-include-spider")
    n_series = 2 * len(want_ids)
    forwards = -(-n_series // BUILD_BATCH)
    out = builders.ClassificationDatasetConfig(base_path=base).output_path
    crops = _read_csv(out / "annotations.csv")
    if len(crops) != 5 * n_series or {r["patient_id"] for r in crops} != {
            str(v) for v in want_ids.values()}:
        raise AssertionError(f"{tag} dataset classification: {len(crops)} crops")
    if on_card and counts != {k: v * forwards for k, v in INFERENCE_LAUNCHES.items()}:
        raise AssertionError(f"{tag} dataset classification: launches {counts}, expected "
                             f"{INFERENCE_LAUNCHES} a forward over {forwards}")
    print(f"{tag} dataset classification: {n_series} series of the matched patients, "
          f"{len(crops)} crops in {seconds['dataset classification']:.2f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} } over {forwards} forward(s) on {card}")
    print(f"{tag} kernels " + json.dumps({"path": "pdf",
                                          "launches": {k: v for k, v in total.items() if v}}))
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": total, "page_ms": ms, "ocr_ms": ocr_ms, "seconds": seconds}


# The ocr phase: report OCR with the shipped weights on the card, held to the
# JAX package's record of the fixture pages (tests/fixtures/torch_ocr).
OCR_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_ocr"
OCR_REPS = 4  # bench.py:_ocr_pages_per_s: one warm-up, then 4 timed batches of 16 pages
OCR_STAGE_REPS = 5


def _host_ms(fn, reps: int = OCR_STAGE_REPS) -> tuple[float, object]:
    """Median wall ms of ``fn`` (ending in a synchronise) and its last result."""
    import torch

    times = []
    for _ in range(reps):
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return sorted(times)[len(times) // 2], out


def ocr_phase(device, card: str, profile: bool = False) -> dict:
    """``DocumentExtractor(device="cuda")`` with the shipped weights on the
    record's 16 bench pages (``extract_from_images``, one batch) and its two
    report files (``extract_lines``), held to the JAX record by
    ``utils/ocr_parity.py::check_against_record`` (box counts and quads
    within 2 px once threshold ties take JAX's decision, the CER of the lines
    against JAX's at most ``CER_BOUND``, the three report fields). Prints the
    CERs against the rendered truth, the card-vs-CPU gaps of the maps and
    logits, ``ocr_pages_per_s`` as ``bench.py`` defines it and the stage
    split; with ``profile``, the device's busy and idle share of a batch.
    Returns the launch counts of the checked run (no kernel of this package
    lies on the path: all zero)."""
    import numpy as np
    import torch

    from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor
    from spine_vision_torch.models.textdet import extract_boxes_from_probmap
    from spine_vision_torch.models.textrec import ctc_greedy_decode
    from spine_vision_torch.utils import ocr_parity

    tag = "[ocr]"
    t0 = time.perf_counter()
    extractor = DocumentExtractor(device=device)
    nets = (extractor.detector.model, extractor.recognizer.model)
    off_card = [n for net in nets for n, t in (*net.named_parameters(), *net.named_buffers())
                if t.device.type != "cuda"]
    if off_card:
        raise AssertionError(f"ocr: {len(off_card)} tensors off the card, e.g. {off_card[:3]}")
    pages = ocr_parity.load_record(OCR_FIXTURES)
    bench = [p.image for p in pages if p.file.startswith("bench_")]
    print(f"{tag} shipped weights on the card, {len(pages)} record pages read with data/png.py "
          f"in {time.perf_counter() - t0:.1f} s ({card})")

    _zero_counts()
    t0 = time.perf_counter()
    result = ocr_parity.check_against_record(extractor, pages)
    launches = _counts()
    print(f"{tag} checked run {time.perf_counter() - t0:.2f} s: {result['pages']} pages, "
          f"{result['boxes']} boxes (record {result['boxes_record']}), quads (ties resolved) "
          f"within {result['max_quad_px']:.4f} px of the record's (bound "
          f"{ocr_parity.QUAD_TOL_PX}), pages with threshold ties {result['tie_pages']}, "
          f"CER against the record {result['cer_vs_record']:.6f} over "
          f"{result['lines_paired']} lines (bound {ocr_parity.CER_BOUND})")
    print(f"{tag} fields: {json.dumps(result['fields'], ensure_ascii=False)}")
    print(f"{tag} printed only: CER against the rendered truth, card {result['cer_truth']:.6f}, "
          f"JAX record {result['cer_truth_record']:.6f}")
    if result["failures"]:
        raise AssertionError("ocr: " + "; ".join(result["failures"]))
    if any(launches.values()):
        raise AssertionError(f"ocr launched a kernel of the package: {launches}")

    cpu = DocumentExtractor(device="cpu")
    maps = extractor.detector.probability_maps(bench)
    quads = [extract_boxes_from_probmap(m) for m in maps]
    patches = extractor.rectify_pages(bench, quads)
    logits = extractor.recognizer.logits(patches)
    map_gap = np.abs(maps - cpu.detector.probability_maps(bench))
    logit_gap = np.abs(logits - cpu.recognizer.logits(patches.cpu()))
    print(f"{tag} printed only: card vs CPU, the port on the same pages: maps largest "
          f"{map_gap.max():.3e}, median {np.median(map_gap):.3e}; logits largest "
          f"{logit_gap.max():.3e}, median {np.median(logit_gap):.3e} (max |logit| "
          f"{np.abs(logits).max():.3f})")

    extractor.extract_from_images(bench)  # warm-up
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(OCR_REPS):
        out = extractor.extract_from_images(bench)
    elapsed = time.perf_counter() - start
    boxes = sum(len(t) for t in out)
    pages_s = len(bench) * OCR_REPS / elapsed
    print(f"{tag} ocr_pages_per_s {pages_s:.3f} ({len(bench)} pages x {OCR_REPS} batches in "
          f"{elapsed * 1e3:.3f} ms, {elapsed * 1e3 / OCR_REPS:.3f} ms a batch), boxes per page "
          f"{boxes / len(bench):.4f} ({card})")

    batch = torch.from_numpy(extractor.detector.prepare(bench)).to(device)[..., None]
    scaled = (patches / 255.0)[..., None]
    with torch.inference_mode():
        det_ms = _time_ms(lambda: extractor.detector.model(batch), iters=10)
        rec_ms = _time_ms(lambda: extractor.recognizer.model(scaled), iters=10)
    stages = {
        "host prep of the detector's input": _host_ms(lambda: extractor.detector.prepare(bench))[0],
        "detector forward (device)": det_ms,
        "upload, forward and fetch of the maps": _host_ms(
            lambda: extractor.detector.probability_maps(bench))[0],
        "connected components (host)": _host_ms(
            lambda: [extract_boxes_from_probmap(m) for m in maps])[0],
        "rectification (host stacking, upload, device)": _host_ms(
            lambda: extractor.rectify_pages(bench, quads))[0],
        "recognizer forward (device)": rec_ms,
        "recognizer forward and fetch of the logits": _host_ms(
            lambda: extractor.recognizer.logits(patches))[0],
        "CTC decode (host)": _host_ms(lambda: ctc_greedy_decode(logits))[0],
    }
    for name, ms in stages.items():
        print(f"{tag} stage {name}: {ms:.3f} ms a batch of {len(bench)} pages "
              f"({len(patches)} boxes)")
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            extractor.extract_from_images(bench)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - start) * 1e6
        events = _device_events(prof)
        busy_us = sum(_dev_us(e) for e in events)
        print(f"{tag} profile: traced wall {wall_us / 1e3:.3f} ms a batch, device busy "
              f"{busy_us / 1e3:.3f} ms, idle {1 - busy_us / wall_us:.1%} ({card})")
        for e in sorted(events, key=_dev_us, reverse=True)[:10]:
            print(f"{tag} profile: {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return launches


# The ocr_train phase: OCR training and evaluation (train/ocr.py) on the
# card. (a) The shipped weights on the port's rendered evaluation sets, each
# figure beside the JAX package's for the same function and seed (its CPU
# run) and held to OCR_CER_BANDS / OCR_RECALL_BANDS of it. (b) Short runs of
# both trainers at full width from seed 0, the mean of the last 5 losses at
# most OCR_LOSS_DROP of the first 5's. (c) One train step of each net on the
# card against the CPU from the same variables and batch: with every bf16
# rounding of the nets off (f32 arithmetic), the gradients within
# OCR_GRAD_WORST (worst tensor, difference over its norm; the attention's key
# biases, whose gradient is zero in exact arithmetic, printed apart) and
# OCR_GRAD_MEDIAN (median tensor) and the BatchNorm running statistics within OCR_STATS_TOL
# of each buffer's norm; with the roundings on (the trained arithmetic), a
# flip of one bf16 rounding of a convolution's input spreads through the
# layers after it (two convolution orders on one CPU, oneDNN's and
# PyTorch's own, already differ by 3e-3 to 2e-2 of a tensor's norm), so the
# card is held to the size of bf16's own rounding: its gaps to the CPU at
# most the CPU's bf16 step's gaps to its f32 step, worst, median and
# statistics. (d) The weights (b) wrote, read back by
# preprocess_phenikaa's loader into a DocumentExtractor on the card, read a
# report page.
OCR_JAX_CER = {"clean": 0.0689, "hard": 0.1318, "unseen_font": 0.1579}
OCR_JAX_RECALL = {"clean": 1.000, "hard": 0.988}
OCR_CER_BANDS = {"clean": 0.02, "hard": 0.03, "unseen_font": 0.03}
OCR_RECALL_BANDS = {"clean": 0.03, "hard": 0.03}
OCR_TRAIN_RUNS = {"recognizer": {"steps": 100, "chunk": 25, "batch_size": 64},
                  "detector": {"steps": 40, "chunk": 20, "batch_size": 16}}
OCR_WARM_STEPS = 5  # steps left out of the p50: cuDNN's autotuning, the first allocations
OCR_LOSS_DROP = 0.8
OCR_GRAD_WORST, OCR_GRAD_MEDIAN, OCR_STATS_TOL = 2e-2, 1e-3, 1e-5
OCR_STEP_BATCH = {"recognizer": 16, "detector": 4}


@functools.lru_cache(maxsize=1)
def _ocr_shipped():
    from spine_vision_torch.models.convert import load_variables_npz
    from spine_vision_torch.train import ocr

    return (load_variables_npz(ocr.DEFAULT_WEIGHTS_DIR / "ocr_recognizer.npz"),
            load_variables_npz(ocr.DEFAULT_WEIGHTS_DIR / "ocr_detector.npz"))


def ocr_eval_check(device, card: str) -> dict:
    """(a): the shipped weights through the port's evaluation functions."""
    from spine_vision_torch.data.phenikaa import synth
    from spine_vision_torch.train import ocr

    rec, det = _ocr_shipped()
    sets = {"clean": {}, "hard": {"degrade": "hard"},
            "unseen_font": {"fonts": synth.HOLDOUT_FONT_PATHS}}
    got, faults = {}, []
    for name, kw in sets.items():
        t0 = time.perf_counter()
        cer = ocr.evaluate_recognizer(None, rec, device=device, **kw)
        recall = ocr.evaluate_detector(None, det, device=device, **kw)
        got[name] = {"cer": cer, "recall": recall}
        line = (f"[ocr_train] shipped weights, {name}: recognizer CER {cer:.6f} (JAX "
                f"{OCR_JAX_CER[name]}, band {OCR_CER_BANDS[name]}), detector recall "
                f"{recall:.6f}")
        line += (f" (JAX {OCR_JAX_RECALL[name]}, band {OCR_RECALL_BANDS[name]})"
                 if name in OCR_JAX_RECALL else " (printed only: no JAX figure)")
        print(f"{line}; {time.perf_counter() - t0:.1f} s ({card})")
        if abs(cer - OCR_JAX_CER[name]) > OCR_CER_BANDS[name]:
            faults.append(f"{name} CER {cer}")
        if name in OCR_JAX_RECALL and abs(recall - OCR_JAX_RECALL[name]) > OCR_RECALL_BANDS[name]:
            faults.append(f"{name} recall {recall}")
    t0 = time.perf_counter()
    layout = ocr.evaluate_layout_extraction(det, rec, n_pages=5, device=device)
    got["layout_extraction_rate"] = layout
    print(f"[ocr_train] shipped weights, unseen-layout extraction over 5 pages: {layout} "
          f"(JAX 1.0); {time.perf_counter() - t0:.1f} s")
    if layout < 0.8:
        faults.append(f"layout extraction {layout}")
    if faults:
        raise AssertionError("ocr_train evaluation outside its bands: " + "; ".join(faults))
    return got


class _StepClock:
    """CUDA events around each update of ``train/ocr.py`` (its ``_update``),
    the losses, and the wall time of each call of the named chunk renderers."""

    def __init__(self, ocr, *render_names: str):
        import torch

        self.torch, self.ocr = torch, ocr
        self.events, self.losses = [], []
        self.render_s = {name: [] for name in render_names}
        self.saved = {name: getattr(ocr, name) for name in ("_update", *render_names)}

    def __enter__(self):
        def update(*args):
            start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            loss = self.saved["_update"](*args)
            end.record()
            self.events.append((start, end))
            self.losses.append(loss)
            return loss

        def render(name):
            def run(*args):
                t0 = time.perf_counter()
                out = self.saved[name](*args)
                self.render_s[name].append(time.perf_counter() - t0)
                return out
            return run

        self.ocr._update = update
        for name in self.render_s:
            setattr(self.ocr, name, render(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ocr, name, fn)

    def step_ms(self) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _ocr_train_run(which: str, device, card: str, profile: bool, out: Path, **kw) -> dict:
    """One trainer's run with its steps timed; returns its figures."""
    import numpy as np
    import torch

    from spine_vision_torch.train import ocr

    train = ocr.train_recognizer if which == "recognizer" else ocr.train_detector
    render = "_render_chunk_recognition" if which == "recognizer" else "_render_chunk_detection"
    torch.cuda.reset_peak_memory_stats()
    prof = None
    with _StepClock(ocr, render) as clock:
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        variables, metric = train(seed=0, output_path=out / f"ocr_{which}.npz", device=device,
                                  **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
    steps = clock.step_ms()
    losses = [float(x) for x in clock.losses]
    timed = sorted(steps[OCR_WARM_STEPS:])
    p50 = timed[len(timed) // 2]
    render_s = clock.render_s[render]
    figures = {"wall_s": wall, "metric": metric, "losses": losses, "step_ms": steps,
               "render_s": render_s, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"[ocr_train] {which}: {len(steps)} steps ({kw}) in {wall:.1f} s; loss first 5 "
          f"{first:.4f}, last 5 {last:.4f} (bound {OCR_LOSS_DROP} x first); held-out "
          f"{'CER' if which == 'recognizer' else 'box recall'} {metric:.4f}")
    print(f"[ocr_train] {which}{' (under the profiler)' if profile else ''}: step p50 "
          f"{p50:.3f} ms, p10 {timed[len(timed) // 10]:.3f}, "
          f"p90 {timed[len(timed) * 9 // 10]:.3f}, min {timed[0]:.3f}, max {timed[-1]:.3f} "
          f"(CUDA events, {len(timed)} steps after {OCR_WARM_STEPS}); render "
          f"{np.mean(render_s) * 1e3:.1f} ms a chunk of {kw['chunk']} batches "
          f"({len(render_s)} chunks, {sum(render_s):.1f} s); steps "
          f"{sum(steps) / 1e3:.1f} s; peak {figures['peak_gib']:.3f} GiB ({card})")
    if prof is not None:
        busy_us = sum(_dev_us(e) for e in _device_events(prof))
        figures["idle_share"] = 1 - busy_us / (wall * 1e6)
        print(f"[ocr_train] {which} profile: device busy {busy_us / 1e6:.3f} s of the run's "
              f"{wall:.3f} s wall, idle {figures['idle_share']:.1%} ({card})")
        for e in sorted(_device_events(prof), key=_dev_us, reverse=True)[:8]:
            print(f"[ocr_train] {which} profile: {_dev_us(e) / 1e3:10.3f} ms x{e.count:<6d} "
                  f"{e.key[:80]}")
    if not all(np.isfinite(losses)) or last > OCR_LOSS_DROP * first:
        raise AssertionError(f"ocr_train {which}: losses {first} -> {last}")
    return figures


@contextlib.contextmanager
def _ocr_f32_arithmetic():
    """The OCR nets with every bf16 rounding off (and the tanh-GELU in f32):
    the same graph in f32, for the card-against-CPU check of its structure."""
    import torch

    from spine_vision_torch.models import layers, textdet, textrec

    def same(x):
        return x

    patches = [(layers, "bf16_input", same), (layers, "bf16_round", same),
               (layers, "bf16_grad", same), (textdet, "bf16_input", same),
               (textrec, "bf16_input", same), (textrec, "bf16_round", same),
               (textrec, "_gelu_tanh_bf16",
                lambda x: torch.nn.functional.gelu(x, approximate="tanh"))]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, v in patches:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _ocr_step(which: str, device, variables, batch) -> tuple:
    """One train-mode forward and backward from ``variables``: (gradients,
    running statistics after it) as flat numpy dicts."""
    import numpy as np
    import torch

    from spine_vision_torch.models.convert import export_flax_variables, load_flax_variables
    from spine_vision_torch.models.textdet import TextDetectionNet
    from spine_vision_torch.models.textrec import TextRecognitionNet
    from spine_vision_torch.train import ocr

    if which == "recognizer":
        net = TextRecognitionNet(param_dtype=torch.float32, device=device)
    else:
        net = TextDetectionNet(param_dtype=torch.float32, device=device)
    load_flax_variables(net, variables["params"], variables["batch_stats"])
    args = [torch.from_numpy(a).to(device) for a in batch]
    with ocr._tf32_off():
        loss = (ocr.recognizer_loss(net, *args) if which == "recognizer"
                else ocr.detector_loss(net, *args))
        loss.backward()
    grads, _ = export_flax_variables(net, grads=True)
    _, stats = export_flax_variables(net)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}") if isinstance(v, dict)
                       else {f"{prefix}/{k}": np.asarray(v)})
        return out

    return flat(grads), flat(stats)


def _step_gaps(got: dict, got_stats: dict, want: dict, want_stats: dict) -> tuple:
    """(worst, median) of the gradients' differences over their norms, and
    the worst running statistic's largest difference over its norm."""
    import numpy as np

    gaps = _norm_gaps(got, want)
    stats = max(float(np.abs(got_stats[k] - want_stats[k]).max() / np.linalg.norm(want_stats[k]))
                for k in want_stats)
    return max(gaps.values()), float(np.median(list(gaps.values()))), stats


def _norm_gaps(got: dict, want: dict) -> dict:
    """Each gradient's difference over its norm, but the attention's key
    biases: softmax ignores a constant added to a query's logits, so their
    gradient is zero in exact arithmetic and what either side computes is
    rounding alone (printed apart)."""
    import numpy as np

    return {k: float(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30))
            for k in want if not k.endswith("/key/bias")}


def ocr_grad_check(device, nets=("recognizer", "detector")) -> None:
    """(c): one step of each net on the card against the CPU."""
    import numpy as np
    import torch

    from spine_vision_torch.train import ocr

    for which in nets:
        rng = np.random.default_rng(5)
        n = OCR_STEP_BATCH[which]
        if which == "recognizer":
            images, ids, pads = ocr._render_chunk_recognition(rng, 1, n, 256, 40)
            batch = ((images[0] / 255.0).astype(np.float32)[..., None], ids[0], pads[0])
            variables = ocr._variables(ocr._init_recognizer(0, 256, torch.device("cpu")))
        else:
            pages, targets = ocr._render_chunk_detection(rng, 1, n, (320, 448))
            batch = ((pages[0] / 255.0).astype(np.float32)[..., None], targets[0])
            variables = ocr._variables(ocr._init_detector(0, torch.device("cpu")))
        with _ocr_f32_arithmetic():
            card_f, card_fs = _ocr_step(which, device, variables, batch)
            cpu_f, cpu_fs = _ocr_step(which, torch.device("cpu"), variables, batch)
        key_bias = [float(np.abs(card_f[k]).max()) for k in card_f if k.endswith("/key/bias")]
        if key_bias:
            print(f"[ocr_train] grad check {which}: key biases (zero in exact arithmetic) "
                  f"largest |gradient| {max(key_bias):.3e} on the card")
        f32 = _step_gaps(card_f, card_fs, cpu_f, cpu_fs)
        print(f"[ocr_train] grad check {which} (batch {n}), f32 arithmetic: gradients worst "
              f"{f32[0]:.3e} of the norm (bound {OCR_GRAD_WORST}), median {f32[1]:.3e} (bound "
              f"{OCR_GRAD_MEDIAN}); running statistics worst {f32[2]:.3e} of a buffer's norm "
              f"(bound {OCR_STATS_TOL})")
        if f32[0] > OCR_GRAD_WORST or f32[1] > OCR_GRAD_MEDIAN or f32[2] > OCR_STATS_TOL:
            raise AssertionError(f"ocr_train {which}: f32 card-vs-CPU step outside its bounds")

        card_g, card_s = _ocr_step(which, device, variables, batch)
        cpu_g, cpu_s = _ocr_step(which, torch.device("cpu"), variables, batch)
        torch.backends.mkldnn.enabled = False
        try:
            alt_g, alt_s = _ocr_step(which, torch.device("cpu"), variables, batch)
        finally:
            torch.backends.mkldnn.enabled = True
        card = _step_gaps(card_g, card_s, cpu_g, cpu_s)
        bf16 = _step_gaps(cpu_g, cpu_s, cpu_f, cpu_fs)  # the size of bf16's own rounding
        order = _step_gaps(alt_g, alt_s, cpu_g, cpu_s)
        print(f"[ocr_train] grad check {which}, bf16 arithmetic (worst, median, statistics): "
              f"card vs CPU {card[0]:.3e}, {card[1]:.3e}, {card[2]:.3e}; bound, the CPU's bf16 "
              f"vs its f32 {bf16[0]:.3e}, {bf16[1]:.3e}, {bf16[2]:.3e}; printed only, the "
              f"CPU's two convolution orders {order[0]:.3e}, {order[1]:.3e}, {order[2]:.3e}")
        if any(c > b for c, b in zip(card, bf16)):
            raise AssertionError(f"ocr_train {which}: bf16 card-vs-CPU step outside its bounds")


def ocr_train_phase(device, card: str, profile: bool = False) -> dict:
    """(a)-(d) of the ocr_train phase; returns the launch counts of the
    training runs (no kernel of this package lies on the path: all zero)."""
    from spine_vision_torch.data.phenikaa import PreprocessConfig, _build_extractor

    out = RUN_DIR / "ocr_train"
    shutil.rmtree(out, ignore_errors=True)
    ocr_eval_check(device, card)
    _zero_counts()
    for which, kw in OCR_TRAIN_RUNS.items():
        _ocr_train_run(which, device, card, profile, out, **kw)
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"ocr_train launched a kernel of the package: {launches}")
    ocr_grad_check(device)
    config = PreprocessConfig(data_path=out, detection_checkpoint=out / "ocr_detector.npz",
                              recognition_checkpoint=out / "ocr_recognizer.npz")
    extractor = _build_extractor(config, device=device)
    if not all(p.device.type == "cuda" for net in (extractor.detector.model,
                                                  extractor.recognizer.model)
               for p in net.parameters()):
        raise AssertionError("ocr_train: the trained nets are not on the card")
    lines = extractor.extract_lines(OCR_FIXTURES / "report_clean.png")
    print(f"[ocr_train] the trained .npz through preprocess_phenikaa's loader on the card: "
          f"{len(lines)} lines from report_clean.png, e.g. "
          f"{[t for t, _ in lines[:3]]!r} (fields not bounded after so few steps)")
    shutil.rmtree(out, ignore_errors=True)
    return launches


def ocr_train_full(device, card: str) -> dict:
    """(e): ``train_ocr_stack`` at the JAX package's defaults (4000 and 1200
    steps): every metric, each part's wall time, the trainers' step and
    render times and the share of the wall the card spent in steps."""
    import numpy as np

    from spine_vision_torch.train import ocr

    out = RUN_DIR / "ocr_train_full"
    shutil.rmtree(out, ignore_errors=True)
    parts: dict = {}
    names = ("train_recognizer", "train_detector", "evaluate_recognizer",
             "evaluate_detector", "evaluate_layout_extraction", "evaluate_recognizer_mpl")
    saved = {n: getattr(ocr, n) for n in names}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return run

    for n in names:
        setattr(ocr, n, timed(n, saved[n]))
    try:
        with _StepClock(ocr, "_render_chunk_recognition", "_render_chunk_detection") as clock:
            t0 = time.perf_counter()
            metrics = ocr.train_ocr_stack(out, device=device)
            wall = time.perf_counter() - t0
            clocks = {"steps": clock.step_ms(),
                      "rec_render": clock.render_s["_render_chunk_recognition"],
                      "det_render": clock.render_s["_render_chunk_detection"]}
    finally:
        for n, fn in saved.items():
            setattr(ocr, n, fn)
    print(f"[ocr_train_full] train_ocr_stack at the JAX defaults in {wall:.1f} s ({card})")
    print(f"[ocr_train_full] metrics {json.dumps(metrics)}")
    for name, s in parts.items():
        print(f"[ocr_train_full] part {name}: {s:.1f} s")
    steps = clocks["steps"]
    train_s = parts["train_recognizer"] + parts["train_detector"]
    print(f"[ocr_train_full] {len(steps)} steps: {sum(steps) / 1e3:.1f} s in steps (CUDA "
          f"events), step p50 {np.median(steps):.3f} ms; render {sum(clocks['rec_render']):.1f} "
          f"s for the recognizer's {len(clocks['rec_render'])} chunks, "
          f"{sum(clocks['det_render']):.1f} s for the detector's "
          f"{len(clocks['det_render'])}; the card in steps {sum(steps) / 1e3 / train_s:.1%} of "
          f"the trainers' {train_s:.1f} s")
    if metrics["recognizer_cer"] > 0.15 or metrics["detector_box_recall"] < 0.9:
        print("[ocr_train_full] FAULT: below the bars of a trainer that learns "
              "(recognizer CER <= 0.15, detector recall >= 0.9)")
    return metrics


# The data-parallel phase (``ddp``). Its ranks are this script run again with
# ``--ddp-rank <spec>``, each a process of its own. The world-size-1 rank
# trains DDP_STEPS steps without a process group and then the same steps
# through DistributedDataParallel over NCCL: bit for bit the same. The two
# ranks on cuda:0 (gloo: NCCL refuses two ranks on one device) train the
# same global batches split in two; their parameters after DDP_CHECK_STEPS
# steps are held to the single process's by tests/test_torch_multiprocess.py's
# rule: every element within 2 lr a step, and the share of elements off by
# more than lr / 5 (those whose gradient sits within the gradients' error of
# 0, where Adam's update can take any sign) at most a bound. Adam's update
# hardly sees a gradient's scale, so the first step's reduced gradients are
# held too, each parameter's difference over its norm, worst and median:
# for the bf16 ConvNeXt within GRAD_REL_TOL (the card-against-CPU checks'
# tolerance); for the ResNet-18, which trains in f32 here so that its
# synced BatchNorm is held at f32's rounding, within the DDP_CLS_* bounds,
# set from the readings of a sound run. The ResNet's BatchNorm running
# statistics after the first step, 0.9 of their start plus 0.1 of that
# step's batch moments, are the direct witness of global statistics: each
# buffer's difference over its norm within DDP_BN_TOL. A control run of the
# ResNet on the two ranks with its BatchNorms' process group unset (each
# rank normalising with its own half's statistics, the fault a plain DDP
# wrap has) must fail the statistics and the gradient-median bounds.
DDP_STEPS = 6  # the world-size-1 runs: the step p50 over the steps after the first
DDP_CHECK_STEPS = 2
DDP_LR = 1e-4  # the localization trainer's default, held constant
DDP_CLS_LR = 1e-3
# Sound two-rank ResNet-18 runs read (my chip runs, H100): gradients worst
# 2.41e-3 of the norm (a stage-1 BatchNorm bias whose gradient is near 0),
# median 8.65e-7; after 2 steps 1.105e-2 of the elements off by more than
# lr / 5, largest gap 2.015e-3 (step 1 flips the updates of a few BatchNorm
# scales and biases whose f32 gradients sit within rounding of 0, and those
# channels move every gradient of step 2); running statistics after step 1
# worst 1.21e-6 of a buffer's norm, median 1.47e-7. The control with each
# rank's own statistics read: gradients worst 0.297, median 3.29e-3;
# statistics worst 8.08e-2, median 9.17e-4; share 0.157.
DDP_CLS_GRAD_WORST = 1e-2
DDP_CLS_GRAD_MEDIAN = 1e-5
DDP_CLS_SHARE = 5e-2
DDP_BN_TOL = 1e-5
DDP_TIMEOUT_S = 600
# The models and batches: the train phase's (ConvNeXt-base at 512^2, global
# batch 32, the hybrid block, augmentation and dropout) and the cls_train
# phase's (ResNet-18 at 256^2, global batch 256, 8 tasks, BatchNorm synced
# over the ranks).
DDP_SHAPES = {"backbone": "convnext_base", "hw": 512, "batch": TRAIN_BATCH,
              "cls_hw": CLS_HW, "cls_batch": CLS_BATCH}
DDP_STUDIES = 8


@functools.lru_cache(maxsize=2)
def _ddp_data(name: str, n: int, hw: int):
    """The ddp phase's samples for ``name``, made once a process."""
    return _Images(n, hw, 40) if name == "convnext" else _Grades(n, hw, 30)


def _ddp_trainer(spec: dict, name: str, run: Path, distributed: bool, model=None):
    """The ddp phase's trainer ``name`` ("convnext", or "resnet" and its
    control "resnet_local") on the rank's device, its global batch from
    ``spec``; the model is ``model`` when given (a copy of a seeded one)."""
    import torch

    from spine_vision_torch.train.classification import (
        ClassificationConfig,
        ClassificationTrainer,
    )
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    device = torch.device(spec["device"])
    common = dict(num_epochs=1, output_path=run, num_workers=8, pretrained=False, seed=0,
                  scheduler_type="none", early_stopping=False, profile_steps=True,
                  mixed_precision=True, distributed=distributed)
    shutil.rmtree(run, ignore_errors=True)
    if name == "convnext":
        hw, batch = spec["hw"], spec["batch"]
        cfg = LocalizationConfig(backbone=spec["backbone"], image_size=(hw, hw), batch_size=batch,
                                 augment=True, dropout=0.2, learning_rate=DDP_LR, **common)
        if model is None:
            model = _regressor(device, seed=0, dropout=0.2, backbone=spec["backbone"])
        return LocalizationTrainer(cfg, model=model, val_dataset=[], device=device,
                                   train_dataset=_ddp_data(name, DDP_STEPS * batch, hw))
    hw, batch = spec["cls_hw"], spec["cls_batch"]
    cfg = ClassificationConfig(backbone="resnet18", output_size=(hw, hw), batch_size=batch,
                               augment=True, dropout=0.3, use_weighted_sampling=True,
                               learning_rate=DDP_CLS_LR, **{**common, "mixed_precision": False})
    trainer = ClassificationTrainer(
        cfg, model=model, val_dataset=[], device=device,
        train_dataset=_ddp_data("resnet", DDP_CHECK_STEPS * batch, hw))
    if name == "resnet_local":
        from spine_vision_torch.ops.batchnorm import BatchNorm

        for module in trainer.model.modules():
            if isinstance(module, BatchNorm):
                module.process_group = None
    return trainer


def _ddp_run(spec: dict, name: str, run: Path, distributed: bool, model=None) -> dict:
    """``train()`` of one ddp trainer: each step's launch counts, the step
    times, the history, the first step's reduced gradients and BatchNorm
    running statistics, the parameters and buffers after DDP_CHECK_STEPS
    steps and at the end (on the host), and the run's wall seconds."""
    import torch

    t0 = time.perf_counter()
    trainer = _ddp_trainer(spec, name, run, distributed, model)
    del model
    counts, snapshot, grads, stats = [], {}, {}, {}
    inner = trainer.train_step_fn

    def step(state, batch):
        _zero_counts()
        loss = inner(state, batch)
        counts.append(_counts())
        if len(counts) == 1:
            grads.update({k: p.grad.detach().float().cpu().clone()
                          for k, p in trainer.model.named_parameters()})
            stats.update({k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()
                          if k.endswith((".mean", ".var"))})
        if len(counts) == DDP_CHECK_STEPS:
            snapshot.update({k: v.detach().cpu().clone()
                             for k, v in trainer.model.state_dict().items()})
        return loss

    trainer.train_step_fn = step
    result = trainer.train()
    final = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    out = {"history": result.history, "step_ms": [t * 1e3 for t in trainer.step_times],
           "counts": counts, "snapshot": snapshot, "final": final, "grads": grads,
           "stats": stats, "replica": trainer.state.replica is not None,
           "world": trainer.mesh_ctx.world_size}
    del trainer, result
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    shutil.rmtree(run, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def _same_tensors(a: dict, b: dict) -> list:
    """The names whose tensors differ (bit for bit) between ``a`` and ``b``."""
    import torch

    return [k for k in a if not torch.equal(a[k], b[k])]


def ddp_rank(spec: dict) -> None:
    """One rank of the ddp phase. World size 1: each trainer without a group,
    then through DDP (a group of one over ``spec["backend"]``), which must be
    bit for bit the same; the plain runs' snapshots are saved for the
    two-rank comparison. World size 2: each trainer through DDP over gloo;
    rank 0 saves its snapshots. Every rank writes its report."""
    import torch
    import torch.distributed as dist

    from spine_vision_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # two runs of one process, bit for bit
    out, world, rank = Path(spec["out"]), spec["world"], spec["rank"]
    report = {}
    names = ("convnext", "resnet")
    address = f"127.0.0.1:{spec['port']}"
    if world == 1:
        # The seeded models, built once each: the plain runs train copies.
        t0 = time.perf_counter()
        seeded = {"convnext": _regressor(torch.device(spec["device"]), seed=0, dropout=0.2,
                                         backbone=spec["backbone"]),
                  "resnet": _ddp_trainer(spec, "resnet", out / "build", False).model}
        shutil.rmtree(out / "build", ignore_errors=True)
        print(f"[ddp] one rank: models built in {time.perf_counter() - t0:.1f} s", flush=True)
        plain = {n: _ddp_run(spec, n, out / f"plain_{n}", distributed=False,
                             model=copy.deepcopy(seeded[n])) for n in names}
        if not initialize_distributed(address, 1, 0, backend=spec["backend"]):
            raise RuntimeError("ddp rank: a process group existed before the DDP runs")
        for n in names:
            ddp = _ddp_run(spec, n, out / f"ddp1_{n}", distributed=True, model=seeded.pop(n))
            if plain[n]["replica"] or not ddp["replica"] or ddp["world"] != 1:
                raise AssertionError(f"{n}: the plain run has a replica or the DDP run none")
            differ = (_same_tensors(plain[n]["grads"], ddp["grads"])
                      + _same_tensors(plain[n]["stats"], ddp["stats"])
                      + _same_tensors(plain[n]["snapshot"], ddp["snapshot"])
                      + _same_tensors(plain[n]["final"], ddp["final"]))
            if differ or plain[n]["history"] != ddp["history"]:
                raise AssertionError(f"{n}: DDP over one rank differs from the plain run: "
                                     f"{differ[:5]}, {plain[n]['history']} vs {ddp['history']}")
            torch.save({"params": plain[n]["snapshot"], "grads": plain[n]["grads"],
                        "stats": plain[n]["stats"]}, out / f"plain_{n}.pt")
            report[n] = {k: {"step_ms": r["step_ms"], "counts": r["counts"],
                             "history": r["history"]}
                         for k, r in (("plain", plain[n]), ("ddp", ddp))}
            print(f"[ddp] {n}: DDP over one rank ({spec['backend']}) equals the plain run bit "
                  f"for bit: the first step's gradients, {len(ddp['final'])} parameters and "
                  f"buffers after {DDP_CHECK_STEPS} and {len(ddp['step_ms'])} steps, losses "
                  f"{ddp['history']['train_loss']}; runs {plain[n]['seconds']:.1f} s plain, "
                  f"{ddp['seconds']:.1f} s DDP", flush=True)
    else:
        if not initialize_distributed(address, world, rank, backend="gloo"):
            raise RuntimeError("ddp rank: a process group existed before the DDP runs")
        for n in (*names, "resnet_local"):
            r = _ddp_run(spec, n, out / f"ddp{world}_{n}", distributed=True)
            if r["world"] != world or not r["replica"]:
                raise AssertionError(f"{n}: rank {rank} trained without its group")
            if rank == 0:
                torch.save({"params": r["snapshot"], "grads": r["grads"], "stats": r["stats"]},
                           out / f"ddp{world}_{n}.pt")
                print(f"[ddp] two ranks: {n} run {r['seconds']:.1f} s", flush=True)
            report[n] = {"step_ms": r["step_ms"], "counts": r["counts"], "history": r["history"]}
        dist.barrier()
    (out / f"rank{rank}_of_{world}.json").write_text(json.dumps(report))
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(spec: dict, world: int) -> list:
    """Start ``world`` ranks of the ddp phase and wait for them; a rank's
    non-zero exit (or the time limit) raises. Returns their outputs."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ddp-rank",
         json.dumps({**spec, "world": world, "rank": rank, "port": port})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DDP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        for line in log.splitlines():
            if line.startswith("[ddp]"):
                print(line)
        if p.returncode != 0:
            raise RuntimeError(f"ddp rank {rank} of {world} exited {p.returncode}:\n"
                               f"{log[-6000:]}")
    return logs


def _rel_errs(got: dict, want: dict) -> dict:
    """Each tensor's difference over its norm (f32)."""
    return {k: float((got[k].float() - w.float()).norm() / max(float(w.float().norm()), 1e-30))
            for k, w in want.items()}


def _ddp_compare(got: dict, want: dict, lr: float, steps: int, tols: tuple) -> tuple:
    """Two ranks' rank 0 against the single process: each parameter's
    first-step gradient (the norm of the difference over the norm; worst and
    median within ``tols[:2]``), the BatchNorm running statistics after the
    first step (each buffer's within ``tols[3]``; none in a ConvNeXt), and
    the parameters after ``steps`` steps by
    ``tests/test_torch_multiprocess.py::check_adam_params``'s rule (every
    element within 2 lr a step; the share off by more than lr / 5, the
    elements whose gradient sits within the gradients' error of 0, at most
    ``tols[2]``). Returns (numbers, failures)."""
    import numpy as np

    errs = _rel_errs(got["grads"], want["grads"])
    stats = _rel_errs(got["stats"], want["stats"])
    params = [k for k, w in want["params"].items()
              if w.is_floating_point() and not k.endswith((".mean", ".var"))]
    gaps = {k: (got["params"][k].float() - want["params"][k].float()).abs() for k in params}
    off = {k: int((g > 0.2 * lr).sum()) for k, g in gaps.items()}
    n = {
        "grad_worst": max(errs.values()), "grad_worst_at": max(errs, key=errs.get),
        "grad_median": float(np.median(list(errs.values()))),
        "largest": max(float(g.max()) for g in gaps.values()),
        "share": sum(off.values()) / sum(g.numel() for g in gaps.values()),
        "most_off": sorted(((v / gaps[k].numel(), k) for k, v in off.items()), reverse=True)[:3],
        "stats_worst": max(stats.values(), default=0.0),
        "stats_worst_at": max(stats, key=stats.get, default=None),
        "stats_median": float(np.median(list(stats.values()))) if stats else 0.0,
    }
    failures = []
    if n["grad_worst"] > tols[0] or n["grad_median"] > tols[1]:
        failures.append(f"first-step gradients worst {n['grad_worst']:.3e}, median "
                        f"{n['grad_median']:.3e} (bounds {tols[:2]})")
    if n["stats_worst"] > tols[3]:
        failures.append(f"BatchNorm running statistics after the first step worst "
                        f"{n['stats_worst']:.3e} ({n['stats_worst_at']}; bound {tols[3]})")
    if n["largest"] > 2 * lr * steps or n["share"] > tols[2]:
        failures.append(f"parameters: largest gap {n['largest']:.3e} (bound "
                        f"{2 * lr * steps:.1e}), share off by more than lr/5 {n['share']:.3e} "
                        f"(bound {tols[2]})")
    return n, failures


def _cls_checkpoint(device, path: Path) -> None:
    """A seeded ResNet-18 Classifier (f32 parameters, bf16 compute) saved with
    the port's ``save_checkpoint``."""
    import torch

    from spine_vision_torch.models.classifier import Classifier
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
    from spine_vision_torch.train.checkpoint import save_checkpoint
    from spine_vision_torch.train.state import TrainState

    model = Classifier("resnet18", dtype=torch.bfloat16, device=device, param_dtype=torch.float32)
    load_flax_variables(model, *random_flax_variables(model, 1))
    state = TrainState(model=model, optimizer=torch.optim.AdamW(model.parameters()),
                       schedule=lambda step: 1e-4, generator=torch.Generator())
    save_checkpoint(path, state, {"epoch": 0})


def ddp_phase(device, card: str) -> dict:
    """Data parallelism (``--ddp-only`` runs it alone; see ``ddp_rank``).

    (a) One rank over NCCL: the train phase's ConvNeXt-base (hybrid block,
    512^2, batch 32, bf16, augmentation and dropout) for DDP_STEPS steps and
    the cls_train phase's ResNet-18 (256^2, batch 256, here in f32) for 2,
    each through ``train()`` without a group and then through
    DistributedDataParallel: bit for bit the same first-step gradients,
    parameters, buffers and losses (cuDNN's deterministic algorithms in
    both). (b) Two ranks on the one card over gloo, each half of the same
    global batches: rank 0's first-step gradients and BatchNorm running
    statistics and its parameters after DDP_CHECK_STEPS steps within
    ``_ddp_compare``'s bounds of the single process's, both ranks' losses
    the same; the ResNet's control run with each rank's own statistics
    outside them. (c)
    ``StudyInferencePipeline.from_checkpoints(mesh=data_parallel_mesh())``
    on the 8 studies: bit for bit the ``mesh=None`` results, with the study
    phase's launches a forward. Returns the launch counts of one DDP step
    and one pipeline forward, summed."""
    import torch

    from spine_vision_torch.infer.pipeline import StudyInferencePipeline
    from spine_vision_torch.ops import cuda_build
    from spine_vision_torch.parallel import data_parallel_mesh

    tag = "[ddp]"
    t_phase = time.perf_counter()
    cuda_build.build_all()  # the ranks load the built kernels
    out = RUN_DIR / "ddp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    spec = {"out": str(out), "device": f"{device.type}:0" if device.type == "cuda" else "cpu",
            "backend": "nccl" if device.type == "cuda" else "gloo", **DDP_SHAPES}
    t0 = time.perf_counter()
    _spawn_ranks(spec, 1)
    one = json.loads((out / "rank0_of_1.json").read_text())
    t_one = time.perf_counter() - t0
    print(f"{tag} one rank: {t_one:.1f} s with its process's start")
    t0 = time.perf_counter()
    _spawn_ranks(spec, 2)
    two = [json.loads((out / f"rank{r}_of_2.json").read_text()) for r in range(2)]
    t_two = time.perf_counter() - t0

    step = one["convnext"]["ddp"]["counts"]
    if any(c != TRAIN_LAUNCHES["train_step"] for c in step):
        raise AssertionError(f"a DDP step's launches {step[0]}, expected "
                             f"{TRAIN_LAUNCHES['train_step']}")
    if any(c != TRAIN_LAUNCHES["train_step"] for r in two for c in r["convnext"]["counts"]):
        raise AssertionError("a two-rank DDP step did not launch the hybrid block's kernels")
    failures = []
    cls_tols = (DDP_CLS_GRAD_WORST, DDP_CLS_GRAD_MEDIAN, DDP_CLS_SHARE, DDP_BN_TOL)
    for name, lr, tols in (("convnext", DDP_LR, (GRAD_REL_TOL,) * 3 + (DDP_BN_TOL,)),
                           ("resnet", DDP_CLS_LR, cls_tols),
                           ("resnet_local", DDP_CLS_LR, cls_tols)):
        if two[0][name]["history"] != two[1][name]["history"]:
            failures.append(f"{name}: the ranks logged different losses: "
                            f"{two[0][name]['history']} vs {two[1][name]['history']}")
        got = torch.load(out / f"ddp2_{name}.pt", weights_only=True)
        plain = name.removesuffix("_local")
        want = torch.load(out / f"plain_{plain}.pt", weights_only=True)
        n, failed = _ddp_compare(got, want, lr, DDP_CHECK_STEPS, tols)
        if name == "resnet_local":
            # The control: local statistics must fail the statistics and the
            # gradient-median bounds.
            if n["stats_worst"] <= tols[3] or n["grad_median"] <= tols[1]:
                failures.append(f"{name}: the control with local BatchNorm statistics passed "
                                f"the bounds that must catch it: {failed}")
        else:
            failures += [f"{name}: {f}" for f in failed]
        what = (f"{spec['backbone']} {spec['hw']}^2 b{spec['batch']} bf16" if name == "convnext"
                else f"resnet18 {spec['cls_hw']}^2 b{spec['cls_batch']} f32")
        if name == "resnet_local":
            what += ", the control: BatchNorm statistics of each rank's own half"
        print(f"{tag} {name} ({what}) two ranks on one card over gloo against one process: "
              f"first-step gradients worst {n['grad_worst']:.4e} of the norm "
              f"({n['grad_worst_at']}), median {n['grad_median']:.4e} (bounds {tols[0]}, "
              f"{tols[1]}); BatchNorm running statistics after step 1 worst "
              f"{n['stats_worst']:.4e} ({n['stats_worst_at']}), median {n['stats_median']:.4e} "
              f"(bound {tols[3]}); after {DDP_CHECK_STEPS} steps at lr {lr}: largest parameter "
              f"gap {n['largest']:.4e} (bound {2 * lr * DDP_CHECK_STEPS:.1e}), share of elements "
              f"off by more than lr/5 {n['share']:.4e} (bound {tols[2]}; most in "
              f"{[(k, round(v, 5)) for v, k in n['most_off']]}); losses two ranks "
              f"{two[0][name]['history']['train_loss']}, one process "
              f"{one[plain]['plain']['history']['train_loss']}"
              + (f"; failed as it must: {failed}" if name == "resnet_local" else ""))
    import numpy as np

    plain_p50 = float(np.percentile(one["convnext"]["plain"]["step_ms"][1:], 50))
    ddp_p50 = float(np.percentile(one["convnext"]["ddp"]["step_ms"][1:], 50))
    two_p50 = float(np.percentile(two[0]["convnext"]["step_ms"][1:], 50))
    print(f"{tag} ConvNeXt-base 512^2 b{spec['batch']} hybrid train step p50: DDP over one rank "
          f"(NCCL) {ddp_p50:.3f} ms beside the plain step {plain_p50:.3f} ms "
          f"({ddp_p50 / plain_p50 - 1:+.2%}); two ranks of b{spec['batch'] // 2} on the one card "
          f"over gloo {two_p50:.3f} ms (printed only: gloo stages the gradients through the host); "
          f"{len(one['convnext']['ddp']['step_ms']) - 1} steps after the first each; on {card}")
    cls_plain = float(np.percentile(one["resnet"]["plain"]["step_ms"][1:], 50))
    cls_ddp = float(np.percentile(one["resnet"]["ddp"]["step_ms"][1:], 50))
    print(f"{tag} ResNet-18 256^2 b{spec['cls_batch']} f32 train step (the second): DDP over one "
          f"rank {cls_ddp:.3f} ms beside the plain step {cls_plain:.3f} ms on {card}")

    # (c) the study pipeline over the device list.
    t0 = time.perf_counter()
    _loc_checkpoint(device, out / "loc" / "best_model")
    _cls_checkpoint(device, out / "cls" / "best_model")
    paths = (out / "loc" / "best_model", out / "cls" / "best_model")
    plain = StudyInferencePipeline.from_checkpoints(*paths, device=device)
    mesh = data_parallel_mesh()
    meshed = StudyInferencePipeline.from_checkpoints(*paths, mesh=mesh)
    studies = _studies(DDP_STUDIES, 5)
    want = plain.run(studies)
    _zero_counts()
    got = meshed.run(studies)
    forward = _counts()
    if forward != INFERENCE_LAUNCHES:
        raise AssertionError(f"the meshed pipeline's forward launched {forward}, expected "
                             f"{INFERENCE_LAUNCHES}")
    if not _same_results(got, want):
        raise AssertionError("from_checkpoints(mesh=data_parallel_mesh()) differs from mesh=None")
    print(f"{tag} from_checkpoints(mesh=data_parallel_mesh()) over {len(mesh)} device(s) "
          f"{[str(d) for d in mesh]}: {DDP_STUDIES} studies bit for bit the mesh=None results, "
          f"launches a forward {forward} ({time.perf_counter() - t0:.1f} s)")
    del plain, meshed
    shutil.rmtree(out, ignore_errors=True)
    print(f"{tag} wall: one rank {t_one:.1f} s, two ranks {t_two:.1f} s (each with its "
          f"processes' start), the phase {time.perf_counter() - t_phase:.1f} s on {card}")
    if failures:
        raise AssertionError("ddp: " + "; ".join(failures))
    return {k: step[0][k] + forward[k] for k in step[0]}


# The backbone zoo (``zoo``): every family beyond ResNet-18 and ConvNeXt at
# full width, none of which runs a kernel of this package (the launch counts
# of every part are all 0).
#
# Forward: a Classifier per distinct code path at 256^2, batch 32, bf16,
# weights from seeded Flax-layout trees; two rows of the card's logits
# against the same model on the CPU in f32, within ZOO_BF16_TOL of the
# largest logit, or (run only past that) ZOO_BF16_MARGIN times the CPU's
# own bf16 run's distance from its f32 run where that is larger (deep
# random-weight nets amplify bf16 rounding, and the card and the CPU round
# independently). The p50 of 20 forwards (CUDA events after a warm-up),
# img/s and peak memory.
ZOO_FORWARD = (("resnet50", {}), ("resnext50", {}), ("resnetrs50", {}),
               ("resnet50", {"norm_impl": "flax", "pool_impl": "tpu"}), ("vit_base", {}),
               ("swin_tiny", {}), ("efficientnet_b0", {}), ("efficientnetv2_s", {}),
               ("mobilenetv3_large", {}))
ZOO_BATCH, ZOO_HW, ZOO_ITERS = 32, 256, 20
ZOO_BF16_TOL, ZOO_BF16_MARGIN = 5e-2, 2.0
# Training: ClassificationTrainer.train() for 2 epochs of 3 train batches and
# 1 validation batch (b64 at 256^2, bf16 on f32 masters, augmentation and
# dropout) on each of ZOO_TRAIN; LocalizationTrainer.train() of a ViT-base
# CoordinateRegressor with a residual head at 512^2, b16 (its position
# embeddings interpolate 14 -> 32).
ZOO_TRAIN, ZOO_TRAIN_BATCH = ("efficientnet_b0", "swin_tiny", "vit_base"), 64
ZOO_LOC_BATCH, ZOO_LOC_HW = 16, 512
# One f32 step's gradients on the card against the CPU for each family (b2
# at 64^2, dropout 0, TF32 off): ocr_train's bounds, each parameter's
# gradient within ZOO_GRAD_WORST of its norm, the median within
# ZOO_GRAD_MEDIAN, or (run only past those) within ZOO_GRAD_MARGIN times the
# CPU's own largest gap between the batch and the batch scaled by 1 + eps
# for each eps of ZOO_GRAD_EPS, where that is larger. Nets with training
# BatchNorm over few values (8 a channel at a ResNet's stage 4: 2 images of
# 2x2; 32 at MobileNetV3's block 6) and ReLUs are chaotic at f32 rounding,
# and a ReLU input that crosses 0 moves a gradient by a step: a 1e-5 change
# of the input moves ResNet-RS-50's gradients by 2.0e-2 of their norms
# (median), a 1e-4 change flips one ReLU of MobileNetV3-large's block 6 and
# moves its expansion BatchNorm's bias gradient by 4.88e-2, exactly the gap
# an H100 showed against the CPU; ViT-base moves by 3.4e-6 and
# EfficientNet-B0 by 3.5e-5 (CPU runs of this check's model and batch;
# PERF.md holds the card's). A gradient that is 0 in exact
# arithmetic (the attention's key bias; a BatchNorm bias that reaches the
# next training BatchNorm through linear layers only) is rounding noise on
# both sides: norms below ZOO_GRAD_FLOOR of the largest gradient's count as
# that floor.
ZOO_GRAD = (("resnext50", {}), ("resnetrs50", {"norm_impl": "flax", "pool_impl": "tpu"}),
            ("vit_base", {}), ("swin_tiny", {}), ("efficientnet_b0", {}),
            ("efficientnetv2_s", {}), ("mobilenetv3_large", {}))
ZOO_GRAD_BATCH, ZOO_GRAD_HW = 2, 64
ZOO_GRAD_WORST, ZOO_GRAD_MEDIAN, ZOO_GRAD_FLOOR = 2e-2, 1e-3, 1e-5
ZOO_GRAD_EPS, ZOO_GRAD_MARGIN = (1e-5, 1e-4), 2.0
# Test-time inference: 8 PNG files and their decoded arrays.
ZOO_PNGS = 8


def _zoo_model(kind: str, name: str, device, dtype, seed: int, param_dtype=None, **kw):
    """A Classifier (or CoordinateRegressor) over backbone ``name``, built on
    the meta device and filled from a seeded Flax-layout tree."""
    import torch

    from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor
    from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables

    cls = Classifier if kind == "classifier" else CoordinateRegressor
    with torch.device("meta"):
        model = cls(name, dtype=dtype, device="meta", param_dtype=param_dtype, **kw)
    model = model.to_empty(device=device)
    load_flax_variables(model, *random_flax_variables(model, seed))
    return model.eval()


def _zoo_check_launches(what: str) -> None:
    if _counts() != _launches():
        raise AssertionError(f"zoo {what}: a kernel of the package was launched: {_counts()}")


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _zoo_forward(device, card: str) -> dict:
    import numpy as np
    import torch

    from spine_vision_torch.ops.image import imagenet_normalize

    cpu = torch.device("cpu")
    rng = np.random.default_rng(40)
    images = torch.from_numpy(rng.integers(0, 256, (ZOO_BATCH, ZOO_HW, ZOO_HW, 3),
                                           dtype=np.uint8))
    x_cpu = imagenet_normalize(images.float() / 255.0)
    x = x_cpu.to(device)
    rows = {}
    for i, (name, kw) in enumerate(ZOO_FORWARD):
        label = name + ("" if not kw else " " + ",".join(f"{k}={v}" for k, v in kw.items()))
        t0 = time.perf_counter()
        model = _zoo_model("classifier", name, device, torch.bfloat16, 50 + i, **kw)
        build_s = time.perf_counter() - t0
        with torch.inference_mode():
            for _ in range(3):
                model(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(ZOO_ITERS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = model(x)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated() / 2**30
        p50 = float(np.percentile(times, 50))
        card_logits = torch.cat([v[:2].float().cpu() for v in out.values()], dim=1)
        if not torch.isfinite(card_logits).all():
            raise AssertionError(f"zoo {label}: non-finite logits on the card")
        del model
        t0 = time.perf_counter()

        def cpu_logits(dtype):
            with torch.inference_mode():
                ref = _zoo_model("classifier", name, cpu, dtype, 50 + i, **kw)
                return torch.cat(list(ref(x_cpu[:2]).values()), dim=1)

        want = cpu_logits(torch.float32)
        err, tol, yard = _rel(card_logits, want), ZOO_BF16_TOL, "not needed"
        if err > tol:  # the CPU's own bf16 run sets the scale
            yard_err = _rel(cpu_logits(torch.bfloat16), want)
            tol, yard = max(tol, ZOO_BF16_MARGIN * yard_err), f"{yard_err:.3e}"
        cpu_s = time.perf_counter() - t0
        print(f"[zoo] {label}: forward p50 {p50:.3f} ms a batch of {ZOO_BATCH} at {ZOO_HW}^2 "
              f"bf16 = {ZOO_BATCH / p50 * 1e3:.1f} img/s (min {min(times):.3f}, max "
              f"{max(times):.3f} ms), peak memory {peak:.2f} GiB; card vs CPU f32 logits "
              f"{err:.3e} of the largest (tol {tol:.3e}; the CPU's bf16 run {yard}); "
              f"built {build_s:.1f} s, CPU reference {cpu_s:.1f} s; on {card}")
        if err > tol:
            raise AssertionError(f"zoo {label}: card logits {err:.3e} from the CPU's > {tol}")
        rows[label] = {"p50_ms": p50, "img_s": ZOO_BATCH / p50 * 1e3, "peak_gib": peak,
                       "err": err}
        gc.collect()
        torch.cuda.empty_cache()
    _zoo_check_launches("forward")
    return rows


def _zoo_train(device, card: str) -> dict:
    import math

    import numpy as np
    import torch

    from spine_vision_torch.models.heads import HeadConfig
    from spine_vision_torch.train.classification import ClassificationTrainer
    from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

    out = {}

    def run(tag: str, trainer, run_dir: Path, keys) -> None:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        result = trainer.train()
        wall = time.perf_counter() - t0
        for name in ("best_model/state.pt", "best_model.meta.json", "config.yaml", "logs"):
            if not (run_dir / name).exists():
                raise AssertionError(f"{tag} run dir lacks {name}")
        for key in keys:
            values = result.history[key]
            if len(values) != 2 or not all(math.isfinite(v) for v in values):
                raise AssertionError(f"{tag} history[{key!r}] = {values}")
        steps = np.asarray(trainer.step_times[1:]) * 1e3  # the first allocates and tunes
        p50 = float(np.percentile(steps, 50))
        batch = trainer.config.batch_size
        print(f"{tag} 2 epochs in {wall:.1f} s; step p50 {p50:.3f} ms = "
              f"{batch / p50 * 1e3:.1f} img/s ({len(steps)} steps after the first; all steps ms "
              f"{[round(t * 1e3, 3) for t in trainer.step_times]}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; history "
              f"{ {k: [round(v, 5) for v in result.history[k]] for k in keys} } on {card}")
        out[tag] = {"p50_ms": p50, "img_s": batch / p50 * 1e3}
        shutil.rmtree(run_dir, ignore_errors=True)

    for name in ZOO_TRAIN:
        cfg = _cls_config(f"zoo_{name}", backbone=name, output_size=(ZOO_HW, ZOO_HW),
                          batch_size=ZOO_TRAIN_BATCH, augment=True, dropout=0.3,
                          mixed_precision=True, profile_steps=True)
        trainer = ClassificationTrainer(
            cfg, train_dataset=_Grades(3 * ZOO_TRAIN_BATCH, ZOO_HW, 60),
            val_dataset=_Grades(ZOO_TRAIN_BATCH, ZOO_HW, 61), device=device)
        run(f"[zoo cls {name}]", trainer, RUN_DIR / f"zoo_{name}",
            ("train_loss", "val_loss", "macro_f1"))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    model = _zoo_model("regressor", "vit_base", device, torch.bfloat16, 62,
                       param_dtype=torch.float32, head_config=HeadConfig("residual"))
    grid = model.backbone.config.patch_size
    run_dir = RUN_DIR / "zoo_loc_vit"
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = LocalizationConfig(
        backbone="vit_base", image_size=(ZOO_LOC_HW, ZOO_LOC_HW), batch_size=ZOO_LOC_BATCH,
        num_epochs=2, augment=True, dropout=0.2, mixed_precision=True, output_path=run_dir,
        num_workers=8, pretrained=False, profile_steps=True, seed=0)
    trainer = LocalizationTrainer(
        cfg, model=model, train_dataset=_Images(3 * ZOO_LOC_BATCH, ZOO_LOC_HW, 63),
        val_dataset=_Images(ZOO_LOC_BATCH, ZOO_LOC_HW, 64), device=device)
    print(f"[zoo loc vit_base] residual head; position grid 14 -> {ZOO_LOC_HW // grid}")
    run("[zoo loc vit_base]", trainer, run_dir, ("train_loss", "val_loss", "med"))
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    _zoo_check_launches("training")
    return out


def _zoo_step_grads(name: str, kw: dict, dev, batch: dict, scale: float = 1.0) -> tuple:
    import numpy as np
    import torch

    from spine_vision_torch.models.classifier import make_multitask_loss_fn
    from spine_vision_torch.models.convert import export_flax_variables
    from spine_vision_torch.ops.image import imagenet_normalize
    from spine_vision_torch.train.classification import create_tasks_for_training

    tasks = create_tasks_for_training()
    model = _zoo_model("classifier", name, dev, torch.float32, 70, param_dtype=torch.float32,
                       tasks=tuple(tasks), dropout=0.0, **kw)
    model.train()
    x = imagenet_normalize(torch.from_numpy(batch["image"]).to(dev).float() / 255.0) * scale
    targets = {k: torch.from_numpy(v).to(dev) for k, v in batch["targets"].items()}
    loss = make_multitask_loss_fn(tasks)(model(x), targets)
    loss.backward()
    grads, _ = export_flax_variables(model, grads=True)

    def flat(tree, prefix=""):
        res = {}
        for k, v in tree.items():
            res.update(flat(v, f"{prefix}/{k}") if isinstance(v, dict)
                       else {f"{prefix}/{k}": np.asarray(v)})
        return res

    return flat(grads), float(loss.detach())


def _grad_gaps(got: dict, want: dict) -> tuple:
    """(worst (name, gap), median gap) of each gradient's difference over
    its norm, the norms floored at ZOO_GRAD_FLOOR of the largest."""
    import numpy as np

    floor = ZOO_GRAD_FLOOR * max(np.linalg.norm(w) for w in want.values())
    gaps = {k: float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), floor))
            for k, w in want.items()}
    return max(gaps.items(), key=lambda kv: kv[1]), float(np.median(list(gaps.values())))


def _zoo_grads(device) -> dict:
    import torch

    from spine_vision_torch.data.loader import collate_classification

    data = _Grades(ZOO_GRAD_BATCH, ZOO_GRAD_HW, 71)
    batch = collate_classification([data[i] for i in range(ZOO_GRAD_BATCH)])
    out = {}
    for name, kw in ZOO_GRAD:
        label = name + ("" if not kw else " " + ",".join(f"{k}={v}" for k, v in kw.items()))
        got, loss = _zoo_step_grads(name, kw, device, batch)
        cpu = torch.device("cpu")
        want, want_loss = _zoo_step_grads(name, kw, cpu, batch)
        worst, median = _grad_gaps(got, want)
        tol_worst, tol_median, yard = ZOO_GRAD_WORST, ZOO_GRAD_MEDIAN, "not needed"
        if worst[1] > tol_worst or median > tol_median:  # the model's own sensitivity
            gaps = [_grad_gaps(_zoo_step_grads(name, kw, cpu, batch, scale=1.0 + eps)[0], want)
                    for eps in ZOO_GRAD_EPS]
            yard_worst = max((g[0] for g in gaps), key=lambda kv: kv[1])
            yard_median = max(g[1] for g in gaps)
            tol_worst = max(tol_worst, ZOO_GRAD_MARGIN * yard_worst[1])
            tol_median = max(tol_median, ZOO_GRAD_MARGIN * yard_median)
            yard = f"worst {yard_worst[1]:.3e} ({yard_worst[0]}), median {yard_median:.3e}"
        print(f"[zoo grad] {label}: f32 step b{ZOO_GRAD_BATCH} {ZOO_GRAD_HW}^2, card vs CPU over "
              f"{len(want)} tensors: worst {worst[1]:.3e} ({worst[0]}; bound {tol_worst:.3e}), "
              f"median {median:.3e} (bound {tol_median:.3e}); the CPU's own largest gap at "
              f"inputs {' or '.join(f'{e:g}' for e in ZOO_GRAD_EPS)} apart: {yard}; loss "
              f"{loss:.6f} vs {want_loss:.6f}")
        if worst[1] > tol_worst or median > tol_median:
            raise AssertionError(f"zoo grad {label}: card and CPU gradients differ")
        out[label] = {"worst": worst[1], "median": median}
        gc.collect()
        torch.cuda.empty_cache()
    _zoo_check_launches("gradient check")
    return out


def _zoo_inference(device, card: str) -> None:
    import numpy as np
    import torch

    from spine_vision_torch.data.png import read_png, write_png
    from spine_vision_torch.models.inference import (
        classifier_test_inference,
        regressor_test_inference,
    )
    from spine_vision_torch.ops.image import imagenet_normalize

    folder = RUN_DIR / "zoo_pngs"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    rng = np.random.default_rng(80)
    paths = []
    for i in range(ZOO_PNGS):
        shape = (300, 260) if i % 2 else (280, 320, 3)
        paths.append(folder / f"img{i}.png")
        write_png(paths[-1], rng.integers(0, 256, shape, dtype=np.uint8))
    arrays = [read_png(p) for p in paths]
    for kind, name, size, fn in (
            ("classifier", "resnet50", (ZOO_HW, ZOO_HW), classifier_test_inference),
            ("regressor", "efficientnet_b0", (ZOO_LOC_HW, ZOO_LOC_HW), regressor_test_inference)):
        model = _zoo_model(kind, name, device, torch.bfloat16, 81)
        from_files, from_arrays = fn(model, paths, image_size=size), fn(model, arrays,
                                                                        image_size=size)
        if not np.array_equal(from_files["images"], from_arrays["images"]):
            raise AssertionError(f"zoo {kind} inference: files and arrays resize differently")
        batch = imagenet_normalize(torch.from_numpy(from_files["images"]).to(device).float()
                                   / 255.0)
        with torch.inference_mode():
            direct = model(batch)
        if kind == "classifier":
            got = np.concatenate([from_files["logits"][k] for k in direct], axis=1)
            again = np.concatenate([from_arrays["logits"][k] for k in direct], axis=1)
            direct = torch.cat([direct[k].float() for k in direct], dim=1)
        else:
            got, again = from_files["coordinates"], from_arrays["coordinates"]
        err = _rel(torch.from_numpy(got), direct.cpu())
        if err > 1e-3 or not np.array_equal(got, again) or not np.isfinite(got).all():
            raise AssertionError(f"zoo {kind} inference: {err:.3e} from a direct forward")
        print(f"[zoo inference] {kind}_test_inference ({name}, bf16) on {ZOO_PNGS} PNG files "
              f"and their arrays at {size[0]}^2: equal outputs, {err:.3e} from a direct forward "
              f"of the batch; timed forward {from_files['inference_time_ms']:.3f} ms on {card}")
        del model
    shutil.rmtree(folder, ignore_errors=True)
    _zoo_check_launches("inference")


def zoo_phase(device, card: str) -> dict:
    """The backbone zoo at full width (see ZOO_FORWARD to ZOO_PNGS): the
    forwards, the trainers, the card-vs-CPU steps and the test-time
    inference functions. Returns the launch counts of the whole phase (all
    0: no kernel of this package lies on the zoo's paths)."""
    _zero_counts()
    forward = _zoo_forward(device, card)
    train = _zoo_train(device, card)
    grads = _zoo_grads(device)
    _zoo_inference(device, card)
    print(f"[zoo] launches of the package's kernels over the phase: {_counts()}")
    return {"launches": _counts(), "forward": forward, "train": train, "grads": grads}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels; skip the slice phase")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one run per crop mode with torch.profiler")
    parser.add_argument("--parity-only", action="store_true",
                        help="run only the parity phase (no kernel build, no kernels line)")
    parser.add_argument("--parity-seeds", type=int, nargs="+", default=list(PARITY_SEEDS),
                        help="the parity phase's seeds (default: %(default)s, the tpu/flax "
                             "seeds of PARITY_SEEDS.json)")
    parser.add_argument("--ocr-only", action="store_true",
                        help="run only the ocr phase (no kernel build, no kernels line)")
    parser.add_argument("--ocr-train-only", action="store_true",
                        help="run only the ocr_train phase (no kernel build, no kernels line)")
    parser.add_argument("--ocr-train-full", action="store_true",
                        help="run train_ocr_stack at the JAX defaults (after the ocr_train "
                             "phase with --ocr-train-only; not part of the default run)")
    parser.add_argument("--io-only", action="store_true",
                        help="run only the volume_io phase (no kernels line)")
    parser.add_argument("--serve-only", action="store_true",
                        help="run only the serve phase (no kernels line)")
    parser.add_argument("--build-only", action="store_true",
                        help="run only the builders phase (no kernels line)")
    parser.add_argument("--ddp-only", action="store_true",
                        help="run only the ddp phase (no kernels line)")
    parser.add_argument("--zoo-only", action="store_true",
                        help="run only the zoo phase (no kernel build, no kernels line)")
    parser.add_argument("--f32-only", action="store_true",
                        help="build the kernels and run only the f32 phases (the f32 forms' "
                             "rows and paths; a kernels line of the f32 forms)")
    parser.add_argument("--cli-only", action="store_true",
                        help="build the kernels and run only the cli phase (no kernels line)")
    parser.add_argument("--codecs-only", action="store_true",
                        help="build the kernels and run only the codecs phase (no kernels line)")
    parser.add_argument("--pdf-only", action="store_true",
                        help="build the kernels, check #1 and #2 and run only the pdf phase "
                             "(a kernels line of #1 and #2 with the phase's launches)")
    parser.add_argument("--ddp-rank", help=argparse.SUPPRESS)  # a rank of the ddp phase
    opts = parser.parse_args()
    if opts.ddp_rank:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        ddp_rank(json.loads(opts.ddp_rank))
        return 0

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

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    def verdict() -> int:
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    if opts.parity_only:
        phase("parity", parity_phase, device, card, tuple(opts.parity_seeds))
        return verdict()
    if opts.ocr_only:
        phase("ocr", ocr_phase, device, card, opts.profile)
        return verdict()
    if opts.ocr_train_only or opts.ocr_train_full:
        if opts.ocr_train_only:
            phase("ocr_train", ocr_train_phase, device, card, opts.profile)
        if opts.ocr_train_full:
            phase("ocr_train_full", ocr_train_full, device, card)
        return verdict()
    if opts.io_only:
        phase("volume_io", volume_io_phase, device, card)
        return verdict()
    if opts.serve_only:
        phase("serve", serve_phase, device, card, opts.profile)
        shutil.rmtree(RUN_DIR / "volume_io", ignore_errors=True)
        return verdict()
    if opts.build_only:
        phase("builders", builders_phase, device, card)
        shutil.rmtree(RUN_DIR / "volume_io", ignore_errors=True)
        return verdict()
    if opts.ddp_only:
        phase("ddp", ddp_phase, device, card)
        return verdict()
    if opts.zoo_only:
        phase("zoo", zoo_phase, device, card)
        return verdict()
    if opts.cli_only:
        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"[build] {len(cuda_build.SOURCES)} sources built in {time.perf_counter() - t0:.1f} s")
        phase("cli", cli_phase, device, card)
        shutil.rmtree(RUN_DIR / "volume_io", ignore_errors=True)
        return verdict()
    if opts.codecs_only:
        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"[build] {len(cuda_build.SOURCES)} sources built in {time.perf_counter() - t0:.1f} s")
        phase("codecs", codecs_phase, device, card)
        return verdict()
    if opts.pdf_only:
        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"[build] {len(cuda_build.SOURCES)} sources built in {time.perf_counter() - t0:.1f} s")
        report = phase("inference kernels", kernel_phase, device)
        launches = phase("pdf", pdf_phase, device, card)["launches"]
        shutil.rmtree(RUN_DIR / "volume_io", ignore_errors=True)
        # The rows of #1 and #2 on the other paths' shapes keep their paths,
        # not run here.
        paths = {key.partition("@")[2]: None for key in report if "@" in key}
        paths.update({"study_inference": None, "pdf": launches})
        return _kernels_line(report, paths, {}, {}) or verdict()

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"[build] {len(cuda_build.SOURCES)} sources built in {time.perf_counter() - t0:.1f} s "
          f"(in parallel, one nvcc a source)")
    for name, log in cuda_build.build_logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(line.split()[4]) for line in log.splitlines()
                     if "spill stores" in line)
        print(f"[build] {name}: {len(regs)} kernels, registers max {max(regs, default=0)}, "
              f"spill stores {spills} bytes")

    f32_paths = {"f32_study_inference": None, "f32_grad_check_mlp_no_layer_scale": None,
                 **{f"f32_{p}": None for p in TRAIN_PATHS}, "f32_cls_convnext_hybrid": None}
    if opts.f32_only:
        report, probe_counts, probe_rows = {}, {}, {}
        phase("f32 kernels", f32_kernel_phase, device, report)
        paths = {**f32_paths, **phase("f32", f32_phase, device, card)}
        return _kernels_line(report, paths, probe_counts, probe_rows) or verdict()
    report = phase("inference kernels", kernel_phase, device)
    phase("hybrid training kernels", train_kernel_phase, device, report)
    phase("all-kernel training kernels", dwconv_train_kernel_phase, device, report)
    phase("mlp-mode kernels", mlp_kernel_phase, device, report)
    phase("whole-block backward kernel", block_train_kernel_phase, device, report)
    phase("f32 kernels", f32_kernel_phase, device, report)
    probe_counts, probe_rows = phase("probes", probe_phase, device)
    paths = {"study_inference": None, "volume_io": None, "serve": None, "builders": None,
             "cli": None, "codecs": None, "pdf": None,
             **{p: None for p in TRAIN_PATHS},
             "grad_check_mlp_no_layer_scale": None, "cls_train": None,
             "cls_convnext_hybrid": None, "parity": None, "file_backed": None, "ocr": None,
             "ocr_train": None, "ddp": None, "zoo": None, "probes": probe_counts, **f32_paths}
    if not opts.kernels_only:
        paths["study_inference"] = phase("study_inference", slice_phase, device, card,
                                         opts.profile)["launches"]
        io = phase("volume_io", volume_io_phase, device, card, True)
        paths["volume_io"] = io["launches"]
        # serve and builders: the launches a ConvNeXt-base forward.
        paths["serve"] = phase("serve", serve_phase, device, card, opts.profile, io)["launches"]
        paths["builders"] = phase("builders", builders_phase, device, card, io)["launches"]
        paths["cli"] = phase("cli", cli_phase, device, card, io)["launches"]
        paths["codecs"] = phase("codecs", codecs_phase, device, card, io)["launches"]
        paths["pdf"] = phase("pdf", pdf_phase, device, card, io)["launches"]
        del io
        shutil.rmtree(RUN_DIR / "volume_io", ignore_errors=True)
        for path, grad_mode in (("train_step", "hybrid"), ("train_step_dwconv", True),
                                ("train_step_mlp", "mlp"), ("train_step_block", "block")):
            paths[path] = phase(path, train_phase, device, card, path,
                                opts.profile)["launches"]
            phase(f"grad check {grad_mode!r}", grad_check, device, grad_mode)
            if path == "train_step":
                phase("overfit", overfit_check, device)
        paths["grad_check_mlp_no_layer_scale"] = phase(
            "grad check 'mlp_no_layer_scale'", grad_check, device, "mlp_no_layer_scale")
        paths["cls_train"] = phase("cls_train", cls_train_phase, device, card,
                                   opts.profile)["launches"]
        phase("cls grad check", cls_grad_check, device)
        phase("cls overfit", cls_overfit_check, device)
        paths["cls_convnext_hybrid"] = phase("cls ConvNeXt-base hybrid", cls_convnext_check,
                                             device)
        paths.update(phase("f32", f32_phase, device, card))
        paths["parity"] = phase("parity", parity_phase, device, card,
                                tuple(opts.parity_seeds))
        paths["file_backed"] = phase("file_backed", file_backed_phase, device,
                                     card)["launches"]
        paths["ocr"] = phase("ocr", ocr_phase, device, card, opts.profile)
        paths["ocr_train"] = phase("ocr_train", ocr_train_phase, device, card, opts.profile)
        paths["ddp"] = phase("ddp", ddp_phase, device, card)
        paths["zoo"] = phase("zoo", zoo_phase, device, card)["launches"]
    return _kernels_line(report, paths, probe_counts, probe_rows) or verdict()


def _kernels_line(report: dict, paths: dict, probe_counts: dict, probe_rows: dict) -> None:
    """Print the ``kernels`` JSON line: each kernel's rows in ``report`` (its
    main-path shapes; ``@`` another path's, ``#`` one launch's) summed over
    its launches on its path, and the probes' worst variants."""
    sources = {
        "convnext_block": ("spine_vision_torch/csrc/convnext_block.cu",
                           "spine_vision_tpu/ops/convnext_block.py:194", "study_inference"),
        "dw_ln": ("spine_vision_torch/csrc/dwconv_ln.cu", "spine_vision_tpu/ops/dwconv.py:495",
                  "study_inference"),
        "convnext_block_emit_conv": ("spine_vision_torch/csrc/convnext_block.cu",
                                     "spine_vision_tpu/ops/convnext_block.py:194", "train_step"),
        "ln_mlp_bwd": ("spine_vision_torch/csrc/ln_mlp_bwd.cu",
                       "spine_vision_tpu/ops/fused_mlp.py:930 and :1050", "train_step"),
        "mlp_bwd": ("spine_vision_torch/csrc/ln_mlp_bwd.cu",
                    "spine_vision_tpu/ops/fused_mlp.py:325", "train_step_dwconv"),
        "dw_ln_bwd": ("spine_vision_torch/csrc/dwconv_bwd.cu",
                      "spine_vision_tpu/ops/dwconv.py:366", "train_step_dwconv"),
        "depthwise_conv7x7": ("spine_vision_torch/csrc/dwconv_bwd.cu",
                              "spine_vision_tpu/ops/dwconv.py:119", "train_step_dwconv"),
        "ln_mlp": ("spine_vision_torch/csrc/row_mlp.cu",
                   "spine_vision_tpu/ops/fused_mlp.py:586", "train_step_mlp"),
        "mlp_fwd": ("spine_vision_torch/csrc/row_mlp.cu",
                    "spine_vision_tpu/ops/fused_mlp.py:147", "grad_check_mlp_no_layer_scale"),
        "block_train_bwd": ("spine_vision_torch/csrc/block_train_bwd.cu",
                            "spine_vision_tpu/ops/block_train.py:313", "train_step_block"),
    }
    # The f32 forms: the same sources and TPU kernels (the JAX kernels run in
    # f32 with mixed_precision=False), on the f32 paths.
    f32_paths = {"convnext_block": "f32_study_inference",
                 "convnext_block_emit_conv": "f32_train_step", "ln_mlp_bwd": "f32_train_step",
                 "mlp_bwd": "f32_train_step_dwconv", "ln_mlp": "f32_train_step_mlp",
                 "mlp_fwd": "f32_grad_check_mlp_no_layer_scale",
                 "block_train_bwd": "f32_train_step_block"}
    for name, path in f32_paths.items():
        source, replaces, _ = sources[name]
        sources[f"{name}_f32"] = (source, replaces, path)  # its products: csrc/wg_gemm.cuh

    def totals(rows: list) -> dict:
        """Per-path totals: each shape's time times its launches on the path."""
        total = lambda i: sum(r[0] * r[i] for r in rows)  # noqa: E731
        simt = {"simt_bound_ms": total(7)} if all(len(r) > 7 for r in rows) else {}
        return {"max_abs_err": max(r[1] for r in rows), "ms": total(2), "plain_ms": total(3),
                "bound_ms": total(4), "bound_by": max(rows, key=lambda r: r[0] * r[4])[5],
                "library_ms": total(6), **simt}

    kernels = []
    for name, rows in report.items():
        if "@" in name or "#" in name:  # another path's rows, a stage's: below
            continue
        source, replaces, path = sources[name]
        by_path = {p: (c or {}).get(name) for p, c in paths.items()}
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "path": path, "launches": by_path[path], "launches_by_path": by_path,
                 **totals(rows)}
        for key, more in report.items():
            base, sep, rest = key.partition("@") if "@" in key else key.partition("#")
            if base == name and sep == "@":  # the kernel on another path
                entry.setdefault("on_other_paths", {})[rest] = {
                    "launches": by_path[rest], **totals(more)}
            elif base == name and sep == "#":  # one launch of the call
                entry.setdefault("stages", {})[rest] = totals(more)
        kernels.append(entry)
    for name, checked in probe_rows.items():
        if name not in PROBE_SOURCES:  # #5's anchor rows: its entry is above
            continue
        # The times are the worst variant's: the farthest from its bound.
        worst, _, worst_plain = max(checked, key=lambda t: t[0].ms / t[0].bound_ms)
        kernels.append({
            "name": name, "route": "cuda", "source": PROBE_SOURCES[name][0],
            "replaces": PROBE_SOURCES[name][1], "path": "probes",
            "launches": probe_counts[name],
            "launches_by_path": {p: (c or {}).get(name) for p, c in paths.items()},
            "max_abs_err": max(e for _, e, _ in checked), "worst_variant": worst.variant,
            "ms": worst.ms, "plain_ms": worst_plain, "bound_ms": worst.bound_ms,
            "bound_by": worst.bound_by, "library_ms": worst.library_ms,
            "variants": [{"probe": r.probe, "variant": r.variant, "config": r.config,
                          "ms": r.ms, "host_ms": r.host_ms,
                          "rate": f"{r.achieved(r.ms):.1f} {r.rate}",
                          "share": r.share, "bound_ms": r.bound_ms, "plain_ms": p,
                          "library_ms": r.library_ms, "max_abs_err": e}
                         for r, e, p in checked],
        })
    for entry in kernels:
        if entry["path"] in paths and paths[entry["path"]] is not None and not entry["launches"]:
            raise AssertionError(f"{entry['name']} was not launched on its path {entry['path']}")
    print(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    sys.exit(main())
