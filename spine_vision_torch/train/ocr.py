"""OCR training and evaluation: the CTC recognizer and the DB detector.

Counterpart of ``spine_vision_tpu/train/ocr.py``. Lines and pages are
rendered on the host (``data/phenikaa/synth.py``, numpy, no PIL) in chunks
of ``chunk`` batches by 8 threads, each batch from its own Generator seeded
on the caller's thread; the chunk moves to the card and the net takes one
update per batch. The recipe is the JAX package's:

- the nets at their full widths with f32 master variables, computed as the
  Flax nets compute in bf16 (``models/textrec.py``, ``models/textdet.py``),
  BatchNorm with the batch statistics (Flax's, momentum 0.99);
- the recognizer's loss optax's CTC (``ops/ctc.py``) averaged over the
  batch; the detector's a class-balanced BCE plus dice on the shrunk-box
  targets, both in f32;
- ``torch.optim.AdamW`` with weight decay 1e-4 on every parameter, the lr of
  update ``k`` (from 0) set to ``warmup_cosine_decay(k)`` before it (update
  0 has lr 0);
- steps rounded up to a whole chunk, the logged loss the mean of the
  chunk's last 5;
- evaluation by the JAX package's metrics and seeds: CER on 256 rendered
  lines (clean, ``degrade="hard"``, the unseen fonts, matplotlib's
  rasterizer), box recall at IoU 0.3 on 32 pages, and the three report
  fields end to end on 5 unseen-layout pages.

TF32 stays off in the train steps: the convolutions' cotangents are not all
bf16-rounded, and TF32 would round their products where the JAX step sums
them in f32.

Weights are written as the JAX package's ``.npz`` (``models/convert.py``),
which the port's ``DocumentExtractor`` and ``preprocess_phenikaa`` and the
JAX package's ``load_variables_npz`` all read. :func:`train_ocr_stack`
requires its ``output_dir``: the JAX function's default is its own
``weights/`` directory, which for the port would be the JAX package's
shipped weights (``DEFAULT_WEIGHTS_DIR``), read by its OCR record.

Every entry point takes ``device="cuda"`` and raises without a card unless
asked for the CPU.
"""

from __future__ import annotations

import contextlib
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from spine_vision_torch.data.phenikaa import synth
from spine_vision_torch.data.phenikaa.ocr import DEFAULT_WEIGHTS_DIR
from spine_vision_torch.device import resolve_device
from spine_vision_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
    load_variables_npz,
    save_variables_npz,
)
from spine_vision_torch.models.textdet import TextDetectionNet, extract_boxes_from_probmap
from spine_vision_torch.models.textrec import TextRecognitionNet, ctc_greedy_decode
from spine_vision_torch.ops.ctc import ctc_loss
from spine_vision_torch.train.schedules import build_optimizer, warmup_cosine_decay

__all__ = [
    "DEFAULT_WEIGHTS_DIR", "character_error_rate", "evaluate_detector",
    "evaluate_layout_extraction", "evaluate_recognizer", "evaluate_recognizer_mpl",
    "load_variables_npz", "save_variables_npz", "train_detector", "train_ocr_stack",
    "train_recognizer",
]

logger = logging.getLogger("spine_vision_torch")

RENDER_THREADS = 8
WEIGHT_DECAY = 1e-4


def character_error_rate(predictions: list[str], targets: list[str]) -> float:
    """Summed Levenshtein distance over summed target length (each target
    counting at least 1): the standard CER."""
    total_dist = 0
    total_len = 0
    for pred, target in zip(predictions, targets):
        n = len(target)
        row = list(range(n + 1))
        for i in range(1, len(pred) + 1):
            prev = row[0]
            row[0] = i
            for j in range(1, n + 1):
                cur = row[j]
                row[j] = min(row[j] + 1, row[j - 1] + 1, prev + (pred[i - 1] != target[j - 1]))
                prev = cur
        total_dist += row[n]
        total_len += max(n, 1)
    return total_dist / max(total_len, 1)


Tree = dict[str, Any]


def _variables(net: torch.nn.Module) -> Tree:
    params, stats = export_flax_variables(net)
    return {"params": params, "batch_stats": stats}


def _load(net: torch.nn.Module, variables: Tree | None) -> torch.nn.Module:
    if variables is not None:
        load_flax_variables(net, variables["params"], variables.get("batch_stats"))
    return net


@contextlib.contextmanager
def _tf32_off():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _render_pool(rng: np.random.Generator, chunk: int, one: Callable[[np.random.Generator], Any]):
    # The seeds are drawn on the caller's thread before the pool: a shared
    # Generator drawn inside the workers would assign them in scheduler order.
    seeds = rng.integers(2**63, size=chunk)
    with ThreadPoolExecutor(max_workers=RENDER_THREADS) as pool:
        return list(pool.map(lambda i: one(np.random.default_rng(seeds[i])), range(chunk)))


# ---------------------------------------------------------------------------
# Recognizer
# ---------------------------------------------------------------------------


def _render_chunk_recognition(
    rng: np.random.Generator, chunk: int, batch: int, width: int, max_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    def one(local: np.random.Generator):
        # Clean lines plus the "mild" scan degradation on 70% of them.
        images, ids, pad, _ = synth.recognition_batch(
            local, batch, width=width, max_len=max_len, degrade="mild", degrade_p=0.7
        )
        return images, ids, pad

    parts = _render_pool(rng, chunk, one)
    return tuple(np.stack([p[i] for p in parts]) for i in range(3))


def _init_recognizer(seed: int, width: int, device: torch.device) -> TextRecognitionNet:
    """The recognizer with f32 master variables, drawn with Flax's
    initialisers from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return TextRecognitionNet(patch_width=width, generator=gen,
                              param_dtype=torch.float32).to(device)


def recognizer_loss(net: TextRecognitionNet, images: torch.Tensor, ids: torch.Tensor,
                    pads: torch.Tensor) -> torch.Tensor:
    """The batch mean of optax's CTC on the train-mode logits, in f32."""
    logits = net(images, train=True)
    logit_pad = torch.zeros(logits.shape[:2], device=logits.device)
    return ctc_loss(logits, logit_pad, ids, pads).mean()


def _update(opt: torch.optim.Optimizer, lr: float, loss_fn: Callable[[], torch.Tensor]
            ) -> torch.Tensor:
    """One AdamW update at ``lr``; returns the loss, on the device."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss.detach()


def _recognizer_step(net, opt, lr, images, ids, pads) -> torch.Tensor:
    return _update(opt, lr, lambda: recognizer_loss(net, images, ids, pads))


def _round_steps(steps: int, chunk: int) -> int:
    if steps % chunk:
        rounded = -(-steps // chunk) * chunk
        logger.info("Rounding steps %d -> %d (chunk multiple)", steps, rounded)
        return rounded
    return steps


def train_recognizer(
    steps: int = 4000,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    width: int = 256,
    max_len: int = 40,
    chunk: int = 25,
    seed: int = 0,
    output_path: Path | None = None,
    eval_samples: int = 256,
    device: str | torch.device = "cuda",
) -> tuple[Tree, float]:
    """Train the CTC recognizer on rendered lines; returns (Flax variables
    tree, CER on ``eval_samples`` held-out lines from seed ``seed + 1``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    net = _init_recognizer(seed, width, dev)
    warmup = min(200, max(1, steps // 10))
    schedule = warmup_cosine_decay(learning_rate, warmup, max(steps, warmup + 1))
    opt = build_optimizer(net.parameters(), learning_rate, weight_decay=WEIGHT_DECAY)
    steps = _round_steps(steps, chunk)
    done = 0
    start = time.time()
    with _tf32_off():
        while done < steps:
            k = min(chunk, steps - done)
            images, ids, pads = _render_chunk_recognition(rng, k, batch_size, width, max_len)
            x = torch.from_numpy(images / 255.0).float().to(dev)[..., None]
            ids_t = torch.from_numpy(ids).to(dev)
            pads_t = torch.from_numpy(pads).to(dev)
            losses = [
                _recognizer_step(net, opt, schedule(done + i), x[i], ids_t[i], pads_t[i])
                for i in range(k)
            ]
            done += k
            logger.info("recognizer step %d/%d loss %.4f (%.1fs)", done, steps,
                        float(torch.stack(losses[-5:]).mean()), time.time() - start)
    variables = _variables(net)
    cer = evaluate_recognizer(None, variables, seed=seed + 1, n=eval_samples, width=width,
                              device=dev)
    logger.info("recognizer CER on held-out rendered lines: %.4f", cer)
    if output_path is not None:
        save_variables_npz(variables, output_path)
        logger.info("saved recognizer weights: %s", output_path)
    return variables, cer


@torch.no_grad()
def _recognizer_cer(model: TextRecognitionNet | None, variables: Tree | None,
                    images: np.ndarray, texts: list[str], width: int, device) -> float:
    dev = resolve_device(device)
    net = model if model is not None else TextRecognitionNet(patch_width=width, device=dev)
    net = _load(net, variables).eval()
    x = torch.from_numpy(images / 255.0).float().to(dev)[..., None]
    logits = net(x).float().cpu().numpy()
    return character_error_rate(ctc_greedy_decode(logits), texts)


def evaluate_recognizer(
    model: TextRecognitionNet | None,
    variables: Tree | None,
    seed: int = 123,
    n: int = 256,
    width: int = 256,
    degrade: str | None = None,
    fonts: tuple[str, ...] | None = None,
    device: str | torch.device = "cuda",
) -> float:
    """CER on freshly rendered held-out lines (light augmentation):
    ``degrade="hard"`` for the off-distribution scan profile,
    ``fonts=synth.HOLDOUT_FONT_PATHS`` for the unseen faces. ``model`` (a
    port net, or None for a new one on ``device``) takes ``variables`` (a
    Flax tree) when they are given."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images, _, _, texts = synth.recognition_batch(rng, n, width=width, degrade=degrade,
                                                  fonts=fonts)
    return _recognizer_cer(model, variables, images, texts, width, dev)


def evaluate_recognizer_mpl(
    model: TextRecognitionNet | None,
    variables: Tree | None,
    seed: int = 123,
    n: int = 256,
    width: int = 256,
    style: str = "normal",
    device: str | torch.device = "cuda",
) -> float:
    """CER on lines rasterized by matplotlib instead of the training
    renderer (``synth.render_line_mpl``): the unseen-renderer evaluation.
    Needs matplotlib; raises ``ImportError`` without it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images, texts = synth.recognition_eval_batch_mpl(rng, n, width=width, style=style)
    return _recognizer_cer(model, variables, images, texts, width, dev)


# ---------------------------------------------------------------------------
# Detector
# ---------------------------------------------------------------------------


def _render_chunk_detection(
    rng: np.random.Generator, chunk: int, batch: int, page_hw: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    def one(local: np.random.Generator):
        pages, targets = [], []
        for _ in range(batch):
            page, boxes, _ = synth.detection_page(local, page_hw, degrade="mild", degrade_p=0.7)
            pages.append(page)
            targets.append(synth.detection_target(boxes, page_hw))
        return np.stack(pages), np.stack(targets)

    parts = _render_pool(rng, chunk, one)
    return np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])


def _init_detector(seed: int, device: torch.device) -> TextDetectionNet:
    """The detector with f32 master variables, drawn with Flax's
    initialisers from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return TextDetectionNet(generator=gen, param_dtype=torch.float32).to(device)


def detector_loss(net: TextDetectionNet, pages: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Class-balanced BCE plus dice of the train-mode map, in f32."""
    prob = net(pages, train=True)[..., 0].float()
    eps = 1e-6
    prob = torch.clamp(prob, eps, 1.0 - eps)
    pos, neg = targets, 1.0 - targets
    pos_w = neg.sum() / torch.clamp(pos.sum(), min=1.0)
    bce = -(pos_w * pos * torch.log(prob) + neg * torch.log(1.0 - prob))
    bce = bce.sum() / torch.clamp((pos_w * pos + neg).sum(), min=1.0)
    inter = (prob * pos).sum()
    dice = 1.0 - 2.0 * inter / torch.clamp(prob.sum() + pos.sum(), min=1.0)
    return bce + dice


def _detector_step(net, opt, lr, pages, targets) -> torch.Tensor:
    return _update(opt, lr, lambda: detector_loss(net, pages, targets))


def train_detector(
    steps: int = 1200,
    batch_size: int = 16,
    learning_rate: float = 1e-3,
    page_hw: tuple[int, int] = (320, 448),
    chunk: int = 20,
    seed: int = 0,
    output_path: Path | None = None,
    device: str | torch.device = "cuda",
) -> tuple[Tree, float]:
    """Train the DB-style detector; returns (Flax variables tree, box recall
    on 32 held-out pages from seed ``seed + 1``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    net = _init_detector(seed, dev)
    warmup = min(100, max(1, steps // 10))
    schedule = warmup_cosine_decay(learning_rate, warmup, max(steps, warmup + 1))
    opt = build_optimizer(net.parameters(), learning_rate, weight_decay=WEIGHT_DECAY)
    steps = _round_steps(steps, chunk)
    done = 0
    start = time.time()
    with _tf32_off():
        while done < steps:
            k = min(chunk, steps - done)
            pages, targets = _render_chunk_detection(rng, k, batch_size, page_hw)
            x = torch.from_numpy(pages / 255.0).float().to(dev)[..., None]
            t = torch.from_numpy(targets).to(dev)
            losses = [_detector_step(net, opt, schedule(done + i), x[i], t[i]) for i in range(k)]
            done += k
            logger.info("detector step %d/%d loss %.4f (%.1fs)", done, steps,
                        float(torch.stack(losses[-5:]).mean()), time.time() - start)
    variables = _variables(net)
    recall = evaluate_detector(None, variables, page_hw, seed=seed + 1, device=dev)
    logger.info("detector box recall on held-out pages: %.4f", recall)
    if output_path is not None:
        save_variables_npz(variables, output_path)
        logger.info("saved detector weights: %s", output_path)
    return variables, recall


def box_recall(prob_maps: list[np.ndarray], gt_boxes: list[np.ndarray],
               iou_threshold: float = 0.3) -> tuple[int, int]:
    """(matched, total) ground-truth boxes over pages: a box is matched by
    a detection of IoU at least ``iou_threshold``."""
    matched = total = 0
    for prob, boxes in zip(prob_maps, gt_boxes):
        quads = extract_boxes_from_probmap(prob)
        pred = (
            np.stack([quads[:, :, 0].min(1), quads[:, :, 1].min(1),
                      quads[:, :, 0].max(1), quads[:, :, 1].max(1)], axis=1)
            if len(quads) else np.zeros((0, 4))
        )
        for gt in boxes:
            total += 1
            if len(pred) == 0:
                continue
            ix1 = np.maximum(pred[:, 0], gt[0])
            iy1 = np.maximum(pred[:, 1], gt[1])
            ix2 = np.minimum(pred[:, 2], gt[2])
            iy2 = np.minimum(pred[:, 3], gt[3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            area_p = (pred[:, 2] - pred[:, 0]) * (pred[:, 3] - pred[:, 1])
            area_g = (gt[2] - gt[0]) * (gt[3] - gt[1])
            iou = inter / np.maximum(area_p + area_g - inter, 1e-6)
            if iou.max() >= iou_threshold:
                matched += 1
    return matched, total


@torch.no_grad()
def evaluate_detector(
    model: TextDetectionNet | None,
    variables: Tree | None,
    page_hw: tuple[int, int] = (320, 448),
    seed: int = 123,
    n_pages: int = 32,
    iou_threshold: float = 0.3,
    degrade: str | None = None,
    fonts: tuple[str, ...] | None = None,
    device: str | torch.device = "cuda",
) -> float:
    """Fraction of ground-truth line boxes matched by a detection (IoU) on
    ``n_pages`` rendered pages: ``degrade="hard"`` for the off-distribution
    profile, ``fonts=synth.HOLDOUT_FONT_PATHS`` for the unseen faces."""
    dev = resolve_device(device)
    net = _load(model if model is not None else TextDetectionNet(device=dev), variables).eval()
    rng = np.random.default_rng(seed)
    probs, boxes = [], []
    for _ in range(n_pages):
        page, gt, _ = synth.detection_page(rng, page_hw, augment=False, degrade=degrade,
                                           fonts=fonts)
        x = torch.from_numpy(page / 255.0).float().to(dev)[None, ..., None]
        probs.append(net(x)[0, :, :, 0].float().cpu().numpy())
        boxes.append(gt)
    matched, total = box_recall(probs, boxes, iou_threshold)
    return matched / max(total, 1)


def evaluate_layout_extraction(
    det_vars: Tree | None,
    rec_vars: Tree | None,
    n_pages: int = 5,
    seed: int = 0,
    degrade: str | None = None,
    device: str | torch.device = "cuda",
) -> float:
    """Fraction of unseen-layout report pages
    (``synth.render_report_page_variant``) with all three fields (name,
    birthday, boxed report ID) extracted end to end: detect, rectify,
    recognize, spatial fuzzy extraction."""
    from spine_vision_torch.data.phenikaa import (
        BIRTHDAY_FIELD_PATTERN,
        ID_FIELD_PATTERN,
        NAME_FIELD_PATTERN,
    )
    from spine_vision_torch.data.phenikaa.matching import (
        ascii_fold,
        fuzzy_match_score,
        fuzzy_value_extract_spatial,
    )
    from spine_vision_torch.data.phenikaa.ocr import (
        DocumentExtractor,
        TextDetector,
        TextRecognizer,
    )

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    extractor = DocumentExtractor(
        detector=TextDetector(variables=det_vars, device=dev),
        recognizer=TextRecognizer(variables=rec_vars, device=dev),
        device=dev,
    )
    ok = 0
    for _ in range(n_pages):
        name = synth.sample_name(rng)
        birthday = synth.sample_date(rng)
        report_id = str(rng.integers(10**8, 10**9))
        page = synth.render_report_page_variant(name, birthday, report_id, rng)
        if degrade is not None:
            page = synth.degrade_image(page, rng, profile=degrade)
        lines = extractor.extract_lines_from_image(page)
        got_name = fuzzy_value_extract_spatial(lines, NAME_FIELD_PATTERN, 80, window_length=3)
        got_birthday = fuzzy_value_extract_spatial(lines, BIRTHDAY_FIELD_PATTERN, 80,
                                                   window_length=2)
        got_id = fuzzy_value_extract_spatial(lines, ID_FIELD_PATTERN, 80, window_length=2)
        ok += (
            got_name is not None
            and fuzzy_match_score(ascii_fold(got_name), ascii_fold(name)) >= 80
            and got_birthday is not None
            and birthday.split("/")[-1] in got_birthday
            and got_id is not None
            and report_id in got_id.replace(" ", "")
        )
    return ok / max(n_pages, 1)


def train_ocr_stack(
    output_dir: Path,
    recognizer_steps: int = 4000,
    detector_steps: int = 1200,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict[str, float]:
    """Train both OCR nets, write ``ocr_recognizer.npz`` and
    ``ocr_detector.npz`` into ``output_dir``, and return the JAX package's
    metrics. ``output_dir`` is required (the JAX default, its ``weights/``,
    holds the shipped weights). ``recognizer_cer_unseen_renderer`` needs
    matplotlib: without it a warning is logged and the key left out."""
    if output_dir is None:
        raise ValueError("train_ocr_stack needs an output_dir (the shipped weights stay as "
                         "they are)")
    dev = resolve_device(device)
    out = Path(output_dir)
    rec_vars, cer = train_recognizer(steps=recognizer_steps, seed=seed,
                                     output_path=out / "ocr_recognizer.npz", device=dev)
    det_vars, recall = train_detector(steps=detector_steps, seed=seed,
                                      output_path=out / "ocr_detector.npz", device=dev)
    metrics = {
        "recognizer_cer": cer,
        "detector_box_recall": recall,
        "recognizer_cer_degraded": evaluate_recognizer(None, rec_vars, degrade="hard",
                                                       device=dev),
        "detector_box_recall_degraded": evaluate_detector(None, det_vars, degrade="hard",
                                                          device=dev),
        "layout_extraction_rate": evaluate_layout_extraction(det_vars, rec_vars, n_pages=5,
                                                             seed=seed, device=dev),
    }
    try:
        metrics["recognizer_cer_unseen_renderer"] = evaluate_recognizer_mpl(
            None, rec_vars, device=dev)
    except ImportError:
        logger.warning("matplotlib is not installed; unseen-renderer eval skipped")
    metrics["recognizer_cer_unseen_font"] = evaluate_recognizer(
        None, rec_vars, fonts=synth.HOLDOUT_FONT_PATHS, device=dev)
    metrics["detector_box_recall_unseen_font"] = evaluate_detector(
        None, det_vars, fonts=synth.HOLDOUT_FONT_PATHS, device=dev)
    logger.info(
        "unseen-font holdout (%d faces): recognizer CER %.4f (in-font %.4f), "
        "detector recall %.3f", len(synth.HOLDOUT_FONT_PATHS),
        metrics["recognizer_cer_unseen_font"], cer, metrics["detector_box_recall_unseen_font"],
    )
    return metrics
