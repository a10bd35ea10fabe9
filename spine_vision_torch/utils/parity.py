"""Quality-parity suite: a reproducible synthetic end-to-end quality run.

Counterpart of ``spine_vision_tpu/utils/parity.py``. A deterministic
synthetic task whose ground truth is known exactly, driven through the
port's training and fused inference stacks:

1. Localization: a ResNet-18 ``CoordinateRegressor`` trained on rendered
   spine slices (5 textured disc sites an image); MED and PCK on the test
   split.
2. Classification: the training crops are made by the trained localization
   model through ``SeriesCropPipeline`` in both crop modes, then a ResNet-18
   multi-task ``Classifier`` is trained on them (Pfirrmann grade = bar count,
   herniation = a corner block); F1 and AUC on the test split.
3. Fused inference: held-out studies rendered the same way run through
   ``StudyInferencePipeline`` in both crop modes; end-to-end MED, grading
   accuracy and AUCs.

The data live in memory: the rendered arrays go into image stores (what the
JAX package writes as PNG and reads back), beside the same
``annotations.csv`` files. Every draw comes from one
``np.random.default_rng(seed)`` in the JAX package's order, so a seed renders
the same slices in both packages. The record has the JAX record's keys,
thresholds and pass rules.
"""

from __future__ import annotations

import contextlib
import csv
import json
import logging
import math
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from spine_vision_torch.core.tasks import get_tasks
from spine_vision_torch.data.datasets import ClassificationDataset, LocalizationDataset
from spine_vision_torch.infer.pipeline import (
    SeriesCropPipeline,
    StudyInferencePipeline,
    StudyInput,
    StudyPipelineConfig,
)
from spine_vision_torch.metrics import macro_ovr_auc, roc_auc
from spine_vision_torch.train.classification import ClassificationConfig, ClassificationTrainer
from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer

logger = logging.getLogger("spine_vision_torch")

LEVELS = ["L1/L2", "L2/L3", "L3/L4", "L4/L5", "L5/S1"]
LEVEL_YS = (0.22, 0.35, 0.48, 0.61, 0.74)  # normalized disc-center rows
SLICE_HW = (192, 192)
DISC_HALF = 14  # px half-extent of the textured disc site
CROP_SIZE = (48, 48)
LOC_SIZE = (128, 128)
# 1 mm/px spacing and 24 mm deltas -> a 48x48 px crop region around each
# 28x28 disc site (scale 1:1 into CROP_SIZE). The 10 px margin keeps every
# grade bar inside the crop under the localization model's residual center
# error (~7 px MED on this task).
CROP_DELTA_MM = (24.0, 24.0, 24.0, 24.0)


def _draw_disc(img: np.ndarray, cx: int, cy: int, grade: int, herniation: int) -> None:
    """Texture-code one disc site: ``grade`` vertical bars; herniation = a
    block in the upper-left corner of the site. Texture (not brightness)
    survives the crop kernel's per-crop min-max normalization."""
    h = DISC_HALF
    img[cy - h : cy + h, cx - h : cx + h] = 40.0
    # 3-px bars on a 5-px pitch: wide enough to survive the rotated crop
    # mode's bilinear resampling.
    for bar in range(grade):
        x = cx - h + 2 + bar * 5
        img[cy - h + 2 : cy + h - 2, x : x + 3] = 230.0
    if herniation:
        img[cy - h : cy - h + 6, cx - h : cx - h + 6] = 255.0


def _render_slice(
    rng: np.random.Generator, grades: np.ndarray, herniations: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """One synthetic sagittal slice; returns (image [H,W], coords [5,2])."""
    h, w = SLICE_HW
    img = rng.normal(90.0, 10.0, (h, w)).clip(0, 255)
    coords = np.zeros((5, 2), np.float32)
    for i, y_norm in enumerate(LEVEL_YS):
        x_norm = 0.5 + float(rng.uniform(-0.06, 0.06))
        cx, cy = int(x_norm * w), int(y_norm * h)
        _draw_disc(img, cx, cy, int(grades[i]), int(herniations[i]))
        coords[i] = (x_norm, y_norm)
    return img.astype(np.float32), coords


def _write_csv(path: Path, rows: list[dict[str, Any]]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def _build_loc_dataset(
    root: Path, rng: np.random.Generator, n_images: int
) -> dict[str, np.ndarray]:
    """Render the localization set: ``root/annotations.csv`` and the image
    store. Each image is min-max stretched to uint8 (the fused pipeline
    stretches raw slices the same way before its forward) as three equal
    channels, the RGB array the JAX package's PNG reads back as."""
    root.mkdir(parents=True, exist_ok=True)
    store: dict[str, np.ndarray] = {}
    rows = []
    for i in range(n_images):
        grades = rng.integers(1, 6, size=5)
        herns = rng.integers(0, 2, size=5)
        img, coords = _render_slice(rng, grades, herns)
        name = f"images/slice_{i}.png"
        lo, hi = float(img.min()), float(img.max())
        gray = ((img - lo) / max(hi - lo, 1e-6) * 255.0).astype(np.uint8)
        store[name] = np.repeat(gray[..., None], 3, axis=-1)
        for level, (x, y) in zip(LEVELS, coords):
            rows.append({
                "image_path": name,
                "level": level,
                "relative_x": float(x),
                "relative_y": float(y),
                "series_type": "sag_t2",
                "source": "parity",
            })
    _write_csv(root / "annotations.csv", rows)
    return store


def _build_cls_dataset(
    root: Path,
    rng: np.random.Generator,
    n_patients: int,
    crop_pipelines: dict[str, SeriesCropPipeline],
) -> dict[str, np.ndarray]:
    """Render the classification set: full slices through the localization
    model's own loc -> crop stage, so the training crops carry the model's
    error and the crop kernel's resampling. Crop modes alternate per patient
    (a patient's two series share one), so one classifier sees both modes
    half and half. Writes ``root/annotations.csv``; returns the store of
    uint8 crop planes."""
    root.mkdir(parents=True, exist_ok=True)
    slices: dict[str, list[np.ndarray]] = {m: [] for m in crop_pipelines}
    meta: dict[str, list[tuple[str, str, np.ndarray, np.ndarray]]] = {
        m: [] for m in crop_pipelines
    }
    modes = sorted(crop_pipelines)
    for p in range(n_patients):
        pid = f"pp{p:03d}"
        grades = rng.integers(1, 6, size=5)
        herns = rng.integers(0, 2, size=5)
        mode = modes[p % len(modes)]
        for series in ("sag_t1", "sag_t2"):
            img, _coords = _render_slice(rng, grades, herns)
            slices[mode].append(img)
            meta[mode].append((pid, series, grades, herns))

    store: dict[str, np.ndarray] = {}
    rows = []
    for mode, pipeline in crop_pipelines.items():
        if not slices[mode]:
            continue
        _coords, _angles, crops = pipeline.run(slices[mode], [(1.0, 1.0)] * len(slices[mode]))
        for (pid, series, grades, herns), crop_set in zip(meta[mode], crops):
            for lvl in (1, 2, 3, 4, 5):
                name = f"images/{pid}_L{lvl}_{series}.png"
                store[name] = np.ascontiguousarray(crop_set[lvl - 1])
                rows.append({
                    "image_path": name,
                    "patient_id": pid,
                    "ivd_level": lvl,
                    "series_type": series,
                    "source": "parity",
                    "pfirrmann_grade": int(grades[lvl - 1]),
                    "disc_herniation": int(herns[lvl - 1]),
                    "disc_narrowing": 0,
                    "disc_bulging": 0,
                    "spondylolisthesis": 0,
                    "modic": 0,
                    "up_endplate": 0,
                    "low_endplate": 0,
                })
    _write_csv(root / "annotations.csv", rows)
    return store


def _render_heldout(
    rng: np.random.Generator, n_studies: int
) -> tuple[list[StudyInput], list[np.ndarray], list[np.ndarray], list[np.ndarray]]:
    """The held-out studies (T2 then T1 rendered from one grade draw) and
    their ground truth: (studies, T2 coords, grades, herniations)."""
    studies, gt_coords, gt_grades, gt_herns = [], [], [], []
    for i in range(n_studies):
        grades = rng.integers(1, 6, size=5)
        herns = rng.integers(0, 2, size=5)
        t2, coords = _render_slice(rng, grades, herns)
        t1, _ = _render_slice(rng, grades, herns)
        studies.append(StudyInput(
            t1_slice=t1, t2_slice=t2, t1_spacing=(1.0, 1.0), t2_spacing=(1.0, 1.0),
            study_id=f"parity{i}",
        ))
        gt_coords.append(coords)
        gt_grades.append(grades)
        gt_herns.append(herns)
    return studies, gt_coords, gt_grades, gt_herns


def _crop_cfg(mode: str) -> StudyPipelineConfig:
    return StudyPipelineConfig(
        loc_image_size=LOC_SIZE,
        crop_size=CROP_SIZE,
        crop_delta_mm=CROP_DELTA_MM,
        padded_hw=SLICE_HW,
        crop_mode=mode,
    )


@contextlib.contextmanager
def _deterministic_convolutions() -> Iterator[None]:
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = previous


@_deterministic_convolutions()
def run_parity(
    output_dir: Path,
    seed: int = 0,
    loc_epochs: int = 14,
    cls_epochs: int = 16,
    n_loc_images: int = 96,
    n_cls_patients: int = 120,
    n_heldout_studies: int = 24,
    norm_impl: str = "tpu",
    pool_impl: str = "flax",
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """Run the full parity suite on ``device``; returns (and writes to
    ``output_dir/parity_results.json``) the metric record.

    A seed gives one record, as in the JAX package: cuDNN's default
    algorithms may sum a convolution's gradient in a run-dependent order, so
    the suite runs with ``torch.backends.cudnn.deterministic`` set (and
    restores the flag after)."""
    if n_heldout_studies <= 0:
        raise ValueError("n_heldout_studies must be positive")

    output_dir = Path(output_dir)
    rng = np.random.default_rng(seed)
    # norm_impl/pool_impl: the ResNet BatchNorm and stem pool under test.
    record: dict[str, Any] = {"seed": seed, "norm_impl": norm_impl, "pool_impl": pool_impl}

    # ------------------------------------------------------------------ loc
    loc_root = output_dir / "loc_data"
    loc_store = _build_loc_dataset(loc_root, rng, n_loc_images)
    loc_config = LocalizationConfig(
        data_path=loc_root,
        output_path=output_dir / "loc_run",
        backbone="resnet18",
        pretrained=False,
        image_size=LOC_SIZE,
        batch_size=8,
        num_epochs=loc_epochs,
        learning_rate=2e-3,
        scheduler_type="cosine",
        early_stopping=False,
        mixed_precision=False,
        visualize_predictions=False,
        num_workers=0,
        val_split=0.2,
        # The held-out e2e studies come from the same clean rendering
        # distribution; augmentation only costs localization precision here.
        augment=False,
        seed=seed,
        norm_impl=norm_impl,
        pool_impl=pool_impl,
    )

    def loc_split(split: str) -> LocalizationDataset:
        return LocalizationDataset(
            loc_root, split=split, val_ratio=loc_config.val_split,
            image_size=loc_config.image_size,
            augment=loc_config.augment if split == "train" else False,
            seed=seed, image_store=loc_store,
        )

    loc_trainer = LocalizationTrainer(
        loc_config, train_dataset=loc_split("train"), val_dataset=loc_split("val"),
        device=device,
    )
    loc_trainer.train()
    loc_metrics = loc_trainer.evaluate(loc_split("test"))
    record["loc_med"] = float(loc_metrics.get("med", float("nan")))
    record["loc_pck_0.10"] = float(loc_metrics.get("pck@0.10", float("nan")))
    record["loc_med_threshold"] = 0.06
    record["loc_pass"] = record["loc_med"] < record["loc_med_threshold"]
    logger.info("parity loc: MED %.4f (threshold 0.06)", record["loc_med"])

    # ------------------------------------------------------------------ cls
    crop_pipelines = {
        mode: SeriesCropPipeline(loc_trainer.model, config=_crop_cfg(mode), device=device)
        for mode in ("horizontal", "rotated")
    }
    cls_root = output_dir / "cls_data"
    cls_store = _build_cls_dataset(cls_root, rng, n_cls_patients, crop_pipelines)
    cls_config = ClassificationConfig(
        data_path=cls_root,
        output_path=output_dir / "cls_run",
        backbone="resnet18",
        pretrained=False,
        target_labels=["pfirrmann", "herniation"],
        output_size=CROP_SIZE,
        batch_size=8,
        num_epochs=cls_epochs,
        learning_rate=2e-3,
        scheduler_type="cosine",
        early_stopping=False,
        augment=False,
        mixed_precision=False,
        visualize_predictions=False,
        num_workers=0,
        val_split=0.15,
        seed=seed,
        norm_impl=norm_impl,
        pool_impl=pool_impl,
    )

    def cls_split(split: str) -> ClassificationDataset:
        return ClassificationDataset(
            cls_root, split=split, val_ratio=cls_config.val_split,
            target_labels=cls_config.target_labels, output_size=cls_config.output_size,
            augment=cls_config.augment if split == "train" else False,
            seed=seed, image_store=cls_store,
        )

    cls_trainer = ClassificationTrainer(
        cls_config, train_dataset=cls_split("train"), val_dataset=cls_split("val"),
        device=device,
    )
    cls_trainer.train()
    cls_metrics = cls_trainer.evaluate(cls_split("test"))
    record["cls_f1"] = float(cls_metrics.get("f1", cls_metrics.get("macro_f1", float("nan"))))
    # Grading AUC: mean of the defined per-task ROC-AUCs on the test split.
    record["cls_macro_auc"] = float(cls_metrics.get("macro_auc", float("nan")))
    # _pct suffix: ClassifierMetrics accuracies are 0-100 while every
    # other accuracy in this record is a 0-1 fraction.
    record["cls_pfirrmann_accuracy_pct"] = float(
        cls_metrics.get("pfirrmann_accuracy", float("nan"))
    )
    record["cls_f1_threshold"] = 0.85
    record["cls_pass"] = record["cls_f1"] > record["cls_f1_threshold"]
    logger.info("parity cls: F1 %.4f (threshold 0.85)", record["cls_f1"])

    # ---------------------------------------------------------- fused infer
    tasks = get_tasks(["pfirrmann", "herniation"])
    pipeline = StudyInferencePipeline(
        loc_trainer.model, cls_trainer.model, config=_crop_cfg("horizontal"), tasks=tasks,
        device=device,
    )
    studies, gt_coords, gt_grades, gt_herns = _render_heldout(rng, n_heldout_studies)

    # fetch_crops=True: the crops feed the rotated-vs-horizontal evidence.
    results = pipeline.run(studies, fetch_crops=True)
    med_norm: list[float] = []
    grade_hits = hern_hits = total = 0
    pf_probs_all: list[np.ndarray] = []
    hern_probs_all: list[np.ndarray] = []
    for res, coords, grades, herns in zip(results, gt_coords, gt_grades, gt_herns):
        med_norm.extend(np.linalg.norm(res.coords[1] - coords, axis=-1).tolist())  # T2 series
        # The pipeline's own decoded predictions (the serving path's rule).
        pf_pred = np.asarray(res.predictions["pfirrmann"]) + 1  # [L]
        hern_pred = np.asarray(res.predictions["herniation"]).astype(int).ravel()
        grade_hits += int((pf_pred == grades).sum())
        hern_hits += int((hern_pred == herns).sum())
        total += len(grades)
        pf_probs_all.append(np.asarray(res.probabilities["pfirrmann"]))
        hern_probs_all.append(np.asarray(res.probabilities["herniation"]).ravel())
    record["e2e_loc_med"] = float(np.mean(med_norm))
    record["e2e_grade_accuracy"] = grade_hits / total
    record["e2e_herniation_accuracy"] = hern_hits / total
    record["e2e_pfirrmann_macro_auc"] = macro_ovr_auc(
        np.concatenate(pf_probs_all, axis=0), np.concatenate([g - 1 for g in gt_grades])
    )
    record["e2e_herniation_auc"] = roc_auc(
        np.concatenate(hern_probs_all), np.concatenate(gt_herns)
    )
    record["e2e_loc_med_threshold"] = 0.06
    record["e2e_grade_accuracy_threshold"] = 0.75
    record["e2e_pfirrmann_macro_auc_threshold"] = 0.70
    record["e2e_herniation_auc_threshold"] = 0.75
    # A NaN AUC (a degenerate held-out label draw) fails the gate; say so.
    record["e2e_auc_defined"] = bool(
        not math.isnan(record["e2e_pfirrmann_macro_auc"])
        and not math.isnan(record["e2e_herniation_auc"])
    )
    if not record["e2e_auc_defined"]:
        logger.warning(
            "parity e2e: an AUC is undefined (NaN: degenerate held-out label draw, seed %d); "
            "e2e_pass will fail on definedness, not on ranking quality", seed,
        )
    record["e2e_pass"] = (
        record["e2e_loc_med"] < record["e2e_loc_med_threshold"]
        and record["e2e_grade_accuracy"] > record["e2e_grade_accuracy_threshold"]
        and record["e2e_pfirrmann_macro_auc"] > record["e2e_pfirrmann_macro_auc_threshold"]
        and record["e2e_herniation_auc"] > record["e2e_herniation_auc_threshold"]
    )
    logger.info(
        "parity e2e: MED %.4f grade-acc %.3f herniation-acc %.3f pfirrmann-AUC %.3f "
        "herniation-AUC %.3f", record["e2e_loc_med"], record["e2e_grade_accuracy"],
        record["e2e_herniation_accuracy"], record["e2e_pfirrmann_macro_auc"],
        record["e2e_herniation_auc"],
    )

    # -------------------------------------------- rotated-crop-mode e2e
    # Same studies, same trained weights, rotated crop mode.
    rotated_pipeline = StudyInferencePipeline(
        loc_trainer.model, cls_trainer.model, config=_crop_cfg("rotated"), tasks=tasks,
        device=device,
    )
    rot_results = rotated_pipeline.run(studies, fetch_crops=True)
    rot_med: list[float] = []
    rot_grade_hits = rot_total = disagreements = 0
    abs_angles: list[float] = []
    crop_deltas = []
    for res, hres, coords, grades in zip(rot_results, results, gt_coords, gt_grades):
        rot_med.extend(np.linalg.norm(res.coords[1] - coords, axis=-1).tolist())
        pf_pred = np.asarray(res.predictions["pfirrmann"]) + 1
        rot_grade_hits += int((pf_pred == grades).sum())
        rot_total += len(grades)
        # Material-difference evidence: the rotated branch must change the
        # crops it feeds the classifier, or a silent fall-through to
        # horizontal cropping would pass on identical accuracies.
        abs_angles.extend(np.abs(res.angles).ravel().tolist())
        crop_deltas.append(
            np.abs(res.crops.astype(np.float32) - hres.crops.astype(np.float32)).mean()
        )
        h_pf = np.asarray(hres.predictions["pfirrmann"]) + 1
        disagreements += int((pf_pred != h_pf).sum())
    record["e2e_rotated_loc_med"] = float(np.mean(rot_med))
    record["e2e_rotated_grade_accuracy"] = rot_grade_hits / rot_total
    record["e2e_rotated_loc_med_threshold"] = record["e2e_loc_med_threshold"]
    record["e2e_rotated_grade_accuracy_threshold"] = 0.75
    record["e2e_rotated_mean_abs_angle_deg"] = float(np.mean(abs_angles))
    record["e2e_crop_mode_mean_abs_pixel_delta"] = float(np.mean(crop_deltas))
    record["e2e_crop_mode_grade_disagreements"] = int(disagreements)
    record["e2e_crop_mode_comparisons"] = int(rot_total)
    # A real rotated pass rotates by degrees, and its resampled crops differ
    # by whole gray levels on average.
    record["e2e_rotated_materially_differs"] = bool(
        record["e2e_rotated_mean_abs_angle_deg"] > 1.0
        and record["e2e_crop_mode_mean_abs_pixel_delta"] > 1.0
    )
    record["e2e_rotated_pass"] = (
        record["e2e_rotated_loc_med"] < record["e2e_loc_med_threshold"]
        and record["e2e_rotated_grade_accuracy"] > record["e2e_rotated_grade_accuracy_threshold"]
        and record["e2e_rotated_materially_differs"]
    )
    logger.info(
        "parity e2e rotated: MED %.4f grade-acc %.3f mean|angle| %.2f deg crop-delta %.2f "
        "gray levels, %d/%d grade predictions changed", record["e2e_rotated_loc_med"],
        record["e2e_rotated_grade_accuracy"], record["e2e_rotated_mean_abs_angle_deg"],
        record["e2e_crop_mode_mean_abs_pixel_delta"], disagreements, rot_total,
    )

    record["all_pass"] = bool(
        record["loc_pass"] and record["cls_pass"] and record["e2e_pass"]
        and record["e2e_rotated_pass"]
    )
    with open(output_dir / "parity_results.json", "w") as f:
        json.dump(record, f, indent=2)
    return record
