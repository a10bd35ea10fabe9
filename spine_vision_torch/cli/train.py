"""Training and evaluation CLI entry points.

Counterpart of ``spine_vision_tpu/cli/train.py``: a banner, training, then
the test split's evaluation (skipped above one process, as evaluate() is
single-process only), the ``evaluate`` command on a checkpoint, and the
``test`` command's timed inference on image files. Every function takes the
device its trainer or model runs on (``"cuda"`` by default).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spine_vision_torch.core.logging import logger
from spine_vision_torch.train.classification import ClassificationConfig, ClassificationTrainer
from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer


def _multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _log_multiprocess_eval_skip(output_path: str) -> None:
    # Trainer.evaluate() is single-process only (the metrics need the full
    # output set on one host); a distributed CLI run must not die after a
    # successful training, so point at the offline path.
    logger.info(
        "Skipping test-split evaluation: evaluate() is single-process only. Run "
        "`spine-vision-torch evaluate --checkpoint-path %s` in a single-process session "
        "to compute test metrics.",
        output_path,
    )


def _banner(title: str, backbone: str, size, output_path) -> None:
    logger.info("=" * 60)
    logger.info(title)
    logger.info("Backbone: %s @ %s", backbone, size)
    logger.info("Output: %s", output_path)
    logger.info("=" * 60)


def train_localization(config: LocalizationConfig, device: str = "cuda") -> dict[str, float]:
    """Train the coordinate regressor, then evaluate on the test split."""
    _banner("IVD Localization Training", config.backbone, config.image_size, config.output_path)
    trainer = LocalizationTrainer(config, device=device)
    result = trainer.train()
    logger.info("Training done: best %s at epoch %d", f"{result.best_metric:.4f}",
                result.best_epoch + 1)
    if _multiprocess():
        _log_multiprocess_eval_skip(config.output_path)
        return {}
    return trainer.evaluate()


def train_classification(config: ClassificationConfig, device: str = "cuda") -> dict[str, float]:
    """Train the multi-task grader, then evaluate on the test split."""
    _banner("IVD Multi-task Classification Training", config.backbone, config.output_size,
            config.output_path)
    trainer = ClassificationTrainer(config, device=device)
    result = trainer.train()
    logger.info("Training done: best %s at epoch %d", f"{result.best_metric:.4f}",
                result.best_epoch + 1)
    if _multiprocess():
        _log_multiprocess_eval_skip(config.output_path)
        return {}
    return trainer.evaluate(visualize=config.visualize_predictions)


def test_inference_command(
    checkpoint_path: str,
    images: list[str],
    model_kind: str = "classification",
    backbone: str = "resnet18",
    image_size: tuple[int, int] = (256, 256),
    device: str = "cuda",
) -> dict:
    """Timed inference on image files with a trained checkpoint: an f32
    model of ``backbone`` whose parameters and buffers are the checkpoint's
    (its optimizer state is not read, as the JAX command's
    ``restore_opt_state=False``)."""
    from spine_vision_torch.models import (
        Classifier,
        CoordinateRegressor,
        classifier_test_inference,
        regressor_test_inference,
    )
    from spine_vision_torch.train.checkpoint import load_model_state

    model_cls = Classifier if model_kind == "classification" else CoordinateRegressor
    model = model_cls(backbone_name=backbone, dtype=torch.float32, device=device)
    load_model_state(Path(checkpoint_path), model)

    if model_kind == "classification":
        result = classifier_test_inference(model, images, image_size=image_size)
        logger.info("Inference on %d images: %.1f ms", result["num_images"],
                    result["inference_time_ms"])
        for task, preds in result["predictions"].items():
            logger.info("  %s: %s", task, preds.tolist())
    else:
        result = regressor_test_inference(model, images, image_size=image_size)
        logger.info("Inference on %d images: %.1f ms", result["num_images"],
                    result["inference_time_ms"])
        for i, coords in enumerate(result["pixel_coordinates"]):
            logger.info("  image %d coords: %s", i, np.round(coords, 1).tolist())
    return result


def evaluate_localization(config: LocalizationConfig, device: str = "cuda") -> dict[str, float]:
    """Evaluate a localization checkpoint on the test split (no training)."""
    if config.checkpoint_path is None:
        raise SystemExit("evaluate requires --checkpoint-path")
    trainer = LocalizationTrainer(config, device=device)
    trainer._load(config.checkpoint_path)
    return trainer.evaluate()


def evaluate_classification(config: ClassificationConfig, device: str = "cuda"
                            ) -> dict[str, float]:
    """Evaluate a classification checkpoint on the test split (no training)."""
    if config.checkpoint_path is None:
        raise SystemExit("evaluate requires --checkpoint-path")
    trainer = ClassificationTrainer(config, device=device)
    trainer._load(config.checkpoint_path)
    return trainer.evaluate()
