"""Classification trainer: multi-task lumbar-spine grading.

Counterpart of ``spine_vision_tpu/train/classification.py``: per-task
training-time overrides (label smoothing for multiclass, optional focal loss
for binary), the weighted multi-task loss, weighted sampling on a chosen
label, augmentation without horizontal flips, ``ClassifierMetrics``
validation with best-model gating on ``-f1`` (one task) or ``-macro_f1``,
an optionally frozen backbone for the first epochs, and test-set
evaluation.

Without injected datasets the trainer reads ``config.data_path`` (gray PNG
crops and ``annotations.csv``, ``data/datasets.py``'s
``ClassificationDataset``), and ``evaluate()`` its test split; injected
datasets are any indexable of classification samples (uint8 ``image``
``[H, W, 3]``, ``targets`` ``{task: label}``, ``level_idx``, ``metadata``)
with ``sample_label_values(label)`` when weighted sampling is on. The model
trains in bf16 on f32 master weights, on any backbone of the zoo
(ResNet-18 by default; training BatchNorm); a ConvNeXt backbone takes the
localization trainer's kernel modes. With ``visualize_predictions`` it draws
the JAX trainer's figures: the label distribution of the splits when
training starts, the training curves when it ends, and with
``evaluate(visualize=True)`` the test metrics and confusion matrices.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from spine_vision_torch.core.registry import register_trainer
from spine_vision_torch.core.tasks import (
    AVAILABLE_TASK_NAMES,
    TaskConfig,
    compute_probabilities_for_tasks,
    get_task,
)
from spine_vision_torch.data.datasets import ClassificationDataset
from spine_vision_torch.data.loader import (
    collate_classification,
    compute_inverse_frequency_weights,
)
from spine_vision_torch.metrics import ClassifierMetrics
from spine_vision_torch.models.classifier import Classifier, make_multitask_loss_fn
from spine_vision_torch.ops.augment import AugmentConfig, augment_batch
from spine_vision_torch.ops.image import imagenet_normalize
from spine_vision_torch.train.localization import resolve_use_pallas
from spine_vision_torch.train.trainer import (
    EVALUATE_SINGLE_CONTROLLER,
    BaseTrainer,
    TrainingConfig,
    TrainingResult,
    logger,
    training_visualizer,
)


def create_tasks_for_training(
    target_labels: list[str] | None = None,
    label_smoothing: float = 0.1,
    use_focal_loss: bool = False,
    focal_gamma: float = 2.0,
    focal_alpha: float | None = None,
) -> list[TaskConfig]:
    """The tasks (all registered ones when ``target_labels`` is None) with
    the training-time overrides: label smoothing on multiclass tasks, the
    focal-loss fields on binary ones."""
    if target_labels is None:
        labels = list(AVAILABLE_TASK_NAMES)
    else:
        invalid = set(target_labels) - set(AVAILABLE_TASK_NAMES)
        if invalid:
            raise ValueError(f"Invalid target labels: {invalid}. Available: {AVAILABLE_TASK_NAMES}")
        if len(set(target_labels)) != len(target_labels):
            # A duplicate would count twice in the multi-task loss.
            raise ValueError(f"Duplicate target labels: {target_labels}")
        labels = list(target_labels)

    tasks = []
    for label in labels:
        task = get_task(label)
        if task.is_multiclass:
            task = task.with_overrides(label_smoothing=label_smoothing)
        elif task.is_binary:
            task = task.with_overrides(use_focal_loss=use_focal_loss, focal_gamma=focal_gamma,
                                       focal_alpha=focal_alpha)
        tasks.append(task)
    return tasks


@dataclass
class ClassificationConfig(TrainingConfig):
    """Configuration for multi-task classification training."""

    task: str = "classification"
    data_path: Path = Path("data/processed/classification")

    backbone: str = "resnet18"
    pretrained: bool = True
    dropout: float = 0.3
    label_smoothing: float = 0.1

    use_weighted_sampling: bool = True
    sampler_label: str | None = None
    """The label whose inverse class frequency weights the sampling (the
    first target label when None)."""

    levels: list[str] | None = None
    series_types: list[str] | None = None
    target_labels: list[str] | None = None

    output_size: tuple[int, int] = (256, 256)
    augment: bool = True

    use_pallas_mlp: bool | None = None
    """ConvNeXt backbones only, as ``LocalizationConfig.use_pallas_mlp``."""
    use_pallas_dwconv: bool = False
    """ConvNeXt backbones only, as ``LocalizationConfig.use_pallas_dwconv``."""
    norm_impl: str = "tpu"
    """ResNet BatchNorm: "tpu" (``ops/batchnorm.py``) or "flax" (Flax's
    ``nn.BatchNorm``, ``models/layers.py::FlaxBatchNorm``)."""
    pool_impl: str = "flax"
    """ResNet stem max pool: "flax" (``F.max_pool2d``, -inf padding) or
    "tpu" (``ops/pool.py``'s scatter-free pool)."""

    use_focal_loss: bool = False
    focal_gamma: float = 2.0
    focal_alpha: float | None = None

    visualize_predictions: bool = False
    """Draw the JAX trainer's figures into ``logs/`` (matplotlib). Off by
    default, where the JAX package's default is on: the card's host may have
    no matplotlib. Off, the trainer draws no figure."""
    num_visualization_samples: int = 16
    max_samples_per_cell: int = 4


@register_trainer("classification", config_cls=ClassificationConfig)
class ClassificationTrainer(BaseTrainer[ClassificationConfig]):
    """Trainer for multi-task lumbar-spine classification."""

    # A task's head gets no gradient in a step whose batch lacks its targets.
    find_unused_parameters = True

    def __init__(
        self,
        config: ClassificationConfig,
        model: Classifier | None = None,
        train_dataset: Any | None = None,
        val_dataset: Any | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        visualizer = training_visualizer(config) if config.visualize_predictions else None
        if train_dataset is None:
            train_dataset = self._split_from_disk(config, "train")
        if val_dataset is None:
            val_dataset = self._split_from_disk(config, "val")
        target_labels = config.target_labels or list(AVAILABLE_TASK_NAMES)

        sample_weights = None
        if config.use_weighted_sampling and len(train_dataset) > 0:
            sampler_label = config.sampler_label or target_labels[0]
            sample_weights = compute_inverse_frequency_weights(
                train_dataset.sample_label_values(sampler_label)
            )
            logger.info("Using weighted sampling based on '%s' label", sampler_label)

        tasks = create_tasks_for_training(
            target_labels=config.target_labels,
            label_smoothing=config.label_smoothing,
            use_focal_loss=config.use_focal_loss,
            focal_gamma=config.focal_gamma,
            focal_alpha=config.focal_alpha,
        )
        if config.pretrained and config.pretrained_path is None:
            logger.warning(
                "pretrained=True has no effect without pretrained_path: training "
                "proceeds from the model's current (random or loaded) weights."
            )
        self._tasks = tasks
        self._target_labels = target_labels
        self._multitask_loss = make_multitask_loss_fn(tasks)
        # No horizontal flip for classification, as in the JAX package.
        self._aug_cfg = AugmentConfig(hflip_prob=0.0, flip_coords=False)
        super().__init__(
            config, model, train_dataset, val_dataset, collate_fn=collate_classification,
            device=device, sample_weights=sample_weights,
        )
        self.metrics = ClassifierMetrics(target_labels=target_labels)
        self.visualizer = None if visualizer is None else visualizer(
            output_path=config.logs_path, output_mode="image", tracker=self.tracker)

    def _build_model(self, device: torch.device) -> Classifier:
        config = self.config
        return Classifier(
            backbone_name=config.backbone,
            tasks=tuple(self._tasks),
            dropout=config.dropout,
            dtype=torch.bfloat16 if config.mixed_precision else torch.float32,
            device=device,
            generator=torch.Generator().manual_seed(config.seed),
            use_pallas=resolve_use_pallas(config.use_pallas_mlp, config.use_pallas_dwconv),
            param_dtype=torch.float32,
            norm_impl=config.norm_impl,
            pool_impl=config.pool_impl,
        )

    @staticmethod
    def _split_from_disk(config: ClassificationConfig, split: str) -> ClassificationDataset:
        return ClassificationDataset(
            data_path=config.data_path, split=split, val_ratio=config.val_split,
            levels=config.levels, series_types=config.series_types,
            target_labels=config.target_labels, output_size=config.output_size,
            augment=config.augment and split == "train", seed=config.seed,
        )

    def _preprocess_fn(self) -> Callable:
        augment, aug_cfg, shard = self.config.augment, self._aug_cfg, self._draw_shard

        def preprocess(batch: dict[str, Any], generator: torch.Generator, train: bool):
            images = batch["image"].float() / 255.0
            if train and augment:
                images, _ = augment_batch(generator, images, None, aug_cfg, shard)
            return {**batch, "image": imagenet_normalize(images)}

        return preprocess

    def _loss_from_outputs(self, outputs: dict[str, torch.Tensor], batch: dict[str, Any]):
        """The weighted multi-task loss. A train batch takes its plain means,
        which need nothing over more than one rank (equal shares of the
        batch). A batch with ``_valid`` (every eval batch above one rank)
        takes the weighted form: the rows the loader repeated weigh 0, and
        above one rank the weights' divisor is the group's
        (:meth:`_counted_rows`)."""
        if "_valid" not in batch:
            return self._multitask_loss(outputs, batch["targets"])
        ones = torch.ones(len(batch["_valid"]), device=batch["_valid"].device)
        weights, total = self._counted_rows(batch, ones)
        return self._multitask_loss(outputs, batch["targets"], sample_weight=weights,
                                    weight_total=total)

    def _compute_metrics(self, outputs_list: list[Any], batches: list[Any]) -> dict[str, float]:
        self.metrics.reset()
        for outputs, batch in zip(outputs_list, batches):
            self.metrics.update(outputs, batch["targets"])
        return self.metrics.compute()

    def on_train_begin(self) -> None:
        if len(self._target_labels) == len(AVAILABLE_TASK_NAMES):
            logger.info("Training on all labels (multi-task)")
        else:
            logger.info("Training on selected labels: %s", self._target_labels)
        stats = getattr(self.train_dataset, "get_stats", None)
        if stats is not None:
            logger.info("Train dataset stats: %s", stats())
        if self.visualizer is not None and self.mesh_ctx.is_main:
            self._visualize_label_distribution()

    def on_train_end(self, result: TrainingResult) -> None:
        # Curves only: the test evaluation is the caller's step, as in the JAX
        # package (its CLI runs evaluate(visualize=...) after train()).
        if self.visualizer is not None and self.mesh_ctx.is_main:
            try:
                self.visualizer.plot_training_curves(self.history, filename="training_curves")
            except Exception as exc:
                logger.warning("Final visualization failed: %s", exc)
            logger.info("Visualizations saved to: %s", self.config.logs_path)

    def _visualize_label_distribution(self) -> None:
        try:
            test_dataset = self._split_from_disk(self.config, "test")
            distributions = {
                "train": self.train_dataset.get_label_distribution(),
                "test": test_dataset.get_label_distribution(),
            }
            val_size = 0
            if self.val_dataset is not None:
                distributions["val"] = self.val_dataset.get_label_distribution()
                val_size = len(self.val_dataset)
            logger.info("Split sizes - Train: %d, Val: %d, Test: %d", len(self.train_dataset),
                        val_size, len(test_dataset))
            self.visualizer.plot_label_distribution(
                distributions=distributions, target_labels=self._target_labels,
                filename="label_distribution",
            )
        except Exception as exc:
            logger.warning("Label-distribution visualization failed: %s", exc)

    def get_metric_for_checkpoint(self, val_loss: float | None, metrics: dict[str, float]) -> float:
        if "f1" in metrics:
            return -metrics["f1"]
        if "macro_f1" in metrics:
            return -metrics["macro_f1"]
        return super().get_metric_for_checkpoint(val_loss, metrics)

    def evaluate(self, test_dataset: Any | None = None, visualize: bool = False,
                 max_samples_per_cell: int | None = None) -> dict[str, float]:
        """``ClassifierMetrics`` of the model on ``test_dataset``, by default
        the test split of ``config.data_path`` ({} when it is empty), with
        ``visualize`` the test metrics' bars, each task's confusion matrix
        with samples and the confusion summary (the trainer's visualizer, or
        one made for the call). Single-process only, as in the JAX package."""
        if self.mesh_ctx.world_size > 1:
            raise NotImplementedError(EVALUATE_SINGLE_CONTROLLER)
        if visualize and self.visualizer is None:
            self.visualizer = training_visualizer(self.config)(
                output_path=self.config.logs_path, output_mode="image", tracker=self.tracker)
        if test_dataset is None:
            test_dataset = self._split_from_disk(self.config, "test")
        seen: list = []
        metrics = self._test_metrics(
            test_dataset, on_outputs=lambda outs, batches: seen.extend(zip(outs, batches)))
        if visualize and seen:
            self._visualize_test(metrics, seen, max_samples_per_cell)
        return metrics

    def _visualize_test(self, metrics: dict[str, float], seen: list,
                        max_samples_per_cell: int | None) -> None:
        probs: dict[str, list] = {label: [] for label in self._target_labels}
        targets: dict[str, list] = {label: [] for label in self._target_labels}
        images: list = []
        metadata: list = []
        for outputs, batch in seen:
            batch_probs = compute_probabilities_for_tasks(outputs, self._tasks)
            for label in self._target_labels:
                if label in batch_probs:
                    probs[label].append(batch_probs[label])
                if label in batch["targets"]:
                    targets[label].append(np.asarray(batch["targets"][label]))
            images.extend(np.asarray(batch["image"]))
            metadata.extend(batch.get("metadata", []))
        if not metadata:
            return
        try:
            pred_arrays = {k: np.concatenate(v, axis=0) for k, v in probs.items() if v}
            target_arrays = {k: np.concatenate(v, axis=0) for k, v in targets.items() if v}
            self.visualizer.plot_classification_metrics(
                metrics=metrics, target_labels=self._target_labels, filename="test_metrics")
            self.visualizer.plot_confusion_matrices_with_samples(
                images=images, predictions=pred_arrays, targets=target_arrays,
                target_labels=self._target_labels, metadata=metadata,
                max_samples_per_cell=(max_samples_per_cell if max_samples_per_cell is not None
                                      else self.config.max_samples_per_cell),
                filename_prefix="confusion_matrix_samples",
            )
            self.visualizer.plot_confusion_summary(
                predictions=pred_arrays, targets=target_arrays,
                target_labels=self._target_labels, filename="confusion_summary",
            )
            logger.info("Test visualizations saved to: %s", self.config.logs_path)
        except Exception as exc:
            logger.warning("Test visualization failed: %s", exc)
