"""Localization trainer: coordinate regression over 5 IVD levels.

Counterpart of ``spine_vision_tpu/train/localization.py``: masked smooth-L1
(or mse, Huber) loss, MED/PCK metrics, MED-based best-model gating,
coordinate-aware augmentation on the device, and ``evaluate`` on a test set.
Without injected datasets the trainer reads ``config.data_path`` (PNGs and
``annotations.csv``, ``data/datasets.py``'s ``LocalizationDataset``), and
``evaluate()`` its test split; injected datasets are any indexable of such
samples (uint8 ``image`` ``[H, W, 3]``, ``coords`` ``[5, 2]``, ``mask``
``[5]``, ``series_type_idx``, ``metadata``).

The model trains in bf16 on f32 master weights with the hybrid ConvNeXt
block (``use_pallas="hybrid"``), the JAX package's training default on its
accelerator, with ``use_pallas_dwconv=True`` the all-kernel block
(``use_pallas=True``), or with ``use_pallas_mlp=True`` alone the LN-fused MLP
mode (``use_pallas="mlp"``); a model built with ``use_pallas="block"`` and
handed to the trainer trains the whole-block training kernel. ResNet-18 and
-34 backbones train too (cuDNN convolutions, training BatchNorm). On the CPU
the same function runs through the kernels' plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from spine_vision_torch.core.registry import register_trainer
from spine_vision_torch.data.datasets import LocalizationDataset
from spine_vision_torch.data.levels import IDX_TO_LEVEL, NUM_LEVELS
from spine_vision_torch.data.loader import collate_localization
from spine_vision_torch.metrics import LocalizationMetrics
from spine_vision_torch.models.classifier import CoordinateRegressor
from spine_vision_torch.models.convnext import CONVNEXT_CONFIGS
from spine_vision_torch.ops.augment import AugmentConfig, augment_batch
from spine_vision_torch.ops.image import imagenet_normalize
from spine_vision_torch.ops.losses import masked_coordinate_loss
from spine_vision_torch.train.trainer import (
    EVALUATE_SINGLE_CONTROLLER,
    BaseTrainer,
    TrainingConfig,
    _not_ported,
    logger,
)


@dataclass
class LocalizationConfig(TrainingConfig):
    """Configuration for localization training."""

    task: str = "localization"

    backbone: str = "convnext_base"
    pretrained: bool = True
    dropout: float = 0.2
    loss_type: str = "smooth_l1"  # mse | smooth_l1 | huber
    num_levels: int = NUM_LEVELS

    series_types: list[str] | None = None
    sources: list[str] | None = None
    image_size: tuple[int, int] = (512, 512)
    augment: bool = True

    use_pallas_mlp: bool | None = None
    """None: the hybrid training block (the kernels on the card, their plain
    versions on the CPU). False: plain ops. True: the LN-fused MLP mode
    (``use_pallas="mlp"``: a plain depthwise conv, then the LN+MLP kernels)."""
    use_pallas_dwconv: bool = False
    """With ``use_pallas_mlp`` None or True: the all-kernel block
    (``use_pallas=True``: the block kernel forward, the MLP and dwconv+LN
    backward kernels; the dwconv+LN kernels for C > 512). With
    ``use_pallas_mlp=False``: plain ops."""

    norm_impl: str = "tpu"
    """ResNet BatchNorm: "tpu" (``ops/batchnorm.py``) or "flax" (Flax's
    ``nn.BatchNorm``, ``models/layers.py::FlaxBatchNorm``)."""
    pool_impl: str = "flax"
    """ResNet stem max pool: "flax" (``F.max_pool2d``, -inf padding) or
    "tpu" (``ops/pool.py``'s scatter-free pool)."""

    pck_thresholds: list[float] = field(default_factory=lambda: [0.02, 0.05, 0.10])
    visualize_predictions: bool = False
    """The JAX package draws predictions each epoch (default on there); the
    port has no viz module yet, so True raises."""
    num_visualization_samples: int = 16


def resolve_use_pallas(use_pallas_mlp: bool | None, use_pallas_dwconv: bool) -> bool | str:
    """The model's ``use_pallas`` for the training flags, as the JAX package's
    ``_resolve_use_pallas`` on its accelerator."""
    if use_pallas_dwconv:
        return use_pallas_mlp is not False
    if use_pallas_mlp is None:
        return "hybrid"
    return "mlp" if use_pallas_mlp else False


@register_trainer("localization", config_cls=LocalizationConfig)
class LocalizationTrainer(BaseTrainer[LocalizationConfig]):
    """Trainer for IVD localization with coordinate regression."""

    def __init__(
        self,
        config: LocalizationConfig,
        model: CoordinateRegressor | None = None,
        train_dataset: Any | None = None,
        val_dataset: Any | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if config.visualize_predictions:
            raise _not_ported("visualize_predictions (viz/*)", "Queue 1 item 13")
        dev = torch.device(device)
        if (not config.mixed_precision and dev.type == "cuda"
                and config.backbone in CONVNEXT_CONFIGS):
            raise _not_ported(
                "mixed_precision=False on the card (f32 forms of the ConvNeXt kernels)",
                "Queue 1 item 15"
            )
        if config.pretrained and config.pretrained_path is None:
            logger.warning(
                "pretrained=True has no effect without pretrained_path: training "
                "proceeds from the model's current (random or loaded) weights."
            )
        if train_dataset is None:
            train_dataset = self._split_from_disk(config, "train")
        if val_dataset is None:
            val_dataset = self._split_from_disk(config, "val")
        self._aug_cfg = AugmentConfig()
        super().__init__(
            config, model, train_dataset, val_dataset,
            collate_fn=collate_localization, device=device,
        )
        self.metrics = LocalizationMetrics(
            pck_thresholds=config.pck_thresholds, level_names=list(IDX_TO_LEVEL.values())
        )

    def _build_model(self, device: torch.device) -> CoordinateRegressor:
        config = self.config
        return CoordinateRegressor(
            backbone_name=config.backbone,
            num_outputs=2,
            num_levels=config.num_levels,
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
    def _split_from_disk(config: LocalizationConfig, split: str) -> LocalizationDataset:
        return LocalizationDataset(
            data_path=config.data_path, split=split, val_ratio=config.val_split,
            series_types=config.series_types, sources=config.sources,
            image_size=config.image_size, augment=config.augment and split == "train",
            seed=config.seed,
        )

    def _preprocess_fn(self) -> Callable:
        augment, aug_cfg = self.config.augment, self._aug_cfg

        shard = self._draw_shard

        def preprocess(batch: dict[str, Any], generator: torch.Generator, train: bool):
            images = batch["image"].float() / 255.0
            coords = batch["coords"]
            if train and augment:
                images, coords = augment_batch(generator, images, coords, aug_cfg, shard)
            return {**batch, "image": imagenet_normalize(images), "coords": coords}

        return preprocess

    def _loss_from_outputs(self, outputs: torch.Tensor, batch: dict[str, Any]) -> torch.Tensor:
        """The masked coordinate loss; over more than one rank, divided by the
        group's count of visible coordinates (:meth:`_counted_rows`)."""
        mask, num_valid = self._counted_rows(batch, batch["mask"], per_row=outputs.shape[-1])
        return masked_coordinate_loss(outputs, batch["coords"], mask, self.config.loss_type,
                                      num_valid=num_valid)

    @staticmethod
    def _flatten_with_mask(
        predictions: np.ndarray, targets: np.ndarray, masks: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``[N, L, 2]``/``[N, L]`` -> the valid ``([M, 2], [M, 2], [M])``."""
        valid = masks > 0
        levels = np.broadcast_to(np.arange(masks.shape[1])[None, :], masks.shape)
        return (
            predictions[valid].reshape(-1, 2),
            targets[valid].reshape(-1, 2),
            levels[valid].reshape(-1),
        )

    def _compute_metrics(self, outputs_list: list[Any], batches: list[Any]) -> dict[str, float]:
        preds = np.concatenate(outputs_list, axis=0)
        targets = np.concatenate([np.asarray(b["coords"]) for b in batches], axis=0)
        masks = np.concatenate([np.asarray(b["mask"]) for b in batches], axis=0)
        return self.metrics.compute(*self._flatten_with_mask(preds, targets, masks))

    def on_train_begin(self) -> None:
        stats = getattr(self.train_dataset, "get_stats", None)
        if stats is not None:
            logger.info("Train dataset stats: %s", stats())

    def get_metric_for_checkpoint(self, val_loss: float | None, metrics: dict[str, float]) -> float:
        if "med" in metrics:
            return metrics["med"]
        return super().get_metric_for_checkpoint(val_loss, metrics)

    def evaluate(self, test_dataset: Any | None = None) -> dict[str, float]:
        """MED, PCK and the per-level metrics of the model on ``test_dataset``,
        by default the test split of ``config.data_path`` ({} when it is
        empty). Single-process only, as in the JAX package."""
        if self.mesh_ctx.world_size > 1:
            raise NotImplementedError(EVALUATE_SINGLE_CONTROLLER)
        if test_dataset is None:
            test_dataset = self._split_from_disk(self.config, "test")
        return self._test_metrics(test_dataset)
