"""Multi-task ``Classifier`` and ``CoordinateRegressor``, and the
multi-task loss.

Counterparts of ``spine_vision_tpu/models/classifier.py``. The default heads
run in f32, as the Flax heads (no ``dtype``) do on the backbone's f32
features; a ``CoordinateRegressor``'s ``head_config`` head runs in the
model's dtype, as the JAX ``create_head(config, out, self.dtype)``.
Dropout acts in training mode only and draws from the generator passed to
``forward``; with ``shard`` (``ops/draws.py``) its masks are this rank's rows
of the global batch's. Both models are built in eval mode, as inference callers
expect; the trainer switches them with ``train()``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.core.tasks import (
    TaskConfig,
    create_loss_functions,
    get_strategy,
    get_tasks,
)
from spine_vision_torch.core.registry import register_model
from spine_vision_torch.device import resolve_device
from spine_vision_torch.models.backbone import create_backbone
from spine_vision_torch.models.heads import HeadConfig, create_head
from spine_vision_torch.models.layers import Dense, LayerNorm
from spine_vision_torch.ops.draws import DrawShard, rand
from spine_vision_torch.ops.losses import masked_coordinate_loss


@register_model("classifier")
class Classifier(nn.Module):
    """backbone -> pooled features -> Dropout(p) -> one Dense per task ->
    ``{task: logits}``.

    ``use_pallas``, ``param_dtype``, ``norm_impl`` and ``pool_impl`` go to
    the backbone factory (``use_pallas`` and ``param_dtype`` as for
    ``CoordinateRegressor``; only ConvNeXt has kernels). The backbone
    defaults to ResNet-50, as the JAX ``Classifier``'s."""

    def __init__(
        self, backbone_name: str = "resnet50", tasks: tuple[TaskConfig, ...] = (),
        dtype=torch.bfloat16, device="cuda",
        generator: torch.Generator | None = None, dropout: float = 0.3,
        use_pallas: bool | str = True, param_dtype=None, norm_impl: str = "tpu",
        pool_impl: str = "flax",
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.tasks = tuple(tasks) or tuple(get_tasks())
        self.dropout = dropout
        self.backbone, self.feature_dim = create_backbone(
            backbone_name, dtype=dtype, device=device, generator=generator,
            use_pallas=use_pallas, param_dtype=param_dtype, norm_impl=norm_impl,
            pool_impl=pool_impl,
        )
        for task in self.tasks:
            self.add_module(
                f"head_{task.name}",
                Dense(self.feature_dim, task.num_classes, device=device, generator=generator),
            )
        self.eval()

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None,
        shard: DrawShard | None = None,
    ) -> dict[str, torch.Tensor]:
        """``generator`` feeds the dropout mask in training mode."""
        features = self.backbone(x)
        if self.training:
            features = dropout(features, self.dropout, generator, shard)
        return {t.name: getattr(self, f"head_{t.name}")(features) for t in self.tasks}


Outputs = dict[str, torch.Tensor]


def make_multitask_loss_fn(
    tasks: list[TaskConfig] | tuple[TaskConfig, ...],
) -> Callable[..., torch.Tensor]:
    """The weighted multi-task loss ``sum_i w_i * loss_i`` over the tasks
    present in both the predictions and the targets (strategy-formatted).

    The returned ``loss_fn(predictions, targets, sample_weight=None,
    weight_total=None)`` takes an optional ``[B]`` ``sample_weight``: each
    task's loss is then the weighted mean of its per-sample losses,
    ``sum(l * w) / max(sum(w), 1)``. ``weight_total`` replaces that divisor: a
    data-parallel rank passes the group's ``max(sum(w), 1)`` over the world
    size, so that the ranks' mean is the global batch's loss. The plain means
    need no such count: every rank holds an equal share of the batch.
    """
    tasks = list(tasks)
    loss_fns, loss_weights = create_loss_functions(tasks)
    strategies = {t.name: get_strategy(t) for t in tasks}
    per_sample_fns = {t.name: strategies[t.name].per_sample_loss_fn(t) for t in tasks}

    def loss_fn(
        predictions: Outputs, targets: Outputs, sample_weight: torch.Tensor | None = None,
        weight_total: torch.Tensor | None = None,
    ) -> torch.Tensor:
        device = next(iter(predictions.values())).device
        total = torch.zeros((), dtype=torch.float32, device=device)
        for task in tasks:
            name = task.name
            if name not in predictions or name not in targets:
                continue
            target = strategies[name].format_target(targets[name])
            if sample_weight is not None:
                w = sample_weight.float()
                per_sample = per_sample_fns[name](predictions[name], target)
                divisor = torch.clamp(w.sum(), min=1.0) if weight_total is None else weight_total
                task_loss = (per_sample * w).sum() / divisor
            else:
                task_loss = loss_fns[name](predictions[name], target)
            total = total + loss_weights[name] * task_loss
        return total

    return loss_fn


def make_multitask_loss_breakdown_fn(
    tasks: list[TaskConfig] | tuple[TaskConfig, ...],
) -> Callable[[Outputs, Outputs], Outputs]:
    """Each task's (unweighted) loss, by task name."""
    tasks = list(tasks)
    loss_fns, _ = create_loss_functions(tasks)
    strategies = {t.name: get_strategy(t) for t in tasks}

    def breakdown(predictions: Outputs, targets: Outputs) -> Outputs:
        return {
            t.name: loss_fns[t.name](
                predictions[t.name], strategies[t.name].format_target(targets[t.name]))
            for t in tasks if t.name in predictions and t.name in targets
        }

    return breakdown


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator | None,
    shard: DrawShard | None = None,
) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability ``1 - rate``, scaled by
    ``1 / (1 - rate)``; the mask is drawn from ``generator`` (this rank's rows
    of the global batch's mask with ``shard``). The heads of
    ``models/heads.py`` drop through it too."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = rand(x.shape, generator, x.device, shard) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


@register_model("coordinate_regressor")
class CoordinateRegressor(nn.Module):
    """backbone -> LayerNorm -> Dropout(p) -> Dense(256) -> erf-GELU ->
    Dropout(p/2) -> Dense(L*2) -> sigmoid, giving ``[B, num_levels,
    num_outputs]`` normalised coordinates. A ``head_config``
    (``models/heads.py``) replaces that head by ``create_head(head_config,
    L*2, dtype)`` (no sigmoid), named ``head``, in the model's dtype.

    ``use_pallas`` and ``param_dtype`` go to the backbone factory: with
    ``param_dtype=torch.float32``, ``use_pallas="hybrid"`` is the training
    default, ``True``, ``"mlp"`` and ``"block"`` the JAX package's other
    kernel modes."""

    def __init__(
        self, backbone_name: str = "convnext_base", num_outputs: int = 2,
        num_levels: int = 5, dtype=torch.bfloat16, device="cuda",
        generator: torch.Generator | None = None, dropout: float = 0.2,
        use_pallas: bool | str = True, param_dtype=None, norm_impl: str = "tpu",
        pool_impl: str = "flax", head_config: HeadConfig | None = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_outputs, self.num_levels, self.dropout = num_outputs, num_levels, dropout
        self.backbone, self.feature_dim = create_backbone(
            backbone_name, dtype=dtype, device=device, generator=generator,
            use_pallas=use_pallas, param_dtype=param_dtype, norm_impl=norm_impl,
            pool_impl=pool_impl,
        )
        total = num_levels * num_outputs
        self.head_config = head_config
        if head_config is not None:
            self.head = create_head(head_config, total, dtype, in_features=self.feature_dim,
                                    device=device, generator=generator, param_dtype=param_dtype)
        else:
            self.head_norm = LayerNorm(self.feature_dim, device=device)
            self.head_fc1 = Dense(self.feature_dim, 256, device=device, generator=generator)
            self.head_fc2 = Dense(256, total, device=device, generator=generator)
        self.eval()

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None,
        shard: DrawShard | None = None,
    ) -> torch.Tensor:
        """``generator`` feeds the dropout masks in training mode."""
        features = self.backbone(x)
        if self.head_config is not None:
            out = self.head(features, generator, shard)
            return out.reshape(-1, self.num_levels, self.num_outputs)
        y = self.head_norm(features)
        if self.training:
            y = dropout(y, self.dropout, generator, shard)
        y = F.gelu(self.head_fc1(y), approximate="none")
        if self.training:
            y = dropout(y, self.dropout / 2, generator, shard)
        out = torch.sigmoid(self.head_fc2(y))
        return out.reshape(-1, self.num_levels, self.num_outputs)


def make_coordinate_loss_fn(
    loss_type: str = "smooth_l1",
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor | None], torch.Tensor]:
    """The masked coordinate loss of ``loss_type`` as a function of
    ``(predictions, targets, mask=None)``."""

    def loss_fn(predictions, targets, mask=None):
        return masked_coordinate_loss(predictions, targets, mask, loss_type)

    return loss_fn


def coords_to_pixels(coords: torch.Tensor, image_size: tuple[int, int]) -> torch.Tensor:
    """Normalised [0, 1] coordinates -> pixel coordinates for (H, W) images."""
    h, w = image_size
    return coords * torch.tensor([w, h], dtype=coords.dtype, device=coords.device)
