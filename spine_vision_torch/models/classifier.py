"""Multi-task ``Classifier`` (inference) and ``CoordinateRegressor``
(inference and training).

Counterparts of ``spine_vision_tpu/models/classifier.py``. The heads run in
f32, as the Flax heads (no ``dtype``) do on the backbone's f32 features. The
regressor's dropout acts in training mode only and draws from the generator
passed to ``forward``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spine_vision_torch.core.tasks import TaskConfig, get_tasks
from spine_vision_torch.device import resolve_device
from spine_vision_torch.models.backbone import create_backbone
from spine_vision_torch.models.layers import Dense, LayerNorm


class Classifier(nn.Module):
    """backbone -> pooled features -> one Dense per task -> ``{task: logits}``."""

    def __init__(
        self, backbone_name: str = "resnet18", tasks: tuple[TaskConfig, ...] = (),
        dtype=torch.bfloat16, device="cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.tasks = tuple(tasks) or tuple(get_tasks())
        self.backbone, self.feature_dim = create_backbone(
            backbone_name, dtype=dtype, device=device, generator=generator
        )
        for task in self.tasks:
            self.add_module(
                f"head_{task.name}",
                Dense(self.feature_dim, task.num_classes, device=device, generator=generator),
            )

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        features = self.backbone(x)
        return {t.name: getattr(self, f"head_{t.name}")(features) for t in self.tasks}


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator | None
) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability ``1 - rate``, scaled by
    ``1 / (1 - rate)``; the mask is drawn from ``generator``."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class CoordinateRegressor(nn.Module):
    """backbone -> LayerNorm -> Dropout(p) -> Dense(256) -> erf-GELU ->
    Dropout(p/2) -> Dense(L*2) -> sigmoid, giving ``[B, num_levels,
    num_outputs]`` normalised coordinates.

    ``use_pallas`` and ``param_dtype`` go to the backbone factory:
    ``use_pallas="hybrid"`` with ``param_dtype=torch.float32`` is the training
    configuration. It is built in eval mode, as inference callers expect;
    the trainer switches it with ``train()``."""

    def __init__(
        self, backbone_name: str = "convnext_base", num_outputs: int = 2,
        num_levels: int = 5, dtype=torch.bfloat16, device="cuda",
        generator: torch.Generator | None = None, dropout: float = 0.2,
        use_pallas: bool | str = True, param_dtype=None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_outputs, self.num_levels, self.dropout = num_outputs, num_levels, dropout
        self.backbone, self.feature_dim = create_backbone(
            backbone_name, dtype=dtype, device=device, generator=generator,
            use_pallas=use_pallas, param_dtype=param_dtype,
        )
        self.head_norm = LayerNorm(self.feature_dim, device=device)
        self.head_fc1 = Dense(self.feature_dim, 256, device=device, generator=generator)
        self.head_fc2 = Dense(256, num_levels * num_outputs, device=device, generator=generator)
        self.eval()

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """``generator`` feeds the dropout masks in training mode."""
        y = self.head_norm(self.backbone(x))
        if self.training:
            y = dropout(y, self.dropout, generator)
        y = F.gelu(self.head_fc1(y), approximate="none")
        if self.training:
            y = dropout(y, self.dropout / 2, generator)
        out = torch.sigmoid(self.head_fc2(y))
        return out.reshape(-1, self.num_levels, self.num_outputs)
