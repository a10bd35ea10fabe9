"""Multi-task ``Classifier`` and ``CoordinateRegressor``, inference.

Counterparts of ``spine_vision_tpu/models/classifier.py``. Dropout is the
identity at inference and is left out. The heads run in f32, as the Flax
heads (no ``dtype``) do on the backbone's f32 features.
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


class CoordinateRegressor(nn.Module):
    """backbone -> LayerNorm -> Dense(256) -> erf-GELU -> Dense(L*2) -> sigmoid,
    giving ``[B, num_levels, num_outputs]`` normalised coordinates."""

    def __init__(
        self, backbone_name: str = "convnext_base", num_outputs: int = 2,
        num_levels: int = 5, dtype=torch.bfloat16, device="cuda",
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_outputs, self.num_levels = num_outputs, num_levels
        self.backbone, self.feature_dim = create_backbone(
            backbone_name, dtype=dtype, device=device, generator=generator
        )
        self.head_norm = LayerNorm(self.feature_dim, device=device)
        self.head_fc1 = Dense(self.feature_dim, 256, device=device, generator=generator)
        self.head_fc2 = Dense(256, num_levels * num_outputs, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.head_norm(self.backbone(x))
        y = F.gelu(self.head_fc1(y), approximate="none")
        out = torch.sigmoid(self.head_fc2(y))
        return out.reshape(-1, self.num_levels, self.num_outputs)
