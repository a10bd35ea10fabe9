"""Train state: the model, its optimizer and schedule, the update count and
the generator that feeds dropout and augmentation; in a data-parallel run
also the ``DistributedDataParallel`` replica that the train step calls and
this rank's place on the data axis, which shapes the draws.

Counterpart of ``spine_vision_tpu/train/state.py``. JAX threads an immutable
pytree through pure steps; here the state is one object that the steps
update in place (the model's parameters and the optimizer's moments).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from spine_vision_torch.ops.draws import DrawShard
from spine_vision_torch.train.schedules import Schedule


@dataclass
class TrainState:
    """Everything a train step reads and advances."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    generator: torch.Generator
    grad_clip: float | None = 1.0
    step: int = 0
    lr_override: float | None = None  # set by the plateau scheduler
    replica: nn.Module | None = None  # the model's DDP wrapper, when there is a group
    draw_shard: DrawShard | None = None  # this rank's place, when the world is above 1
    last_lr: float = field(init=False)

    def __post_init__(self) -> None:
        self.last_lr = self.lr_for_next_update()

    def lr_for_next_update(self) -> float:
        """The learning rate of update number ``step`` (counted from 0)."""
        if self.lr_override is not None:
            return self.lr_override
        return float(self.schedule(self.step))

    def set_lr(self, lr: float) -> None:
        """Fix the learning rate from now on (plateau decay)."""
        self.lr_override = lr
        self.last_lr = lr

    def trainable(self) -> list[nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]
