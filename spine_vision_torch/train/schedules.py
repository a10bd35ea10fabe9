"""Learning-rate schedules, the optimizer and gradient clipping.

Counterpart of ``spine_vision_tpu/train/schedules.py``. The schedules are
plain functions of the update count with optax's formulas (the lr of update
``k``, counted from 0, is ``schedule(k)``): cosine to ``0.01 * lr`` over the
run after an optional linear warmup, step decay by ``gamma`` every
``step_size`` epochs, and a constant for ``plateau`` (which the trainer
lowers on a stalled validation loss) and ``none``. ``torch.optim.AdamW``
with optax's defaults matches ``optax.adamw`` update for update; clipping by
global norm uses optax's formula, ``g * c / ||g||`` when ``||g|| > c``
(``clip_grad_norm_`` adds 1e-6 to the norm, which optax does not).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``."""

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def linear(init_value: float, end_value: float, steps: int) -> Schedule:
    """``optax.linear_schedule``."""

    def schedule(count: int) -> float:
        frac = min(count, steps) / steps
        return init_value + (end_value - init_value) * frac

    return schedule


def build_lr_schedule(
    scheduler_type: str,
    learning_rate: float,
    total_steps: int,
    steps_per_epoch: int,
    warmup_epochs: int = 0,
    scheduler_step_size: int = 30,
    scheduler_gamma: float = 0.1,
) -> Schedule:
    """The per-update learning rate as a function of the update count."""
    warmup_steps = warmup_epochs * steps_per_epoch
    if scheduler_type == "cosine":
        cosine = cosine_decay(learning_rate, max(total_steps - warmup_steps, 1), alpha=0.01)
        if warmup_steps <= 0:
            return cosine
        warmup = linear(0.0, learning_rate, warmup_steps)
        return lambda count: warmup(count) if count < warmup_steps else cosine(count - warmup_steps)
    if scheduler_type == "step":
        spe = max(steps_per_epoch, 1)
        return lambda count: learning_rate * scheduler_gamma ** ((count // spe) // scheduler_step_size)
    if scheduler_type in ("plateau", "none"):
        return lambda count: learning_rate
    raise ValueError(f"Unknown scheduler type: {scheduler_type}")


def build_optimizer(
    params: Iterable[torch.nn.Parameter], learning_rate: float, weight_decay: float = 1e-5
) -> torch.optim.AdamW:
    """AdamW with optax's defaults (betas 0.9/0.999, eps 1e-8)."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global norm
    exceeds ``max_norm`` (optax's ``clip_by_global_norm``); return the norm."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
