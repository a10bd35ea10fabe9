"""Train and eval steps.

Counterpart of ``spine_vision_tpu/train/steps.py``: a step takes a host
batch, uploads it (images as uint8), runs the caller's preprocessing on the
device (``/255``, augmentation, ImageNet normalisation), the model, the
loss, the backward pass, global-norm clipping and one AdamW update at the
scheduled learning rate. Dropout and augmentation draw from the state's
generator.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from spine_vision_torch.train.schedules import clip_by_global_norm
from spine_vision_torch.train.state import TrainState

Batch = dict[str, Any]
LossFn = Callable[[torch.Tensor, Batch], torch.Tensor]
Preprocess = Callable[[Batch, torch.Generator, bool], Batch]


def to_device(batch: Batch, device: torch.device) -> Batch:
    """Array fields of a host batch as tensors on ``device``; metadata stays."""
    out: Batch = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            t = torch.from_numpy(value)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[key] = t
        else:
            out[key] = value
    return out


def train_step(
    state: TrainState, batch: Batch, loss_fn: LossFn, preprocess: Preprocess | None = None
) -> torch.Tensor:
    """One update; returns the loss as a device tensor (no host sync)."""
    model = state.model
    device = next(model.parameters()).device
    batch = to_device(batch, device)
    if preprocess is not None:
        batch = preprocess(batch, state.generator, True)
    model.train()
    outputs = model(batch["image"], generator=state.generator)
    loss = loss_fn(outputs, batch)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = state.trainable()
    if state.grad_clip is not None:
        clip_by_global_norm([p.grad for p in params if p.grad is not None], state.grad_clip)
    lr = state.lr_for_next_update()
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.last_lr = lr
    state.step += 1
    return loss.detach()


@torch.no_grad()
def eval_step(
    state: TrainState, batch: Batch, loss_fn: LossFn, preprocess: Preprocess | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward in eval mode: ``(outputs, loss)`` as device tensors."""
    model = state.model
    device = next(model.parameters()).device
    batch = to_device(batch, device)
    if preprocess is not None:
        batch = preprocess(batch, state.generator, False)
    model.eval()
    outputs = model(batch["image"])
    return outputs, loss_fn(outputs, batch)
