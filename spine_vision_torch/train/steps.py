"""Train and eval steps.

Counterpart of ``spine_vision_tpu/train/steps.py``: a step takes a host
batch, uploads it (images as uint8), runs the caller's preprocessing on the
device (``/255``, augmentation, ImageNet normalisation), the model, the
loss, the backward pass, global-norm clipping and one AdamW update at the
scheduled learning rate. Dropout and augmentation draw from the state's
generator.

As in JAX, every trainable parameter takes part in every update: one
without a gradient gets a zero one, so Adam's moments decay and weight
decay applies (``torch.optim.AdamW`` skips a parameter whose gradient is
None). A frozen parameter set (the backbone, while frozen) has its
gradients zeroed before clipping and its update discarded after the
optimizer step, as the JAX step zeroes that subtree's gradients and
updates: its moments see zero gradients and decay, its weights do not move.
BatchNorm running statistics update in the forward pass, frozen or not.

In a data-parallel run the step calls the state's ``DistributedDataParallel``
replica, whose reducer averages the gradients over the ranks in the backward
pass; the zero-filling, the frozen set and the clipping then act on the
reduced gradients, the same on every rank. The model's dropout draws for the
global batch (``state.draw_shard``).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from spine_vision_torch.train.schedules import clip_by_global_norm
from spine_vision_torch.train.state import TrainState

Batch = dict[str, Any]
LossFn = Callable[[torch.Tensor, Batch], torch.Tensor]
Preprocess = Callable[[Batch, torch.Generator, bool], Batch]


def to_device(batch: Batch, device: torch.device) -> Batch:
    """Array fields of a host batch, nested dicts' too (a classification
    batch's ``targets``), as tensors on ``device``; metadata stays."""
    out: Batch = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            t = torch.from_numpy(value)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[key] = t
        elif isinstance(value, dict):
            out[key] = to_device(value, device)
        else:
            out[key] = value
    return out


def train_step(
    state: TrainState, batch: Batch, loss_fn: LossFn, preprocess: Preprocess | None = None,
    frozen: Sequence[torch.nn.Parameter] = (),
) -> torch.Tensor:
    """One update; returns the loss as a device tensor (no host sync).
    ``frozen`` parameters keep their values (see the module docstring)."""
    model = state.model
    device = next(model.parameters()).device
    batch = to_device(batch, device)
    if preprocess is not None:
        batch = preprocess(batch, state.generator, True)
    model.train()
    net = model if state.replica is None else state.replica
    shard = {} if state.draw_shard is None else {"shard": state.draw_shard}
    outputs = net(batch["image"], generator=state.generator, **shard)
    loss = loss_fn(outputs, batch)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = state.trainable()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for p in frozen:
        p.grad.zero_()
    if state.grad_clip is not None:
        clip_by_global_norm([p.grad for p in params], state.grad_clip)
    lr = state.lr_for_next_update()
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    kept = [p.detach().clone() for p in frozen]
    state.optimizer.step()
    with torch.no_grad():
        for p, value in zip(frozen, kept):
            p.copy_(value)
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
