"""Loss functions, computed in float32 whatever the input dtype.

Counterpart of ``spine_vision_tpu/ops/losses.py``: binary cross entropy with
logits, binary focal loss, softmax cross entropy with label smoothing, and the
mse / smooth-L1 / Huber coordinate losses, optionally masked.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_cross_entropy_with_logits(
    logits: torch.Tensor, targets: torch.Tensor, pos_weight: float | None = None
) -> torch.Tensor:
    """Elementwise stable BCE with logits; ``pos_weight`` multiplies the
    ``t * log(sigmoid(x))`` term."""
    logits = logits.float()
    targets = targets.float()
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    if pos_weight is None:
        return -(targets * log_p + (1.0 - targets) * log_not_p)
    return -(pos_weight * targets * log_p + (1.0 - targets) * log_not_p)


def focal_loss_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    gamma: float = 2.0,
    alpha: float | None = None,
    pos_weight: float | None = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Binary focal loss ``(1 - p_t)^gamma * BCE``; ``alpha`` weights
    positives as ``alpha * t + (1 - alpha) * (1 - t)``. ``reduction`` is
    'none' | 'mean' | 'sum'."""
    logits = logits.float()
    targets = targets.float()
    probs = torch.sigmoid(logits)
    p_t = probs * targets + (1.0 - probs) * (1.0 - targets)
    loss = (1.0 - p_t) ** gamma * binary_cross_entropy_with_logits(
        logits, targets, pos_weight=pos_weight
    )
    if alpha is not None:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Per-example softmax cross entropy with integer labels; the target is
    ``(1 - s) * onehot + s / num_classes``."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    log_probs = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    if label_smoothing > 0.0:
        onehot = (1.0 - label_smoothing) * onehot + label_smoothing / num_classes
    return -(onehot * log_probs).sum(dim=-1)


def mse_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise squared error."""
    diff = predictions.float() - targets.float()
    return diff * diff


def smooth_l1_loss(
    predictions: torch.Tensor, targets: torch.Tensor, beta: float = 1.0
) -> torch.Tensor:
    """Elementwise smooth-L1: ``0.5 d^2 / beta`` below ``beta``, else
    ``|d| - 0.5 beta``."""
    diff = (predictions.float() - targets.float()).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def huber_loss(
    predictions: torch.Tensor, targets: torch.Tensor, delta: float = 0.1
) -> torch.Tensor:
    """Elementwise Huber: ``0.5 d^2`` up to ``delta``, else
    ``delta * (|d| - 0.5 delta)``."""
    diff = (predictions.float() - targets.float()).abs()
    return torch.where(diff <= delta, 0.5 * diff * diff, delta * (diff - 0.5 * delta))


_COORD_LOSSES = {"mse": mse_loss, "smooth_l1": smooth_l1_loss, "huber": huber_loss}


def masked_coordinate_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor | None = None,
    loss_type: str = "smooth_l1",
) -> torch.Tensor:
    """Mean coordinate loss over the valid entries of ``[B, L, 2]`` tensors.

    ``mask`` ``[B, L]`` (1 = valid) weights the elementwise loss, which is
    normalised by the number of valid elements; a batch with none valid
    gives 0.
    """
    if loss_type not in _COORD_LOSSES:
        raise ValueError(f"Unknown loss type: {loss_type}")
    if loss_type == "huber":
        elementwise = huber_loss(predictions, targets, delta=0.1)
    else:
        elementwise = _COORD_LOSSES[loss_type](predictions, targets)
    if mask is None:
        return elementwise.mean()
    mask_f = mask.float()[..., None]
    num_valid = mask_f.sum() * elementwise.shape[-1]
    total = (elementwise * mask_f).sum()
    return torch.where(num_valid > 0, total / torch.clamp(num_valid, min=1.0), 0.0)
