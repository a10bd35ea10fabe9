"""CTC loss in optax's form (``optax.ctc_loss``), plain PyTorch.

The alpha recursion runs in log space over the T frames, as optax writes
it: blank and label states per label position, ``log_epsilon`` (-1e5) for
log(0), a repeated label allowed to emit only through a blank, padded
frames leaving the state unchanged, and the loss read at each row's label
length after a last epsilon transition. Autograd gives the gradient.

``torch.nn.functional.ctc_loss`` is not this function: it returns ``inf``
where optax returns a finite loss of about 1e5 for an alignment that cannot
fit (more labels than frames), and its CUDA backward is not deterministic.
optax's CTC is an XLA program, not a TPU kernel, so its port is plain torch.
"""

from __future__ import annotations

import torch


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp`` with JAX's derivative, ``exp(x - out)`` for each
    operand: near log_epsilon (-1e5) an f32 ulp is 8e-3, and another form of
    the derivative moves an infeasible row's gradient by percents."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(
    logits: torch.Tensor,
    logit_paddings: torch.Tensor,
    labels: torch.Tensor,
    label_paddings: torch.Tensor,
    blank_id: int = 0,
    log_epsilon: float = -1e5,
) -> torch.Tensor:
    """Per-sequence CTC loss ``[B]``.

    Args:
        logits: ``[B, T, K]`` logits, K classes including the blank.
        logit_paddings: ``[B, T]``, 1.0 on padded frames.
        labels: ``[B, N]`` integer labels, right-padded.
        label_paddings: ``[B, N]``, 1.0 on padded labels.
        blank_id: The blank's class.
        log_epsilon: log(0)'s stand-in.
    """
    b, _, k = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    labellens = n - label_paddings.sum(1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).float()
    repeat = torch.nn.functional.pad(repeat, (0, 1))

    logprobs_phi = logprobs[:, :, blank_id].transpose(0, 1).unsqueeze(-1)  # [T, B, 1]
    emit = torch.gather(logprobs, 2, labels.unsqueeze(1).expand(b, logprobs.shape[1], n))
    emit = emit.transpose(0, 1)  # [T, B, N]
    pads = logit_paddings.float().transpose(0, 1)  # [T, B]

    phi = torch.full((b, n + 1), log_epsilon, device=logits.device, dtype=torch.float32)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit_state = torch.full((b, n), log_epsilon, device=logits.device, dtype=torch.float32)

    def update_phi(p: torch.Tensor, added: torch.Tensor) -> torch.Tensor:
        return torch.cat([p[:, :1], _LogAddExp.apply(p[:, 1:], added)], dim=1)

    eps_repeat, eps_other = log_epsilon * repeat, log_epsilon * (1.0 - repeat)
    # With no padded frame the blend below leaves every value as it is; the
    # loop then launches fewer kernels (it is launch-bound on the card).
    padded = bool(logit_paddings.any())
    for t in range(emit.shape[0]):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit_state + eps_repeat)
        lp_emit, lp_phi = emit[t], logprobs_phi[t]
        next_emit = _LogAddExp.apply(prev_phi[:, :-1] + lp_emit, emit_state + lp_emit)
        next_phi = prev_phi + lp_phi
        next_phi = update_phi(next_phi, emit_state + lp_phi + eps_other)
        if padded:
            pad = pads[t].reshape(b, 1)
            emit_state = pad * emit_state + (1.0 - pad) * next_emit
            phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
        else:
            emit_state, phi = next_emit, next_phi

    last = update_phi(phi, emit_state)
    return -torch.gather(last, 1, labellens.unsqueeze(1)).squeeze(1)
