"""Device selection shared by the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the card.
Asking for the CPU must be explicit (``device="cpu"``, as the tests do); a
missing card is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and
    there is no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spine_vision_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU."
        )
    return dev
