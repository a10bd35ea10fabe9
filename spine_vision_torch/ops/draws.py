"""Random draws shaped by the global batch.

The JAX package draws its augmentation and dropout inside the jitted step,
on the global batch, so a data-parallel run draws what one process draws. In
the port each rank holds its slice of the batch, and every rank's generator
is seeded alike; drawing for the local rows would give rank 0 and rank 1 the
same augmentation and dropout masks for different images. So a draw whose
leading axis is the batch draws for the global batch (the local rows times
the world size) and keeps this rank's rows ``[rank * b, (rank + 1) * b)``:
every rank's generator advances alike, and two ranks draw exactly the rows
one process draws.

``DrawShard(rank, world)`` is passed explicitly (through the trainer's
preprocessing and ``forward(..., shard=...)``); ops never read global state.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class DrawShard(NamedTuple):
    """This process's place on the data axis."""

    rank: int = 0
    world: int = 1


def rand(
    shape: Sequence[int], generator: torch.Generator | None, device,
    shard: DrawShard | None = None,
) -> torch.Tensor:
    """``torch.rand(shape)`` whose leading axis is this rank's rows of the
    global batch's draw (the plain draw without a shard or at world size 1)."""
    if shard is None or shard.world == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    b = shape[0]
    full = torch.rand((b * shard.world, *shape[1:]), generator=generator, device=device)
    return full[shard.rank * b: (shard.rank + 1) * b]
