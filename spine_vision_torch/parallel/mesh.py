"""Data parallelism: the process group, the local device list, host helpers.

Counterpart of ``spine_vision_tpu/parallel/mesh.py``. The JAX package runs
one process over a mesh of local devices: the batch is sharded over the
mesh's "data" axis by GSPMD annotations and XLA inserts the gradient psum.
PyTorch has no such compiler, so the port maps the mesh onto the two idioms
PyTorch has:

- **Training: one process per device** under ``torch.distributed``. The data
  axis is the process group and its size is the world size. Each rank drives
  ``cuda:{LOCAL_RANK}`` unless its caller names a device, loads its
  contiguous slice of every global batch (``data/loader.py``), and
  ``DistributedDataParallel`` all-reduces the gradients. :class:`MeshContext`
  holds the world size, the rank and the device; :func:`make_mesh` builds it
  and :func:`initialize_distributed` joins the group (``torchrun``'s
  ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``, or explicit
  arguments). What XLA does implicitly on the global batch, the port does by
  hand: BatchNorm reduces its statistics over the group
  (``ops/batchnorm.py``), random draws are shaped by the global batch
  (``ops/draws.py``), and the masked losses divide by the global count
  (``ops/losses.py``, ``train/*``).
- **Inference and the dataset builders: one process over a device list.**
  :func:`data_parallel_mesh` lists the local devices; the pipelines keep one
  model replica per device, pad the batch to a multiple of the list's length
  and run one shard on each (``infer/pipeline.py``).

``batch_sharded_jit``, ``batch_sharding`` and ``replicated_sharding`` are XLA
constructs with no counterpart here: the pipelines' replica runner and
:class:`MeshContext` (``shard_batch``, ``replicate``) do their work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The process group's size (1 without a group)."""
    return dist.get_world_size() if _group_ready() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if _group_ready() else 0


def is_main_process() -> bool:
    """True on rank 0, or when there is no process group."""
    return rank() == 0


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the process group: once per process, before any collective.

    With no arguments it reads ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); explicit arguments cover a
    launch without it (``coordinator_address`` as ``host:port``). The backend
    is ``nccl`` when CUDA is available and ``gloo`` otherwise, unless the
    caller names one (a CPU run on a machine with a card names ``gloo``).

    Returns True if it joined a group, False if a group already exists or
    nothing is configured (a single-process run). Idempotent: every entry
    point may call it.
    """
    if _group_ready():
        return False
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    configured = (coordinator_address, num_processes, process_id)
    if all(v is None for v in configured):
        return False
    if any(v is None for v in configured):
        raise ValueError(
            "initialize_distributed needs the coordinator's address, the number of "
            "processes and this process's rank (or torchrun's MASTER_ADDR, MASTER_PORT, "
            f"WORLD_SIZE and RANK); got address={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r}"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    address = coordinator_address
    dist.init_process_group(
        backend=backend,
        init_method=address if "://" in address else f"tcp://{address}",
        world_size=num_processes,
        rank=process_id,
    )
    return True


def _cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(frozen=True)
class MeshContext:
    """The data axis of a training run: the world size, this process's rank
    and the device it drives."""

    world_size: int
    rank: int
    device: torch.device

    @property
    def num_devices(self) -> int:
        return self.world_size

    @property
    def data_axis_size(self) -> int:
        return self.world_size

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard_batch(self, batch: Any) -> Any:
        """This rank's host slice of the global batch (what the loader's
        process slicing yields) on this rank's device."""
        from spine_vision_torch.train.steps import to_device

        return to_device(batch, self.device)

    def replicate(self, tree: Any) -> Any:
        """Arrays and tensors of a nested dict or list on this rank's device,
        with rank 0's values broadcast to every rank."""
        if isinstance(tree, dict):
            return {k: self.replicate(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.replicate(v) for v in tree)
        t = torch.as_tensor(np.asarray(tree) if not torch.is_tensor(tree) else tree)
        t = t.to(self.device).clone()
        if self.world_size > 1:
            dist.broadcast(t, src=0)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (``t`` itself at world size 1, with no
        collective)."""
        if self.world_size == 1:
            return t
        t = t.detach().clone()
        dist.all_reduce(t)
        return t

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier()


def make_mesh(
    num_devices: int | None = None,
    model_parallel: int = 1,
    devices: Sequence[Any] | None = None,
    device: str | torch.device | None = None,
) -> MeshContext:
    """The data-parallel context of this process.

    Args:
        num_devices: The data axis size: None or the world size. More than
            the visible devices raises, as does more than 1 without a group.
        model_parallel: 1; the port has no model axis, so anything else
            raises as a mesh that cannot be built.
        devices: The visible devices (default: every CUDA device; a CPU
            ``device`` hosts any number of ranks).
        device: This rank's device (default: ``devices[LOCAL_RANK]``; a rank
            beyond the visible devices raises, it never wraps around).
    """
    if model_parallel != 1:
        raise ValueError(
            f"model_parallel={model_parallel}: the port's mesh has a data axis only "
            "(one process per device), so only model_parallel=1 can be built"
        )
    if device is not None:
        device = torch.device(device)
    on_cpu = device is not None and device.type == "cpu"
    visible = [torch.device(d) for d in devices] if devices is not None else (
        [] if on_cpu else _cuda_devices())
    if num_devices is not None and (devices is not None or not on_cpu) \
            and num_devices > len(visible):
        raise ValueError(
            f"requested num_devices={num_devices} but only {len(visible)} device(s) are "
            "visible; use fewer"
        )
    group = _group_ready()
    world, this_rank = world_size(), rank()
    if num_devices is not None and num_devices > 1 and not group:
        raise ValueError(
            f"num_devices={num_devices} trains one process per device: launch "
            f"{num_devices} processes (for example with torchrun --nproc-per-node "
            f"{num_devices}) with distributed=True"
        )
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices} but the process group has {world} ranks")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", this_rank))
        if local >= len(visible):
            raise ValueError(
                f"LOCAL_RANK={local} but only {len(visible)} device(s) are visible; "
                "pass the device explicitly"
            )
        device = visible[local]
    return MeshContext(world_size=world, rank=this_rank, device=device)


def pad_to_multiple(batch: Any, multiple: int) -> tuple[Any, int]:
    """Pad every array's leading axis up to a multiple by repeating its last
    row (numpy copies). Returns ``(padded, n_valid)``; callers drop the rows
    past ``n_valid`` from the outputs."""
    leaves = _leaves(batch)
    if not leaves:
        return batch, 0
    n = int(np.asarray(leaves[0]).shape[0])
    pad = (-n) % multiple
    if pad == 0:
        return batch, n

    def _pad(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: _pad(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(_pad(v) for v in x)
        arr = np.asarray(x)
        return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)

    return _pad(batch), n


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def data_parallel_mesh(devices: Sequence[Any] | None = None) -> tuple[torch.device, ...]:
    """The devices of a one-process data-parallel run (the pipelines and the
    dataset builders): every local CUDA device, or ``devices`` (the tests
    pass CPU entries). Raises without a card when ``devices`` is None."""
    if devices is None:
        devices = _cuda_devices()
        if not devices:
            raise RuntimeError(
                "data_parallel_mesh() lists the CUDA devices and none is available; pass "
                "devices=[...] explicitly (for example two 'cpu' entries)"
            )
    out = tuple(torch.device(d) for d in devices)
    if not out:
        raise ValueError("data_parallel_mesh needs at least one device")
    return out


def all_gather_host(x: Any) -> np.ndarray:
    """A rank's array gathered from every rank, concatenated on axis 0, as
    host numpy (each rank's shard must have one shape); without a group,
    the array itself fetched."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if world_size() == 1:
        return t.detach().cpu().numpy()
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts).detach().cpu().numpy()
