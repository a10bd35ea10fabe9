"""Data parallelism: the process group, the device list and host helpers."""

from spine_vision_torch.parallel.mesh import (
    MeshContext,
    all_gather_host,
    data_parallel_mesh,
    initialize_distributed,
    is_main_process,
    make_mesh,
    pad_to_multiple,
)

__all__ = [
    "MeshContext",
    "all_gather_host",
    "data_parallel_mesh",
    "initialize_distributed",
    "is_main_process",
    "make_mesh",
    "pad_to_multiple",
]
