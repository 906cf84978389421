"""Process-group set-up for the sharded filter.

Counterpart of ``cusmc_tpu/parallel/multihost.py``:
``initialize_distributed`` (``:23-41``) and ``process_info`` (``:55-62``).
Nothing on the machine tells a program of a cluster, so the caller names
the rendezvous (``tcp://host:port`` or ``file:///path``), the world size
and this process's rank. There is no ``global_mesh``: a process group
already spans every rank, and ``mesh.ParticleAxis()`` is its particle axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Initialise the default process group (idempotent).

    ``backend`` defaults to NCCL when a CUDA card is present, else gloo. A
    no-op for a world of one process without an ``init_method``. With
    NCCL each process first takes the card of its rank."""
    if dist.is_initialized():
        return
    if init_method is None and (world_size is None or world_size <= 1):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    world_size = 1 if world_size is None else int(world_size)
    rank = 0 if rank is None else int(rank)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def process_info() -> dict:
    """Process topology summary for logging."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "local_devices": torch.cuda.device_count(),
    }
