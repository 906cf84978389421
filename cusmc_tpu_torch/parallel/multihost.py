"""Process-group set-up for the sharded filter.

Counterpart of ``cusmc_tpu/parallel/multihost.py``:
``initialize_distributed`` (``:23-41``) and ``process_info`` (``:55-62``).
Nothing on the machine tells a program of a cluster, so the caller names
the rendezvous (``tcp://host:port`` or ``file:///path``), the world size
and this process's rank, or a launcher (``torchrun``) names them in the
environment, which ``joined_group`` reads. There is no ``global_mesh``: a
process group already spans every rank, and ``mesh.ParticleAxis()`` is
its particle axis.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional

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


@contextlib.contextmanager
def joined_group(device: torch.device,
                 size: Optional[int] = None) -> Iterator[bool]:
    """The default process group for a run on ``device``, while open: the
    group already initialised; else a launcher's (``torchrun`` sets
    ``WORLD_SIZE`` and ``RANK``: ``env://``); else, for ``size`` None or
    1, a one-rank group on a file store in a temporary directory. NCCL on
    a CUDA device, gloo on the CPU. Yields whether this call started the
    group; a group it started is destroyed on exit. Raises ``ValueError``
    when the group's world size is not ``size``, or when ``size`` > 1 and
    there is neither a group nor a launcher."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    started = not dist.is_initialized()
    store = None
    if started:
        if "WORLD_SIZE" in os.environ:
            initialize_distributed("env://", int(os.environ["WORLD_SIZE"]),
                                   int(os.environ.get("RANK", 0)), backend)
        elif size is None or size == 1:
            store = tempfile.TemporaryDirectory()
            initialize_distributed(f"file://{store.name}/store", 1, 0,
                                   backend)
        else:
            raise ValueError(
                f"needs a group of {size} ranks: start it with a launcher "
                f"(torchrun --nproc-per-node {size}); without one only a "
                "group of 1 runs")
    try:
        if size is not None and dist.get_world_size() != size:
            raise ValueError(f"needs a group of {size} ranks, in a group of "
                             f"{dist.get_world_size()}")
        yield started
    finally:
        if started:
            dist.destroy_process_group()
        if store is not None:
            store.cleanup()


def process_info() -> dict:
    """Process topology summary for logging."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "local_devices": torch.cuda.device_count(),
    }
