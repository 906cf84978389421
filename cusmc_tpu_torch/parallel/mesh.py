"""The particle axis of a sharded run, over a ``torch.distributed`` group.

Counterpart of ``cusmc_tpu/parallel/mesh.py`` (the mesh and its
``"particles"`` axis name) and of the axis collectives that the JAX package
calls under ``shard_map``: ``lax.axis_index``, ``all_gather``, ``psum``,
``pmax`` and ``ppermute``. Each rank of the process group holds one block
of ``L = N / P`` particles; rank p holds the global columns [p L, (p+1) L).
Every rank must issue the same collectives in the same order, as every
shard of a ``shard_map`` program does.

A ``Mesh`` lays the ranks out on a grid of named axes (``"chains"`` x
``"particles"`` for the replicated filters) with one group per line of the
grid; a ``ParticleAxis`` then spans this rank's line, and its collectives
stay inside it.

``None`` in place of an axis means one shard: index 0, size 1, and every
reduction the identity (``axis_index``, ``axis_size``, ``psum``, ...).

Randomness (the JAX package folds the shard index into a common key,
``particle_filter.py:220-223``, ``parallel/resampling.py:88-102,139,606``):
each rank draws from two ``torch.Generator``s on its device, ``Streams``:

- ``common``, seeded with the run's seed, the same on every rank: shared
  offsets (systematic), the Metropolis peers and shifts, and the residual
  remainder vector;
- ``rank``, seeded with ``rank_seed(seed, p)``: the initial particles, the
  propagation noise and the per-shard uniforms (stratified, multinomial,
  the Metropolis accept uniforms and the one-shard roll sweeps).

A single-device filter given ``Streams`` of one generator draws exactly as
before, so the one-shard sharded filter equals the single-device filter
seeded with ``rank_seed(seed, 0)``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

PARTICLE_AXIS = "particles"
CHAIN_AXIS = "chains"

_SEED_MASK = (1 << 63) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def rank_seed(seed: int, rank: int) -> int:
    """The rank stream's seed: the run's seed mixed with the rank (a
    splitmix64 step), distinct for every rank and from the common seed."""
    z = (int(seed) + (int(rank) + 1) * _GOLDEN) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _SEED_MASK


class Streams(NamedTuple):
    """The two generators of one rank (see the module docstring)."""

    common: Optional[torch.Generator]
    rank: Optional[torch.Generator]


def make_streams(seed: Optional[int], axis, device) -> Streams:
    """The common and the rank stream of this rank for an int seed."""
    seed = 0 if seed is None else int(seed)
    common = torch.Generator(device=device)
    common.manual_seed(seed)
    rank = torch.Generator(device=device)
    rank.manual_seed(rank_seed(seed, axis_index(axis)))
    return Streams(common, rank)


class ParticleAxis:
    """An axis over a process group: the default group, or ``group`` (a
    ``dist.new_group``, one line of a ``Mesh``).

    ``index`` is this process's rank within the group, ``size`` the
    group's number of ranks. The collectives take and return tensors on
    this rank's device; NCCL on the card, gloo on the CPU."""

    def __init__(self, name: str = PARTICLE_AXIS, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised; call "
                               "parallel.multihost.initialize_distributed")
        self.name = name
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def __repr__(self) -> str:
        return f"ParticleAxis({self.name!r}, index={self.index}, " \
               f"size={self.size})"

    def all_gather(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        """Every rank's ``x``, concatenated along axis 0 (``tiled``) or
        stacked on a new axis 0, in rank order."""
        parts: List[torch.Tensor] = [torch.empty_like(x)
                                     for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, 0) if tiled else torch.stack(parts, 0)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        out = x.detach().reshape(-1).clone()  # 0-dim tensors as [1]
        dist.all_reduce(out, op=op, group=self.group)
        return out.reshape(x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the ranks."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def barrier(self) -> None:
        """Wait until every rank has reached this call."""
        dist.barrier(group=self.group)

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: ``perm`` lists (source, destination) rank
        pairs; this rank sends ``x`` to its destination and returns what
        its source sent (zeros if it has no source). Every rank must make
        the same call."""
        me = self.index
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if dst == [me] and src == [me]:
            return x
        x = x.contiguous()
        out = torch.zeros_like(x)
        peer = self._global_rank
        ops = [dist.P2POp(dist.isend, x, peer(d), self.group) for d in dst]
        ops += [dist.P2POp(dist.irecv, out, peer(s), self.group)
                for s in src]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


    def _global_rank(self, r: int) -> int:
        """The default group's rank of this group's rank ``r``."""
        return r if self.group is None else dist.get_global_rank(
            self.group, r)


class Mesh:
    """A grid of the default group's ranks (``cusmc_tpu/parallel/mesh.py``
    ``make_mesh``): ``axis_sizes`` maps axis name -> size in order, e.g.
    ``{"chains": 2, "particles": 4}``; the product must be the world size.
    The ranks fill the grid in row-major order, as ``make_mesh`` reshapes
    its devices, so rank r sits at ``np.unravel_index(r, sizes)``.

    Each line of the grid along an axis is a ``dist.new_group``; ``axes``
    maps each name to a ``ParticleAxis`` over this rank's line, and
    ``shape`` each name to its size. torch.distributed needs every rank to
    create every group in the same order, which the constructor does:
    every rank calls it with the same sizes."""

    def __init__(self, axis_sizes: Optional[dict] = None):
        world = dist.get_world_size()
        if axis_sizes is None:
            axis_sizes = {PARTICLE_AXIS: world}
        names = tuple(axis_sizes)
        sizes = tuple(int(axis_sizes[n]) for n in names)
        if math.prod(sizes) != world:
            raise ValueError(f"axis sizes {axis_sizes} != world size "
                             f"{world}")
        self.shape = dict(zip(names, sizes))
        self.axes = {}
        me = dist.get_rank()
        grid = torch.arange(world).reshape(sizes)
        for i, name in enumerate(names):
            for line in torch.movedim(grid, i, -1).reshape(-1, sizes[i]):
                ranks = line.tolist()
                group = dist.new_group(ranks)
                if me in ranks:
                    self.axes[name] = ParticleAxis(name, group)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def axis_index(axis) -> int:
    return 0 if axis is None else axis.index


def axis_size(axis) -> int:
    return 1 if axis is None else axis.size


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    return x if axis is None else axis.psum(x)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.pmean``: the elementwise mean over the ranks."""
    return x if axis is None else axis.psum(x) / axis.size


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    return x if axis is None else axis.pmax(x)


def all_gather(x: torch.Tensor, axis, tiled: bool = True) -> torch.Tensor:
    if axis is None:
        return x if tiled else x[None]
    return axis.all_gather(x, tiled)


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    return x if axis is None else axis.ppermute(x, perm)


def global_slots(n_local: int, axis, device) -> torch.Tensor:
    """This rank's global particle indices p L + [0, L), int32."""
    return axis_index(axis) * n_local + torch.arange(
        n_local, dtype=torch.int32, device=device)
