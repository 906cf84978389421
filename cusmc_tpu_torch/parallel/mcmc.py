"""Chain-sharded MCMC over the ``"chains"`` line of a ``parallel.Mesh``.

Port of ``cusmc_tpu/parallel/mcmc.py:26-232``. Each rank runs its slice
of the global [C, d] chains (rank r holds chains [r C/P, (r+1) C/P)) with
the unsharded sampler, and the sampler pools its adaptation statistics
over the mesh's chain axis through its ``axis_name`` (``pmean``): every
rank adapts the same step size (ChEES: the same trajectory length and
mass diagonal, so every rank integrates the same number of leapfrog
steps; PT: the same per-rung scales and ladder), and the sharded run is
the pooled run over all C chains. There is no ``shard_map`` around it:
every rank calls the function with the same arguments, as every shard of
the JAX program runs it.

Rank r draws from ``parallel.mesh.rank_seed(key, r)``, the port's
counterpart of ``fold_in(key, axis_index)``; ``key`` is an int seed, the
same on every rank. On a one-rank axis each function returns the
unsharded sampler's result for rank 0's seed (no collectives), as the JAX
functions do. Each rank returns its own block of the chains (``state.x``
[C/P, d], ``samples`` [T, C/P, d]) and the pooled scalars; the JAX
functions return the global arrays, sharded.

The stretch move keeps an independent ensemble of W/P walkers on each
rank (its proposals pair walkers of one ensemble), and pools only the
acceptance rate.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

import torch

from cusmc_tpu_torch.mcmc.chees import chees_hmc_sampler
from cusmc_tpu_torch.mcmc.ensemble import stretch_move_sampler
from cusmc_tpu_torch.mcmc.metropolis import metropolis_hastings_sampler
from cusmc_tpu_torch.mcmc.tempering import parallel_tempering_sampler
from cusmc_tpu_torch.parallel.mesh import CHAIN_AXIS, pmean, rank_seed


def _shard(key, init_x: torch.Tensor, mesh, axis: str, what: str = "chains"):
    """(this rank's seed, its slice of ``init_x``, the axis or None on one
    shard)."""
    if isinstance(key, torch.Generator):
        raise TypeError("the sharded samplers take an int seed")
    c = init_x.shape[0]
    n_shards = mesh.shape[axis]
    if c % n_shards != 0:
        raise ValueError(f"{what}={c} not divisible by axis size {n_shards}")
    if n_shards == 1:
        return rank_seed(key, 0), init_x, None
    ax = mesh.axes[axis]
    block = c // n_shards
    return (rank_seed(key, ax.index),
            init_x[ax.index * block:(ax.index + 1) * block], ax)


def sharded_mh_sampler(key: int, log_prob: Callable, init_x: torch.Tensor,
                       num_steps: int, mesh, axis: str = CHAIN_AXIS,
                       keep_samples: bool = False, **mh_kwargs):
    """``metropolis_hastings_sampler`` over chains [C, d] sharded on
    ``mesh``'s ``axis``, the acceptance pooled over it."""
    seed, x, ax = _shard(key, init_x, mesh, axis)
    return metropolis_hastings_sampler(seed, log_prob, x, num_steps,
                                       keep_samples=keep_samples,
                                       axis_name=ax, **mh_kwargs)


def sharded_pt_sampler(key: int, log_prob: Callable, init_x: torch.Tensor,
                       num_steps: int, mesh, axis: str = CHAIN_AXIS,
                       keep_samples: bool = False, **pt_kwargs):
    """Chain-sharded parallel tempering: swaps are chain-local, so only
    the pooled per-rung acceptance and swap statistics cross ranks.
    ``init_x`` is the global [C, d] (broadcast to every rung), refused
    otherwise whatever the mesh size."""
    if init_x.ndim != 2:
        raise ValueError("sharded PT takes [C, d] init (rungs broadcast)")
    seed, x, ax = _shard(key, init_x, mesh, axis)
    return parallel_tempering_sampler(seed, log_prob, x, num_steps,
                                      keep_samples=keep_samples,
                                      axis_name=ax, **pt_kwargs)


def sharded_chees_sampler(key: int, log_prob: Callable, init_x: torch.Tensor,
                          num_steps: int, mesh, axis: str = CHAIN_AXIS,
                          keep_samples: bool = False, **chees_kwargs):
    """Chain-sharded ChEES-HMC: each cross-chain mean of the adaptation
    is one small all-reduce a sweep, and the trajectory is shared."""
    seed, x, ax = _shard(key, init_x, mesh, axis)
    return chees_hmc_sampler(seed, log_prob, x, num_steps,
                             keep_samples=keep_samples, axis_name=ax,
                             **chees_kwargs)


def sharded_stretch_sampler(key: int, log_prob: Callable,
                            init_x: torch.Tensor, num_steps: int, mesh,
                            axis: str = CHAIN_AXIS,
                            keep_samples: bool = False, **st_kwargs):
    """Independent ensembles of W/P walkers, one a rank (each must still
    be even and at least 2d + 2); the acceptance rate is pooled."""
    w, d = init_x.shape
    n_shards = mesh.shape[axis]
    if w % n_shards == 0 and n_shards > 1 and (
            (w // n_shards) % 2 or w // n_shards < 2 * d + 2):
        raise ValueError(
            f"each shard's ensemble needs an EVEN walker count >= 2d+2:"
            f" global W={w} over {n_shards} shards gives "
            f"{w // n_shards} walkers/shard for d={d}")
    seed, x, ax = _shard(key, init_x, mesh, axis, "walkers")
    res = stretch_move_sampler(seed, log_prob, x, num_steps,
                               keep_samples=keep_samples, **st_kwargs)
    if ax is None:
        return res
    return replace(res, accept_rate=pmean(res.accept_rate, ax))
