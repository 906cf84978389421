"""Replicated sharded filters over a 2-D grid of ranks (chains x particles).

Port of ``cusmc_tpu/parallel/replicated.py:34-101``. Independent filter
replicates (for the variance of the log-evidence, PMMH pre-runs, or seeds
in parallel) are split over the ``"chains"`` axis of a ``parallel.mesh.
Mesh``, and each replicate's particles over its ``"particles"`` axis with
the sharded filter's collectives; the chains axis carries no traffic.

Each rank runs its block of replicates one after the other in a Python
loop (the kernels are ctypes calls, which ``vmap`` cannot map). Replicate
r (a global index) runs ``bootstrap_filter`` seeded with
``utils.rng.replicate_seed(seed, r)``, as the JAX function folds
``rep0 + r`` into its key. The resample op follows the JAX function:
metropolis on a model with packed methods takes the roll exchange, every
other case the batch layout and the all-gather op.
"""

from __future__ import annotations

from typing import Optional

import torch

from cusmc_tpu_torch.models.base import supports_packed
from cusmc_tpu_torch.parallel.mesh import CHAIN_AXIS, PARTICLE_AXIS
from cusmc_tpu_torch.parallel.resampling import (
    allgather_resample_op,
    roll_metropolis_sharded_op,
)
from cusmc_tpu_torch.smc import particle_filter
from cusmc_tpu_torch.utils.rng import replicate_seed


def replicated_sharded_filters(
    key: int,
    model,
    ys,
    num_particles: int,
    num_replicates: int,
    mesh,
    chain_axis: str = CHAIN_AXIS,
    particle_axis: str = PARTICLE_AXIS,
    resampler: str = "metropolis",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = None,
    device=None,
) -> "particle_filter.FilterResult":
    """Run ``num_replicates`` independent filters of ``num_particles``
    particles: replicates split over ``mesh``'s ``chain_axis``, each one's
    particles over its ``particle_axis``. ``key`` is an int seed, the same
    on every rank. Returns this rank's block with a leading replicate
    axis: ``log_evidence`` [R / C], ``ess`` [R / C, T], ``final_particles``
    [R / C, N / P, d] and ``final_log_weights`` [R / C, N / P] (the JAX
    function returns the global arrays, sharded)."""
    n_c = mesh.shape[chain_axis]
    n_p = mesh.shape[particle_axis]
    if num_replicates % n_c != 0:
        raise ValueError(f"replicates={num_replicates} not divisible by "
                         f"{chain_axis} size {n_c}")
    if num_particles % n_p != 0:
        raise ValueError(f"particles={num_particles} not divisible by "
                         f"{particle_axis} size {n_p}")
    r_local = num_replicates // n_c
    n_local = num_particles // n_p
    axis = mesh.axes[particle_axis]
    kwargs = resampler_kwargs or {}
    if resampler == "metropolis" and supports_packed(model):
        layout, weights = "packed", "exp"
        op = roll_metropolis_sharded_op(axis, num_particles, n_local,
                                        weights="exp", **kwargs)
    else:
        layout, weights = "batch", "log"
        op = allgather_resample_op(resampler, axis, num_particles, n_local,
                                   **kwargs)
    rep0 = mesh.axes[chain_axis].index * r_local
    runs = [particle_filter.bootstrap_filter(
        replicate_seed(int(key), rep0 + r), model, ys, n_local,
        ess_threshold=ess_threshold, return_history=False, layout=layout,
        axis_name=axis, num_particles_global=num_particles,
        resample_op=op, resample_op_weights=weights, device=device)
        for r in range(r_local)]
    return particle_filter.FilterResult(
        final_particles=torch.stack([r.final_particles for r in runs]),
        final_log_weights=torch.stack([r.final_log_weights for r in runs]),
        ess=torch.stack([r.ess for r in runs]),
        log_evidence=torch.stack([r.log_evidence for r in runs]))
