"""Particle-sharded bootstrap filter over a ``torch.distributed`` group.

Port of ``cusmc_tpu/parallel/filter.py:34-116``. Each rank runs
``smc/particle_filter.bootstrap_filter`` on its block of L = N / P
particles with an injected exp-space resample op of
``parallel/resampling.py``: the ring exchange for the CDF family and
residual, the global-proposal roll exchange for metropolis. The step is the
single-device step; only the op and the axis differ. There is no
``shard_map`` around it: every rank calls this function with the same
arguments, as SPMD programs do.
"""

from __future__ import annotations

from typing import Optional

from cusmc_tpu_torch.parallel.mesh import axis_size
from cusmc_tpu_torch.parallel.resampling import (
    ring_cdf_resample_op,
    roll_metropolis_sharded_op,
)
from cusmc_tpu_torch.smc import particle_filter


def sharded_bootstrap_filter(key, model, ys, num_particles: int, axis=None,
                             resampler: str = "systematic",
                             resampler_kwargs: Optional[dict] = None,
                             ess_threshold: Optional[float] = None,
                             return_history: bool = False):
    """Run the filter with ``num_particles`` (N) particles sharded over
    ``axis`` (a ``parallel.mesh.ParticleAxis``; None: one shard).

    ``key`` is an int seed, the same on every rank. ``resampler``:
    "systematic", "stratified", "multinomial", "residual" or "metropolis"
    (``resampler_kwargs``: ``num_steps`` and ``exchange`` "global",
    "binary" or "windowed"; the ring's ``ring_window``). Runs on the
    model's device. Returns this rank's ``FilterResult``: the particles
    and weights of its block, ancestors in global indices, and the ESS and
    log-evidence, the same on every rank. Default ``return_history=False``:
    at the scales that need sharding the [T, L, d] history dominates
    device memory."""
    n_shards = axis_size(axis)
    if num_particles % n_shards:
        raise ValueError(f"num_particles={num_particles} is not divisible "
                         f"by the {n_shards} ranks of the particle axis")
    n_local = num_particles // n_shards
    kwargs = resampler_kwargs or {}
    if resampler == "metropolis":
        op = roll_metropolis_sharded_op(axis, num_particles, n_local,
                                        weights="exp", **kwargs)
    else:
        op = ring_cdf_resample_op(resampler, axis, num_particles, n_local,
                                  weights="exp", **kwargs)
    return particle_filter.bootstrap_filter(
        key, model, ys, n_local, ess_threshold=ess_threshold,
        return_history=return_history, axis_name=axis,
        num_particles_global=num_particles, resample_op=op,
        resample_op_weights="exp")
