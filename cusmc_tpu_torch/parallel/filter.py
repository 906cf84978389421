"""Particle-sharded bootstrap filter over a ``torch.distributed`` group.

Port of ``cusmc_tpu/parallel/filter.py:34-116``. Each rank runs
``smc/particle_filter.bootstrap_filter`` on its block of L = N / P
particles with an injected resample op of ``parallel/resampling.py``: in
the packed layout an exp-space op, the ring exchange for the CDF family
and residual, the global-proposal roll exchange for metropolis; for a
model without packed methods (a ``models.base.CustomSSM``), the batch
layout and the all-gather op over log weights (``:80-85``; O(N d) state
memory a rank). The step is the single-device step; only the op and the
axis differ. There is no ``shard_map`` around it: every rank calls this
function with the same arguments, as SPMD programs do.
"""

from __future__ import annotations

from typing import Optional

from cusmc_tpu_torch.models.base import supports_packed
from cusmc_tpu_torch.parallel.mesh import axis_size
from cusmc_tpu_torch.parallel.resampling import (
    allgather_resample_op,
    ring_cdf_resample_op,
    roll_metropolis_sharded_op,
)
from cusmc_tpu_torch.smc import particle_filter


def sharded_filter_args(model, num_particles: int, axis=None,
                        resampler: str = "systematic",
                        resampler_kwargs: Optional[dict] = None) -> dict:
    """The arguments that make ``bootstrap_filter`` (or
    ``particle_filter.filter_setup``) run this rank's block of the sharded
    filter: the block size, the layout, the axis, the global N and the
    injected op with its weight form. A mixed-precision model (a bfloat16
    state) runs as it does on one device: the exchanges carry the state in
    its own type, the weights in float32."""
    n_shards = axis_size(axis)
    if num_particles % n_shards:
        raise ValueError(f"num_particles={num_particles} is not divisible "
                         f"by the {n_shards} ranks of the particle axis")
    n_local = num_particles // n_shards
    kwargs = resampler_kwargs or {}
    layout, weights = "packed", "exp"
    if resampler == "metropolis":
        op = roll_metropolis_sharded_op(axis, num_particles, n_local,
                                        weights="exp", **kwargs)
    elif supports_packed(model):
        op = ring_cdf_resample_op(resampler, axis, num_particles, n_local,
                                  weights="exp", **kwargs)
    else:
        layout, weights = "batch", "log"
        op = allgather_resample_op(resampler, axis, num_particles, n_local,
                                   **kwargs)
    return dict(num_particles=n_local, layout=layout, axis_name=axis,
                num_particles_global=num_particles, resample_op=op,
                resample_op_weights=weights)


def sharded_bootstrap_filter(key, model, ys, num_particles: int, axis=None,
                             resampler: str = "systematic",
                             resampler_kwargs: Optional[dict] = None,
                             ess_threshold: Optional[float] = None,
                             return_history: bool = False, device=None):
    """Run the filter with ``num_particles`` (N) particles sharded over
    ``axis`` (a ``parallel.mesh.ParticleAxis``; None: one shard).

    ``key`` is an int seed, the same on every rank. ``resampler``:
    "systematic", "stratified", "multinomial", "residual" or "metropolis"
    (``resampler_kwargs``: ``num_steps`` and ``exchange`` "global",
    "binary" or "windowed"; the ring's ``ring_window``). Metropolis takes
    the packed layout; the other resamplers take it when the model has
    packed methods, else the batch layout. Runs on the model's device, or
    for a model without one (a ``CustomSSM``) on ``device`` (None: the
    card), as ``bootstrap_filter`` does. Returns this
    rank's ``FilterResult``: the particles and weights of its block,
    ancestors in global indices, and the ESS and log-evidence, the same on
    every rank. Default ``return_history=False``: at the scales that need
    sharding the [T, L, d] history dominates device memory."""
    return particle_filter.bootstrap_filter(
        key, model, ys, ess_threshold=ess_threshold,
        return_history=return_history, device=device,
        **sharded_filter_args(model, num_particles, axis, resampler,
                              resampler_kwargs))
