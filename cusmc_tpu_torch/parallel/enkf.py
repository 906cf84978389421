"""Ensemble-sharded EnKF over a ``torch.distributed`` group.

Port of ``cusmc_tpu/parallel/enkf.py:27-55``. The only global quantities a
step are the ensemble moments, O(d + d k + k k) numbers summed over the
axis, so members never move between ranks. Each rank runs
``smc/enkf.ensemble_kalman_filter`` on its block with the axis, as every
shard of the JAX ``shard_map`` runs it; there is no ``shard_map`` around
it: every rank calls this function with the same arguments.
"""

from __future__ import annotations

from typing import Optional

from cusmc_tpu_torch.parallel.mesh import axis_size
from cusmc_tpu_torch.smc import enkf


def sharded_ensemble_kalman_filter(
    key,
    model,
    ys,
    num_ensemble: int,
    axis=None,
    inflation: float = 1.0,
    F=None,
    V=None,
    device=None,
    draws: Optional[dict] = None,
) -> "enkf.EnKFResult":
    """Run the EnKF with ``num_ensemble`` members sharded over ``axis`` (a
    ``parallel.mesh.ParticleAxis``; None: one shard). ``key`` is an int
    seed, the same on every rank (each rank draws from its rank stream).
    ``means`` and ``spread`` are the same on every rank;
    ``final_ensemble`` is this rank's block of members. ``draws`` replays
    this rank's numbers (``smc/enkf.py``'s layout)."""
    n_shards = axis_size(axis)
    if num_ensemble % n_shards != 0:
        raise ValueError(f"num_ensemble={num_ensemble} not divisible by "
                         f"the {n_shards} ranks of the axis")
    return enkf.ensemble_kalman_filter(
        key, model, ys, num_ensemble // n_shards, inflation=inflation, F=F,
        V=V, axis_name=axis, num_ensemble_global=num_ensemble,
        device=device, draws=draws)
