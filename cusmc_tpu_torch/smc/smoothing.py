"""Particle smoothing from stored filter history.

Port of ``cusmc_tpu/smc/smoothing.py:24-76``:

- ``ancestral_paths``: genealogy tracing, each final particle's ancestor
  chain followed backward through the stored [T, N] ancestor table; N
  full-path samples from the joint smoothing distribution (path-degenerate
  for t << T);
- ``smoothed_means``: the final-weighted mean of those paths;
- ``unique_path_counts``: the number of distinct surviving lineages at
  each time (the degeneracy diagnostic; ``.at[].add`` becomes
  ``torch.bincount``).

They take the port's ``FilterResult`` of a run with ``return_history=True``,
whose history is [T, N, d] in both layouts. The backward ``lax.scan``
becomes a loop of device gathers; nothing is read back to the host.
"""

from __future__ import annotations

import torch

from cusmc_tpu_torch.smc.particle_filter import FilterResult


def ancestral_paths(result: FilterResult) -> torch.Tensor:
    """Full ancestral paths [T, N, d]: column i is the path of final
    particle i."""
    if result.particles is None or result.ancestors is None:
        raise ValueError("ancestral_paths needs return_history=True")
    particles, ancestors = result.particles, result.ancestors
    num_steps, n = particles.shape[:2]
    idx = torch.arange(n, device=particles.device)
    paths = torch.empty(particles.shape, dtype=particles.dtype,
                        device=particles.device)
    for t in range(num_steps - 1, 0, -1):
        paths[t] = particles[t][idx]
        idx = ancestors[t][idx].long()
    paths[0] = particles[0][idx]
    return paths


def smoothed_means(result: FilterResult) -> torch.Tensor:
    """Joint-smoothing posterior means E[x_t | y_{1:T}] [T, d] from the
    traced genealogy, final particles weighted by their final weights."""
    paths = ancestral_paths(result)
    w = torch.softmax(result.final_log_weights, dim=0)
    return torch.einsum("n,tnd->td", w, paths.to(w.dtype))


def unique_path_counts(result: FilterResult) -> torch.Tensor:
    """Distinct surviving lineages at each time, int32 [T] (the last entry
    is N)."""
    if result.ancestors is None:
        raise ValueError("needs return_history=True")
    ancestors = result.ancestors
    num_steps, n = ancestors.shape
    idx = torch.arange(n, device=ancestors.device)
    counts = torch.empty(num_steps, dtype=torch.int32,
                         device=ancestors.device)
    counts[-1] = n
    for t in range(num_steps - 1, 0, -1):
        idx = ancestors[t][idx].long()
        counts[t - 1] = torch.count_nonzero(torch.bincount(idx, minlength=n))
    return counts
