"""Metropolis resampler with independent per-chain proposals (Murray et
al., arXiv:1202.6163).

Port of ``cusmc_tpu/resampling/metropolis.py:26-43``: each particle i runs
a B-step Metropolis chain over ancestor indices, proposing a uniform
random index j per chain and sweep and accepting it over the current k
when ``log u < logw[j] - logw[k]``. It reaches no kernel itself: it is the
registry's "metropolis" (``resampling.get_resampler``) and the reference
law the fused step's offspring check compares against
(``benchmarks/validate_fused_tpu.py:58-78``). Under another registry key in
the packed layout, its ancestors (in any order) feed ``take_columns``.

As elsewhere in the port the draws and the transform are split, so a test
can replay JAX's per-sweep ``(j, u)`` (``kj, ku = split(fold_in(key, b))``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def metropolis_draws(gen: Optional[torch.Generator], n: int, num_steps: int,
                     device=None, dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(j [B, n] int64 proposals in [0, n), u [B, n] uniforms)."""
    j = torch.randint(0, n, (num_steps, n), generator=gen, device=device)
    u = torch.rand((num_steps, n), generator=gen, dtype=dtype, device=device)
    return j, u


def metropolis_from_draws(log_weights: torch.Tensor, j: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """Ancestors [n] int32 from the draws of ``metropolis_draws``."""
    n = log_weights.shape[0]
    k = torch.arange(n, dtype=torch.int64, device=log_weights.device)
    for b in range(j.shape[0]):
        jb = j[b].to(torch.int64)
        accept = torch.log(u[b]) < log_weights[jb] - log_weights[k]
        k = torch.where(accept, jb, k)
    return k.to(torch.int32)


def metropolis_ancestors(gen: Optional[torch.Generator],
                         log_weights: torch.Tensor, num_steps: int = 10,
                         j: Optional[torch.Tensor] = None,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestor indices [n] int32 via B-step Metropolis chains;
    ``log_weights`` may be unnormalised. ``j`` and ``u`` (both or
    neither): the draws of ``metropolis_draws``, in place of drawing."""
    if j is None:
        j, u = metropolis_draws(gen, log_weights.shape[0], num_steps,
                                log_weights.device, log_weights.dtype)
    return metropolis_from_draws(log_weights, j, u)
