"""Weight and ancestry diagnostics.

Port of ``cusmc_tpu/diagnostics/metrics.py``: ``log_normalize``,
``effective_sample_size`` (``:19-41``), ``unique_ancestor_fraction`` and
``filter_diagnostics`` (``:42-64``). ``axis`` is the particle axis of a
sharded run (``parallel.mesh.ParticleAxis``): the log-sum-exp then takes a
max and a sum all-reduce over it. ``axis=None`` is one shard.
"""

from __future__ import annotations

import torch


def _plogsumexp(logw: torch.Tensor, axis) -> torch.Tensor:
    """logsumexp over the local axis, then over the particle axis."""
    if axis is None:
        return torch.logsumexp(logw, dim=-1)
    m = axis.pmax(torch.max(logw))
    return m + torch.log(axis.psum(torch.sum(torch.exp(logw - m))))


def log_normalize(logw: torch.Tensor, axis=None):
    """Return (normalized log-weights, log-normalizer)."""
    lse = _plogsumexp(logw, axis)
    return logw - lse, lse


def effective_sample_size(logw: torch.Tensor, axis=None) -> torch.Tensor:
    """Kish ESS = (sum w)^2 / sum w^2, stable in log space."""
    lse1 = _plogsumexp(logw, axis)
    lse2 = _plogsumexp(2.0 * logw, axis)
    return torch.exp(2.0 * lse1 - lse2)


def unique_ancestor_fraction(ancestors: torch.Tensor) -> torch.Tensor:
    """Fraction of distinct ancestor indices among the last axis's n
    (a degeneracy monitor), float32, over any leading axes in one batched
    op. Indices index as the JAX scatter does: a negative one counts from
    the end, and one outside [-n, n) is dropped (a sharded run's global
    slots past this rank's n, say) instead of raising."""
    n = ancestors.shape[-1]
    a = ancestors.reshape(-1, n).long()
    a = torch.where(a < 0, a + n, a)
    keep = (a >= 0) & (a < n)
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    seen = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    seen[rows.expand_as(a)[keep], a[keep]] = True
    count = seen.sum(dim=1).to(torch.float32)
    frac = count / torch.full((), float(n), device=a.device)
    return frac.reshape(ancestors.shape[:-1])


def filter_diagnostics(result) -> dict:
    """Summary of a ``FilterResult``: per-step ESS, the log-evidence, the
    final weights' ESS and, when the history was kept, the per-step
    unique-ancestor fractions [T]."""
    out = {
        "ess": result.ess,
        "log_evidence": result.log_evidence,
        "final_ess": effective_sample_size(result.final_log_weights),
    }
    if result.ancestors is not None:
        out["unique_ancestor_fraction"] = unique_ancestor_fraction(
            result.ancestors)
    return out
