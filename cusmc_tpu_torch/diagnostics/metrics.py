"""Weight diagnostics.

Port of ``cusmc_tpu/diagnostics/metrics.py:19-41`` (``log_normalize``,
``effective_sample_size``). ``axis`` is the particle axis of a sharded run
(``parallel.mesh.ParticleAxis``): the log-sum-exp then takes a max and a
sum all-reduce over it. ``axis=None`` is one shard.
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
