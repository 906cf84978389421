"""Weight diagnostics.

Port of ``cusmc_tpu/diagnostics/metrics.py:19-41`` (``log_normalize``,
``effective_sample_size``) on one shard; the mesh-axis reductions come
with the sharded filter.
"""

from __future__ import annotations

import torch


def log_normalize(logw: torch.Tensor):
    """Return (normalized log-weights, log-normalizer)."""
    lse = torch.logsumexp(logw, dim=-1)
    return logw - lse, lse


def effective_sample_size(logw: torch.Tensor) -> torch.Tensor:
    """Kish ESS = (sum w)^2 / sum w^2, stable in log space."""
    lse1 = torch.logsumexp(logw, dim=-1)
    lse2 = torch.logsumexp(2.0 * logw, dim=-1)
    return torch.exp(2.0 * lse1 - lse2)
