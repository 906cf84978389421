"""Systematic resampling: one uniform ``U``; the ancestor of slot i is
the bin of the cumulative weights that holds ``(i + U) / N``."""

from __future__ import annotations

import torch


def ancestors(gen, w, traffic):
    n = w.shape[0]
    cdf = torch.cumsum(w, dim=0)
    u = torch.rand((), generator=gen, dtype=w.dtype, device=w.device)
    pos = (torch.arange(n, dtype=w.dtype, device=w.device) + u) / n * cdf[-1]
    return torch.clamp(torch.searchsorted(cdf, pos, right=True), max=n - 1)
