"""Sorted resampling positions for the CDF resamplers.

Port of ``cusmc_tpu/resampling/classic.py:60-118``: ``systematic_positions``,
``stratified_positions``, ``sorted_uniforms`` and ``POSITION_FNS``. The
ancestor functions of that module (rank-by-merge, a TPU workaround for
searchsorted) are not ported; the packed filter feeds these positions to
``ops/monotone_gather.inverse_cdf_apply``.

Each generator is split into its draws and a pure transform
(``*_from_uniforms``), so tests can replay JAX's uniforms.
``POSITION_FNS[name](gen, n, dtype, device)`` draws and transforms.
"""

from __future__ import annotations

from typing import Optional

import torch

from cusmc_tpu_torch.ops.random import tiny_uniform


def systematic_from_uniforms(u: torch.Tensor, n: int) -> torch.Tensor:
    """One shared offset u (0-dim): positions (i + u) / N."""
    return (torch.arange(n, dtype=u.dtype, device=u.device) + u) / n


def systematic_positions(gen: Optional[torch.Generator], n: int,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    """Lowest-variance positions: one uniform offset shared by all."""
    u = torch.rand((), generator=gen, dtype=dtype, device=device)
    return systematic_from_uniforms(u, n)


def stratified_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """Independent offset per stratum u [N]: positions (i + u_i) / N."""
    n = u.shape[0]
    return (torch.arange(n, dtype=u.dtype, device=u.device) + u) / n


def stratified_positions(gen: Optional[torch.Generator], n: int,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    u = torch.rand((n,), generator=gen, dtype=dtype, device=device)
    return stratified_from_uniforms(u)


def sorted_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """Order statistics of n iid U(0,1) from n+1 uniforms in [tiny, 1),
    through exponential spacings: u_(i) = S_i / S_{n+1}."""
    e = -torch.log(u)
    s = torch.cumsum(e, dim=0)
    n = u.shape[0] - 1
    return s[:n] / s[n]


def sorted_uniforms(gen: Optional[torch.Generator], n: int,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """n sorted uniforms, generated directly in order (no sort)."""
    return sorted_from_uniforms(tiny_uniform(gen, (n + 1,), dtype, device))


# Sorted-position generators for ``inverse_cdf_apply``:
# (gen, n, dtype, device) -> positions [n].
POSITION_FNS = {
    "systematic": systematic_positions,
    "stratified": stratified_positions,
    "multinomial": sorted_uniforms,
}
