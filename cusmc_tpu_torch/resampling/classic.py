"""Systematic, stratified, multinomial and residual resampling.

Port of ``cusmc_tpu/resampling/classic.py:60-181``: the sorted position
generators (``systematic_positions``, ``stratified_positions``,
``sorted_uniforms``, ``POSITION_FNS``), the ancestor functions
(``systematic_ancestors``, ``stratified_ancestors``,
``multinomial_ancestors``) and residual resampling (``_residual_parts``,
``_residual_positions``, ``residual_ancestors``). The ancestor functions
are plain torch (``weight_cdf`` and ``torch.searchsorted`` in place of
the JAX rank-by-merge, a TPU workaround); the packed filters feed the
positions to the kernels of ``ops/monotone_gather``.

Each generator is split into its draws and a pure transform
(``*_from_uniforms``), so tests can replay JAX's uniforms.
``POSITION_FNS[name](gen, n, dtype, device)`` draws and transforms; an
ancestor function takes ``(gen, log_weights, u=None)``, where ``u`` are the
uniforms it would draw.

Each residual of the port computes its JAX counterpart's law for the top
remainder draw, so that the parity tests hold exactly:

- ``residual_ancestors`` (``cusmc_tpu/resampling/classic.py:173``) does not
  clamp: ``v = pos * rcdf[-1]``, the rank clipped to N - 1;
- the packed single-device residual (``smc/particle_filter.py``,
  ``cusmc_tpu/smc/particle_filter.py:445-446``) caps the unit positions at
  1 - 1e-6 (``capped_residual_values``);
- the sharded residual (``parallel/resampling.py``,
  ``cusmc_tpu/parallel/resampling.py:220-227``) clamps the values one ulp
  below the remainder cdf total (``clamped_residual_values``).

The three differ only for a top order statistic above 1 - 1e-6.
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


def weight_cdf(w: torch.Tensor) -> torch.Tensor:
    """The inclusive cumsum of non-negative weights [N] for a search:
    monotone, and flat over a zero weight, so that no position falls in a
    zero-weight particle's bin. On the CPU ``torch.cumsum`` adds in order,
    which gives both. On a CUDA tensor it is a parallel scan whose float32
    sum gives neither: over 2^20 softmax weights on the H100 it dipped 8156
    times and stepped up by an ulp over zero weights 478 times, where the
    search placed 19 systematic positions (the auxiliary filter's
    second-stage weight divides by such a particle's first-stage weight,
    and its evidence rose by 23.4 nats at N = 2^20, T = 200;
    ``chip_smoke.registry_cdf_fault``). There the sum is taken in float64,
    whose steps over a zero weight no float32 position spacing
    resolves."""
    if w.device.type == "cuda":
        return torch.cumsum(w.double(), dim=0)
    return torch.cumsum(w, dim=0)


def _inverse_cdf(positions: torch.Tensor,
                 log_weights: torch.Tensor) -> torch.Tensor:
    """Ancestors with cdf[a-1] <= p < cdf[a] over the normalised weights,
    clipped to N-1 (the last cdf entry may round below 1), int32."""
    n = log_weights.shape[0]
    cdf = weight_cdf(torch.softmax(log_weights, dim=0))
    a = torch.searchsorted(cdf, positions.to(cdf.dtype), right=True)
    return a.clamp_(0, n - 1).to(torch.int32)


def systematic_ancestors(gen: Optional[torch.Generator],
                         log_weights: torch.Tensor,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Systematic resampling; ``u`` the shared offset (0-dim)."""
    n = log_weights.shape[0]
    if u is None:
        u = torch.rand((), generator=gen, dtype=log_weights.dtype,
                       device=log_weights.device)
    return _inverse_cdf(systematic_from_uniforms(u, n), log_weights)


def stratified_ancestors(gen: Optional[torch.Generator],
                         log_weights: torch.Tensor,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified resampling; ``u`` [N] the per-stratum offsets."""
    if u is None:
        u = torch.rand(log_weights.shape, generator=gen,
                       dtype=log_weights.dtype, device=log_weights.device)
    return _inverse_cdf(stratified_from_uniforms(u), log_weights)


def multinomial_ancestors(gen: Optional[torch.Generator],
                          log_weights: torch.Tensor,
                          u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multinomial resampling at sorted order statistics (the ancestor
    multiset is exactly multinomial, returned sorted); ``u`` [N+1] in
    [tiny, 1)."""
    n = log_weights.shape[0]
    if u is None:
        u = tiny_uniform(gen, (n + 1,), log_weights.dtype,
                         log_weights.device)
    return _inverse_cdf(sorted_from_uniforms(u), log_weights)


def residual_positions_from_uniforms(u: torch.Tensor,
                                     n_det: torch.Tensor) -> torch.Tensor:
    """Sorted positions [n] from n+1 uniforms in [tiny, 1) whose first
    R = n - n_det entries are exactly R uniform order statistics
    (S_k / S_{R+1} over exponential-spacing partial sums S); entries past
    R exceed 1 and are masked by the callers. ``n_det`` is a 0-dim integer
    tensor: S_{R+1} is gathered on the device, with no host read."""
    n = u.shape[0] - 1
    s = torch.cumsum(-torch.log(u), dim=0)
    s_r1 = s.index_select(0, (n - n_det.long()).reshape(1))
    return s[:n] / s_r1


def clamped_residual_values(u: torch.Tensor, n_det: torch.Tensor,
                            rtot: torch.Tensor) -> torch.Tensor:
    """Remainder search values ``min(pos * rtot, nextafter(rtot, 0))``:
    scaled positions clamped one ulp below the remainder cdf total, so a
    top order statistic that rounds up to the total still lands in the
    last bin with remainder mass and never past it."""
    top = torch.nextafter(rtot, torch.zeros_like(rtot))
    return torch.minimum(residual_positions_from_uniforms(u, n_det) * rtot,
                         top)


def capped_residual_values(u: torch.Tensor, n_det: torch.Tensor,
                           rtot: torch.Tensor) -> torch.Tensor:
    """Remainder search values ``min(pos, 1 - 1e-6) * rtot``: the unit
    positions capped at the fixed quantile 1 - 1e-6 (float32), the law of
    the JAX single-device packed residual."""
    return torch.clamp_max(residual_positions_from_uniforms(u, n_det),
                           1.0 - 1e-6) * rtot


def residual_draws(gen: Optional[torch.Generator], n: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """The residual resampler's n+1 uniforms in [tiny, 1)."""
    return tiny_uniform(gen, (n + 1,), dtype, device)


def _residual_parts(log_weights: torch.Tensor):
    """(copy-count cumsum [n], n_det 0-dim int32, remainder weights [n])."""
    n = log_weights.shape[0]
    nw = n * torch.softmax(log_weights, dim=0)
    counts = torch.floor(nw)
    ccum = torch.cumsum(counts, dim=0)
    n_det = torch.clamp(ccum[-1], max=n).to(torch.int32)
    return ccum, n_det, torch.clamp(nw - counts, min=0.0)


def roll_right(n: int, shift: torch.Tensor) -> torch.Tensor:
    """Index map of a roll right by a 0-dim device ``shift``:
    ``x[idx][i] = x[(i - shift) mod n]``, built on the device (a torch.roll
    would need the shift on the host)."""
    i = torch.arange(n, device=shift.device)
    return torch.remainder(i - shift.long(), n)


def residual_ancestors(gen: Optional[torch.Generator],
                       log_weights: torch.Tensor,
                       u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Residual resampling (Liu & Chen 1998): particle i is copied
    floor(N w_i) times; the R = N - sum floor(N w_i) remaining slots take
    sorted multinomial draws from the remainders N w_i - floor(N w_i),
    rolled to the tail slots. ``u`` [N+1] in [tiny, 1)."""
    n = log_weights.shape[0]
    if u is None:
        u = residual_draws(gen, n, log_weights.dtype, log_weights.device)
    ccum, n_det, resid = _residual_parts(log_weights)
    slots = torch.arange(n, device=log_weights.device)
    det = torch.searchsorted(ccum, slots.to(ccum.dtype), right=True)
    det = det.clamp_(max=n - 1)
    rcdf = weight_cdf(resid)
    v = residual_positions_from_uniforms(u, n_det).to(rcdf.dtype) * rcdf[-1]
    res = torch.searchsorted(rcdf, v, right=True).clamp_(0, n - 1)
    res = res[roll_right(n, n_det)]
    return torch.where(slots < n_det, det, res).to(torch.int32)
