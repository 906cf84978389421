"""Liu-West filter: online joint state and parameter estimation.

Port of ``cusmc_tpu/smc/liu_west.py:35-151`` (Liu & West 2001). Particles
carry (x_i, theta_i); parameter degeneracy is fought with kernel
shrinkage inside an auxiliary-filter step::

    m_i      = a theta_i + (1 - a) theta_bar
    theta'_i ~ N(m_{A_i}, h^2 V_theta),   a^2 + h^2 = 1,  a = (3 delta - 1) / (2 delta)

with the lookahead mu_i = E[x_t | x_{t-1,i}] driving the first-stage
weights and the second stage correcting exactly. Batch layout [N, ...],
registry resamplers and row gathers, as in the JAX package; the weighted
[p, p] covariance's Cholesky factor is ``torch.linalg.cholesky_ex`` (no
host read). The ``lax.scan`` becomes a Python loop on ``device``.

The model callables are vectorised over particles and get each
particle's own theta: ``sample_initial(gen, n, theta)``, ``propagate(gen,
x, theta)``, ``propagate_mean(x, theta)``, ``observation_logpdf(y, x,
theta)``, ``theta_prior_sample(gen, n)``. ``draws`` replays the filter's
own draws (the JAX key schedule: ``k_th, k_x, k_scan = split(key, 3)``;
per step ``k_res, k_theta, k_prop = split(fold_in(k_scan, t), 3)``):
``{"steps": [(resampler keyword draws, the theta kernel's normals z [n,
p]), ...]}``; the callables then receive ``gen=None`` and draw their own
replayed noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from cusmc_tpu_torch.device import KeyLike, as_tensor, make_generator, \
    resolve_device
from cusmc_tpu_torch.diagnostics.metrics import effective_sample_size, \
    log_normalize
from cusmc_tpu_torch.ops.random import normal
from cusmc_tpu_torch.resampling import get_resampler
from cusmc_tpu_torch.smc.particle_filter import _ancestors


@dataclass
class LiuWestResult:
    """``theta_mean`` [T, p] is the running posterior mean E[theta |
    y_{1:t}]; ``filtered_mean`` [T, d] that of the state; ``final_*`` the
    cloud at T. ``thetas`` and ``xs`` [T, N, .] only with
    ``return_history=True``."""

    final_x: torch.Tensor
    final_theta: torch.Tensor
    final_log_weights: torch.Tensor
    ess: torch.Tensor
    log_evidence: torch.Tensor
    theta_mean: torch.Tensor
    filtered_mean: torch.Tensor
    thetas: Optional[torch.Tensor] = None
    xs: Optional[torch.Tensor] = None


def _weighted_moments(theta: torch.Tensor, logw: torch.Tensor):
    w = torch.softmax(logw, dim=0)
    mean = w @ theta
    centered = theta - mean[None, :]
    cov = (centered * w[:, None]).T @ centered
    return mean, cov


def liu_west_filter(
    key: KeyLike,
    sample_initial: Callable,
    propagate: Callable,
    propagate_mean: Callable,
    observation_logpdf: Callable,
    theta_prior_sample: Callable,
    ys,
    num_particles: int,
    delta: float = 0.98,
    resampler: str = "systematic",
    return_history: bool = False,
    device=None,
    draws: Optional[dict] = None,
) -> LiuWestResult:
    """Run the Liu-West auxiliary filter on observations ``ys`` [T, k]
    (row 0 is the prior step) on ``device`` (None: the card). ``delta`` in
    (0.5, 1] is the discount."""
    if not 0.5 < delta <= 1.0:
        raise ValueError(f"delta must be in (0.5, 1], got {delta}")
    a = (3.0 * delta - 1.0) / (2.0 * delta)
    h2 = 1.0 - a * a
    n = num_particles
    log_n = math.log(n)
    ancestor_fn = get_resampler(resampler)
    dev = resolve_device(device)
    gen = make_generator(key, dev)
    replay = draws is not None

    theta = theta_prior_sample(None if replay else gen, n)
    p = theta.shape[-1]
    x = sample_initial(None if replay else gen, n, theta)
    dtype = x.dtype
    ys = as_tensor(ys, dtype=dtype, device=dev)
    num_steps = ys.shape[0]
    logw0 = torch.full((n,), -log_n, dtype=dtype, device=dev)
    logw = logw0
    esss = torch.empty(num_steps, dtype=dtype, device=dev)
    lzs = torch.empty(num_steps - 1, dtype=dtype, device=dev)
    th_means = torch.empty((num_steps, p), dtype=dtype, device=dev)
    x_means = torch.empty((num_steps,) + tuple(x.shape[1:]), dtype=dtype,
                          device=dev)
    esss[0] = effective_sample_size(logw0)
    th_means[0], x_means[0] = theta.mean(dim=0), x.mean(dim=0)
    if return_history:
        thetas = torch.empty((num_steps,) + tuple(theta.shape),
                             dtype=theta.dtype, device=dev)
        xs = torch.empty((num_steps,) + tuple(x.shape), dtype=dtype,
                         device=dev)
        thetas[0], xs[0] = theta, x
    eye = torch.eye(p, dtype=dtype, device=dev)

    for t in range(1, num_steps):
        res_d, z = (gen, None) if not replay else draws["steps"][t - 1]
        y = ys[t]
        esss[t] = effective_sample_size(logw)
        theta_bar, v_theta = _weighted_moments(theta, logw)
        m = a * theta + (1.0 - a) * theta_bar[None, :]
        look = observation_logpdf(y, propagate_mean(x, m), m)
        logg, lz_first = log_normalize(logw + look)
        anc = _ancestors(ancestor_fn, logg, res_d).long()
        chol = torch.linalg.cholesky_ex(h2 * v_theta + 1e-10 * eye).L
        if z is None:
            z = normal(gen, (n, p), dtype, dev)
        theta = m[anc] + z @ chol.T
        x = propagate(None if replay else gen, x[anc], theta)
        ll = observation_logpdf(y, x, theta)
        logw, lse = log_normalize(ll - look[anc])
        # The auxiliary construction's evidence increment: (sum_i g_i)
        # times the mean second-stage weight.
        lzs[t - 1] = lz_first + lse - log_n
        w = torch.exp(logw)
        th_means[t], x_means[t] = w @ theta, w @ x
        if return_history:
            thetas[t], xs[t] = theta, x

    result = LiuWestResult(
        final_x=x, final_theta=theta, final_log_weights=logw, ess=esss,
        log_evidence=torch.sum(lzs), theta_mean=th_means,
        filtered_mean=x_means)
    if return_history:
        result.thetas, result.xs = thetas, xs
    return result
