"""SMC^2: online, exact Bayesian parameter inference for state-space
models (Chopin, Jacob & Papaspiliopoulos 2013).

Port of ``cusmc_tpu/smc/smc2.py:44-201``. N_theta parameter particles
each carry their own bootstrap filter of N_x state particles and its
likelihood estimate. Per observation:

  1. every inner filter advances one step (multinomial ancestors from its
     weights, then propagate and reweight); the theta weights take the
     incremental evidence;
  2. when the theta ESS falls below ``ess_threshold`` N_theta, the theta
     particles are resampled and each is rejuvenated by a PMMH move: a
     random walk scaled by the cloud's covariance, a re-run of the
     proposal's whole inner filter on y_{1:t}, and the exact PMMH
     acceptance. The weights reset to uniform.

The JAX function ``vmap``s callables of one theta over the theta axis.
Here the callables are vectorised over that axis themselves, as the
port's Liu-West callables take each particle's theta (``torch.func.vmap``
cannot draw from an explicit generator, and a loop over the thetas would
cost N_theta times the launches):

  ``sample_initial(gen, nx, theta [nt, p]) -> x [nt, nx, d]``
  ``propagate(gen, x [nt, nx, d], theta [nt, p]) -> x [nt, nx, d]``
  ``observation_logpdf(y, x [nt, nx, d], theta [nt, p]) -> [nt, nx]``
  ``theta_prior_sample(gen, n) -> [n, p]``,
  ``theta_prior_logpdf(theta [n, p]) -> [n]``

The inner multinomial draw is ``ops/random.categorical`` over each
filter's N_x weights, N_x Gumbels a draw, as ``jax.random.categorical``
draws them. The ``lax.cond`` on the theta ESS is a Python branch on one
host read per step. The re-run covers steps 1..t only: the JAX function's
masked steps past t change nothing.

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``device``. ``draws`` replays the function's own numbers: ``{"steps":
[{"inner": Gumbels [nt, nx, nx], "res": the theta resampler's keyword
draws, "z": [nt, p], "rerun": [Gumbels [nt, nx, nx] for s = 1..t], "u":
[nt]}, ...]}`` (only "inner" on a step without rejuvenation); the
callables then receive ``gen=None`` and read their replayed noise
themselves, as Liu-West's do. The JAX key schedule: ``k_th, k_init,
k_scan = split(key, 3)``; per step ``k_inner, k_res, k_prop, k_acc,
k_rerun = split(fold_in(k_scan, t), 5)``, the inner filters' keys split
from ``k_inner`` (and the re-runs' from ``k_rerun``) over the thetas.
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
from cusmc_tpu_torch.ops.random import categorical, normal
from cusmc_tpu_torch.resampling import get_resampler
from cusmc_tpu_torch.smc.particle_filter import _ancestors
from cusmc_tpu_torch.utils.timing import host_scalar


@dataclass
class SMC2Result:
    """``thetas`` [N_theta, p] and normalised ``log_weights`` approximate
    p(theta | y_{1:T}); ``log_evidence_path`` [T] is log p_hat(y_{1:t});
    ``num_rejuvenations`` counts the PMMH passes and ``accept_rate`` is
    the mean acceptance of the last one."""

    thetas: torch.Tensor
    log_weights: torch.Tensor
    log_evidence: torch.Tensor
    log_evidence_path: torch.Tensor
    ess_path: torch.Tensor
    num_rejuvenations: int
    accept_rate: torch.Tensor


def _inner_ancestors(gen, lw: torch.Tensor, noise) -> torch.Tensor:
    """Each filter's N_x multinomial ancestors from its weights lw [nt,
    nx]: [nt, nx], given the Gumbels [nt, nx, nx] or drawn."""
    if noise is not None:
        return torch.argmax(noise + lw[:, None, :], dim=-1)
    return categorical(gen, lw, num=lw.shape[1]).T


def smc2(
    key: KeyLike,
    sample_initial: Callable,
    propagate: Callable,
    observation_logpdf: Callable,
    theta_prior_sample: Callable,
    theta_prior_logpdf: Callable,
    ys,
    num_theta: int,
    num_x: int,
    ess_threshold: float = 0.5,
    resampler: str = "systematic",
    rw_scale: float = 1.0,
    dtype=torch.float32,
    device=None,
    draws: Optional[dict] = None,
) -> SMC2Result:
    """Run SMC^2 on observations ``ys`` [T, k] (row 0 is the prior step)
    on ``device`` (None: the card), with the callables of the module
    docstring. Every inner filter resamples every step."""
    nt, nx = num_theta, num_x
    log_nx = math.log(nx)
    theta_res = get_resampler(resampler)
    dev = resolve_device(device)
    replay = draws is not None
    gen = None if replay else make_generator(key, dev)
    ys = as_tensor(ys, dtype=dtype, device=dev)
    t_total = ys.shape[0]
    rows = torch.arange(nt, device=dev)[:, None]

    theta = theta_prior_sample(gen, nt).to(dtype)
    p = theta.shape[-1]

    def inner_step(x, lw, y, th, noise):
        """One bootstrap step of every inner filter: (x', lw', lz_inc)."""
        a = _inner_ancestors(gen, lw, noise)
        x_new = propagate(gen, x[rows, a], th)
        ll = observation_logpdf(y, x_new, th)
        lse = torch.logsumexp(ll, dim=-1)
        return x_new, ll - lse[:, None], lse - log_nx

    def rerun(th, t_now, noises):
        """Every theta's filter re-run from scratch on y_{1:t_now}."""
        x = sample_initial(gen, nx, th)
        lw = torch.full((nt, nx), -log_nx, dtype=dtype, device=dev)
        lz = torch.zeros((nt,), dtype=dtype, device=dev)
        for s in range(1, t_now + 1):
            x, lw, lzi = inner_step(x, lw, ys[s], th,
                                    None if noises is None else noises[s - 1])
            lz = lz + lzi
        return x, lw, lz

    x = sample_initial(gen, nx, theta)
    lw = torch.full((nt, nx), -log_nx, dtype=dtype, device=dev)
    lz = torch.zeros((nt,), dtype=dtype, device=dev)
    uniform_th = torch.full((nt,), -math.log(nt), dtype=dtype, device=dev)
    logw_th = uniform_th
    lz_steps = torch.empty((t_total - 1,), dtype=dtype, device=dev)
    esss = torch.empty((t_total - 1,), dtype=dtype, device=dev)
    n_rej = 0
    acc = torch.zeros((), dtype=dtype, device=dev)
    eye = torch.eye(p, dtype=dtype, device=dev)
    for t in range(1, t_total):
        step_d = draws["steps"][t - 1] if replay else {}
        # 1. Advance every inner filter; the theta weights take the
        #    incremental evidence.
        x, lw, lz_inc = inner_step(x, lw, ys[t], theta, step_d.get("inner"))
        lz = lz + lz_inc
        logw_th, lz_steps[t - 1] = log_normalize(logw_th + lz_inc)
        ess = effective_sample_size(logw_th)
        esss[t - 1] = ess
        # 2. Resample and rejuvenate (the step's one host read).
        if host_scalar(ess) >= ess_threshold * nt:
            continue
        a = _ancestors(theta_res, logw_th,
                       step_d["res"] if replay else gen).long()
        theta_r, x_r, lw_r, lz_r = theta[a], x[a], lw[a], lz[a]
        # A random walk scaled by the resampled cloud's covariance.
        cen = theta_r - torch.mean(theta_r, dim=0)[None, :]
        cov = cen.T @ cen / nt + 1e-8 * eye
        chol = torch.linalg.cholesky_ex(cov).L  # no host read
        z = step_d["z"] if replay else normal(gen, (nt, p), dtype, dev)
        theta_prop = theta_r + (rw_scale * 2.38 / math.sqrt(p)) * (z @ chol.T)
        xp, lwp, lzp = rerun(theta_prop, t, step_d.get("rerun"))
        log_alpha = (lzp + theta_prior_logpdf(theta_prop) - lz_r
                     - theta_prior_logpdf(theta_r))
        u = step_d["u"] if replay else torch.rand(
            (nt,), generator=gen, dtype=dtype, device=dev)
        take = torch.log(u) < log_alpha
        theta = torch.where(take[:, None], theta_prop, theta_r)
        x = torch.where(take[:, None, None], xp, x_r)
        lw = torch.where(take[:, None], lwp, lw_r)
        lz = torch.where(take, lzp, lz_r)
        acc = torch.mean(take.to(dtype))
        logw_th = uniform_th
        n_rej += 1

    lz_path = torch.cumsum(lz_steps, dim=0)
    return SMC2Result(
        thetas=theta, log_weights=logw_th, log_evidence=lz_path[-1],
        log_evidence_path=torch.cat([torch.zeros((1,), dtype=dtype,
                                                 device=dev), lz_path]),
        ess_path=torch.cat([torch.full((1,), float(nt), dtype=dtype,
                                       device=dev), esss]),
        num_rejuvenations=n_rej, accept_rate=acc)
