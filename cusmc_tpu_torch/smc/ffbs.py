"""Forward-filter backward-simulation (FFBS) smoother.

Port of ``cusmc_tpu/smc/ffbs.py:33-119`` (Godsill, Doucet & West 2004):
M independent smoothing trajectories drawn by reweighting the stored
filter clouds backward with the transition density,

    w_{t|t+1}^i  ∝  w_t^i · p(x_{t+1}* | x_t^i).

For the DLM the transition term is a Gaussian (or Student-T) quadratic
form of ``x_{t+1}* - G x_t^i``; for the M paths at once it is an [M, N]
tensor a step whose cross term is one ``torch.matmul`` (the JAX package
computes it in XLA too, ``ffbs.py:50``), with the whitening solves in
``utils/linalg.tri_solve``. The backward ``lax.scan`` becomes a Python
loop with no host read. Each step's index draw is
``jax.random.categorical``'s law (``ops/random.categorical``, Gumbel noise
over [M, N]).

``transition_logpdf`` covers the DLM (refusing the reference's
``per_dim_chi`` MVT, whose transition density is not defined), stochastic
volatility, and any model with its own ``transition_logpdf(x_next [M, d],
x_prev [N, d]) -> [M, N]``.

``draws`` replays given numbers (the JAX key schedule: ``k_last, k_scan =
split(key)``; step t draws from ``fold_in(k_scan, t)``): ``{"last": the
Gumbel noise [M, N] of the final indices, "steps": {t: the Gumbel noise
[M, N] of step t, t = T-2 .. 0}}``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.models.stochvol import StochasticVolatility
from cusmc_tpu_torch.ops.packed import matvec
from cusmc_tpu_torch.ops.random import categorical
from cusmc_tpu_torch.smc.particle_filter import FilterResult
from cusmc_tpu_torch.utils.linalg import tri_solve


def _dlm_transition_logpdf(model: DLM, x_next: torch.Tensor,
                           x_prev: torch.Tensor) -> torch.Tensor:
    """log p(x_next | x_prev) for all pairs: [M, d] x [N, d] -> [M, N],
    Gaussian or Student-T as the model's noise. The quadratic form
    |Li(a - b)|^2 = |Li a|^2 - 2 (Li a).(Li b) + |Li b|^2 has one [M, d] x
    [d, N] product as its cross term. W_sqrt may be any square root (an
    eigh root is not triangular), so a Cholesky factor is rebuilt from W;
    the weights stay at least float32 under a bfloat16 state."""
    wdtype = torch.promote_types(model.W_sqrt.dtype, torch.float32)
    W_sqrt = model.W_sqrt.to(wdtype)
    w_chol = torch.linalg.cholesky_ex(W_sqrt @ W_sqrt.T).L
    za = tri_solve(w_chol, x_next.to(wdtype))                  # [M, d]
    zb = tri_solve(w_chol, matvec(x_prev, model.G.T).to(wdtype))  # [N, d]
    cross = za @ zb.T                                          # [M, N]
    qa = torch.sum(za * za, dim=-1)[:, None]
    qb = torch.sum(zb * zb, dim=-1)[None, :]
    quad = qa - 2.0 * cross + qb
    d = x_next.shape[-1]
    half_logdet = torch.sum(torch.log(torch.diagonal(w_chol)))
    if model.noise == "mvt":
        df = model.df.to(wdtype)
        log_norm = (torch.lgamma(0.5 * (df + d)) - torch.lgamma(0.5 * df)
                    - 0.5 * d * (torch.log(df) + math.log(math.pi))
                    - half_logdet)
        return log_norm - 0.5 * (df + d) * torch.log1p(quad / df)
    log_norm = -0.5 * d * math.log(2.0 * math.pi) - half_logdet
    return log_norm - 0.5 * quad


def _sv_transition_logpdf(model: StochasticVolatility, x_next, x_prev):
    mean = model.mu + model.phi * (x_prev[:, 0] - model.mu)   # [N]
    resid = x_next[:, 0][:, None] - mean[None, :]             # [M, N]
    var = model.sigma ** 2
    return -0.5 * (torch.log(2.0 * math.pi * var) + resid * resid / var)


def transition_logpdf(model, x_next: torch.Tensor,
                      x_prev: torch.Tensor) -> torch.Tensor:
    """log p(x_next | x_prev) for all pairs, [M, d] x [N, d] -> [M, N]."""
    if isinstance(model, DLM):
        if model.per_dim_chi:
            raise NotImplementedError(
                "FFBS transition density for the reference's nonstandard "
                "per-dimension-chi MVT is not defined; use per_dim_chi="
                "False (the standard construction)")
        return _dlm_transition_logpdf(model, x_next, x_prev)
    if isinstance(model, StochasticVolatility):
        return _sv_transition_logpdf(model, x_next, x_prev)
    if hasattr(model, "transition_logpdf"):
        return model.transition_logpdf(x_next, x_prev)
    raise NotImplementedError(f"no transition_logpdf for {type(model)}")


def ffbs(key: KeyLike, model, result: FilterResult, num_paths: int = 64,
         draws: Optional[dict] = None) -> torch.Tensor:
    """Draw ``num_paths`` smoothing trajectories [T, M, d] on the
    history's device. ``result`` must come from a run with
    ``return_history=True``; the filter log-weights of each step are
    rebuilt from ``obs_loglik`` (valid for runs that resample every step,
    the default)."""
    if result.particles is None:
        raise ValueError("ffbs needs return_history=True")
    particles = result.particles        # [T, N, d]
    logw = result.obs_loglik            # [T, N]
    num_steps = particles.shape[0]
    gen = make_generator(key, particles.device)
    idx = categorical(gen, result.final_log_weights, num_paths,
                      noise=None if draws is None else draws["last"])
    x = particles[-1][idx]
    paths = torch.empty((num_steps, num_paths) + tuple(particles.shape[2:]),
                        dtype=particles.dtype, device=particles.device)
    paths[-1] = x
    for t in range(num_steps - 2, -1, -1):
        lw = logw[t][None, :] + transition_logpdf(model, x, particles[t])
        idx = categorical(gen, lw,
                          noise=None if draws is None else draws["steps"][t])
        x = particles[t][idx]
        paths[t] = x
    return paths
