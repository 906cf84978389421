"""Adaptive Metropolis (Haario et al. 2001) with a learned covariance.

Port of ``cusmc_tpu/mcmc/adaptive.py:30-171``. A running mean and
covariance of the chain states, pooled over the chains (and over the ranks
of ``axis_name``, a ``parallel.mesh.ParticleAxis``-like group, when the
chains are sharded), drives the proposal

    x' = x + s L z,   L L' = (2.38^2 / d) Cov + reg_eps I

with Robbins-Monro adaptation of s toward ``target_accept``. For the
first ``num_adapt`` sweeps the moments and s adapt, then both freeze; the
choice is a Python branch on the sweep index.

``chol_every=k`` refreshes the factor L once per block of k sweeps (the
moments still absorb every sweep) and raises on a ``num_steps`` that k
does not divide, as the JAX function's nested scan does. The factor is
``utils/linalg.chol_sqrt`` with ``reg_eps`` as its jitter: on the card
it reads nothing back and a failed factor is NaN, as in JAX; on the CPU
it raises. ``noise_dtype=torch.bfloat16``
draws the proposal normals with JAX's bfloat16 law, whose mean is not 0
(``mcmc/metropolis.py``).

Randomness and ``draws`` as in ``mcmc/metropolis.py``: a sequence of
``(z, u)``, one a sweep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.mcmc.chains import accept_uniforms, log_step_size, \
    pooled_mean, run_sweeps
from cusmc_tpu_torch.mcmc.metropolis import proposal_normals
from cusmc_tpu_torch.parallel.mesh import pmean
from cusmc_tpu_torch.utils.linalg import chol_sqrt


@dataclass
class AMState:
    x: torch.Tensor             # [C, d]
    logp: torch.Tensor          # [C]
    mean: torch.Tensor          # [d] running pooled mean
    cov: torch.Tensor           # [d, d] running pooled covariance
    count: torch.Tensor         # 0-dim: samples absorbed into mean / cov
    log_step: torch.Tensor      # 0-dim log of the scalar scale s
    accept_count: torch.Tensor  # [C]


@dataclass
class AMResult:
    state: AMState
    samples: Optional[torch.Tensor]
    accept_rate: torch.Tensor
    step_size: torch.Tensor
    proposal_cov: torch.Tensor  # the learned [d, d]


def adaptive_mh_sampler(
    key: KeyLike,
    log_prob: Callable,
    init_x: torch.Tensor,
    num_steps: int,
    step_size: float = 1.0,
    target_accept: float = 0.234,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    reg_eps: float = 1e-6,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name=None,
    chol_every: int = 1,
    noise_dtype=None,
    draws: Optional[Sequence] = None,
) -> AMResult:
    """Run ``num_steps`` adaptive-Metropolis sweeps over [C, d] chains;
    ``samples`` [ceil(T / thin), C, d] when ``keep_samples``."""
    if num_adapt is None:
        num_adapt = num_steps // 2
    if chol_every > 1 and num_steps % chol_every:
        raise ValueError(f"num_steps={num_steps} must be a multiple of "
                         f"chol_every={chol_every}")
    c, d = init_x.shape
    dtype, dev = init_x.dtype, init_x.device
    sd = 2.38 * 2.38 / d
    gen = None if draws is not None else make_generator(key, dev)

    mean0 = pmean(torch.mean(init_x, dim=0), axis_name)
    xc = init_x - mean0
    state = AMState(
        x=init_x, logp=log_prob(init_x), mean=mean0,
        cov=pmean(xc.T @ xc / c, axis_name) + torch.eye(d, dtype=dtype,
                                                        device=dev),
        count=torch.tensor(float(c), dtype=dtype, device=dev),
        log_step=log_step_size(step_size, init_x),
        accept_count=torch.zeros(c, dtype=dtype, device=dev))
    nb = torch.tensor(float(c), dtype=dtype, device=dev)
    factor = {}

    def sweep(state, t, adapt, step_draws):
        if t % chol_every == 0:
            factor["L"] = chol_sqrt(sd * state.cov, jitter=reg_eps)
        if step_draws is None:
            z = proposal_normals(gen, (c, d), init_x, noise_dtype)
            u = accept_uniforms(gen, c, init_x)
        else:
            z, u = step_draws
            z = z.to(dtype)
        x_prop = state.x + torch.exp(state.log_step) * (z @ factor["L"].T)
        logp_prop = log_prob(x_prop)
        accept = torch.log(u) < (logp_prop - state.logp)
        acc = accept.to(dtype)
        x_new = torch.where(accept[:, None], x_prop, state.x)
        new = AMState(x=x_new,
                      logp=torch.where(accept, logp_prop, state.logp),
                      mean=state.mean, cov=state.cov, count=state.count,
                      log_step=state.log_step,
                      accept_count=state.accept_count + acc)
        if t < num_adapt:
            # Pooled running moments over (chains x sweeps).
            batch_mean = pmean(torch.mean(x_new, dim=0), axis_name)
            n0 = state.count
            n1 = n0 + nb
            delta = batch_mean - state.mean
            xc = x_new - batch_mean[None, :]
            batch_cov = pmean(xc.T @ xc / c, axis_name)
            new.mean = state.mean + (nb / n1) * delta
            new.cov = (n0 / n1) * state.cov + (nb / n1) * batch_cov \
                + (n0 * nb / (n1 * n1)) * torch.outer(delta, delta)
            new.count = n1
            new.log_step = state.log_step + adapt * (
                pooled_mean(acc, axis_name) - target_accept)
        return new, None

    state, kept = run_sweeps(sweep, state, num_steps, num_adapt, adapt_rate,
                             keep_samples, thin, draws)
    return AMResult(
        state=state, samples=kept,
        accept_rate=pooled_mean(state.accept_count / num_steps, axis_name),
        step_size=torch.exp(state.log_step), proposal_cov=sd * state.cov)
