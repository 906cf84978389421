"""Adaptive tempered SMC sampler for static targets.

Port of ``cusmc_tpu/smc/smc_sampler.py:39-192`` (Del Moral, Doucet &
Jasra 2006). N particles anneal from the prior to the target through
lambda: 0 -> 1:

  reweight:   logw += (lambda' - lambda) (log target - log prior)
  resample:   a registry resampler on the tempered weights
  rejuvenate: K moves at the current temperature (``mcmc.mh_step``,
              ``mala_step`` or ``hmc_step`` of 5 leapfrog steps)

Each stage picks the next lambda by bisection (30 fixed device steps) so
that the incremental ESS stays near ``target_ess`` N, with a floor of
1e-4 on the increment. The JAX function runs the stages as one
``lax.while_loop`` on ``lambda < 1``; here it is a Python loop that reads
lambda to the host once per stage, the stage's one host read.
``waste_free=True`` resamples M = N / K roots (multinomially, with
``ops/random.categorical``, the law of ``jax.random.categorical``) and
keeps every state of each root's K-state chain (Dau & Chopin 2022).

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``device``; ``prior_sample(gen, (N,))`` draws the first cloud, then each
stage its resample and its moves. ``draws`` replays given numbers:
``{"x0": [N, d], "stages": [(resample draws, [move draws, ...]), ...]}``,
the resample draws a registry resampler's keyword draws (``{"u": u}``)
or, waste-free, the Gumbel noise [M, N] of the root draw, and each move's
draws those of its ``*_step`` (``(z, u)``; HMC ``(p0, length, u)``). The
JAX key schedule: ``k_init, k_loop = split(key)``; per stage ``k_res,
k_mh = split(fold_in(k_loop, stage))``, move j on ``fold_in(k_mh, j)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator, resolve_device
from cusmc_tpu_torch.diagnostics.metrics import effective_sample_size
from cusmc_tpu_torch.mcmc.hmc import HMCState, hmc_step
from cusmc_tpu_torch.mcmc.mala import MALAState, _value_and_grad_batched, \
    mala_step
from cusmc_tpu_torch.mcmc.metropolis import MHState, mh_step
from cusmc_tpu_torch.ops.random import categorical
from cusmc_tpu_torch.resampling import get_resampler
from cusmc_tpu_torch.smc.particle_filter import _ancestors
from cusmc_tpu_torch.utils.timing import host_scalar


@dataclass
class SMCSamplerResult:
    particles: torch.Tensor      # [N, d] ~ target
    log_weights: torch.Tensor    # [N] normalised
    log_evidence: torch.Tensor   # log Z_target / Z_prior estimate
    num_stages: int
    accept_rate: torch.Tensor    # the last rejuvenation move's acceptance


def _ess_at(delta, logw, log_ratio):
    return effective_sample_size(logw + delta * log_ratio)


def _next_delta(logw, log_ratio, target_ess_frac, n, bisect_iters=30):
    """The largest delta in (0, 1] with ESS(delta) >= the target, by
    ``bisect_iters`` bisection steps on the device."""
    target = target_ess_frac * n
    lo = torch.zeros((), dtype=logw.dtype, device=logw.device)
    hi = torch.ones((), dtype=logw.dtype, device=logw.device)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        ok = _ess_at(mid, logw, log_ratio) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    full = _ess_at(1.0, logw, log_ratio) >= target
    return torch.where(full, torch.ones_like(lo), lo)


def smc_sampler(
    key: KeyLike,
    log_prior: Callable,
    log_target: Callable,
    prior_sample: Callable,
    num_particles: int,
    dim: int,
    resampler: str = "systematic",
    target_ess: float = 0.5,
    rejuvenation_steps: int = 5,
    rejuvenation: str = "rwm",
    waste_free: bool = False,
    step_size: float = 0.5,
    max_stages: int = 100,
    dtype=torch.float32,
    device=None,
    draws: Optional[dict] = None,
) -> SMCSamplerResult:
    """Sample a static target by tempering from the prior on ``device``
    (None: the card). ``log_prior`` and ``log_target`` map [N, d] -> [N]
    (differentiable by autograd for "mala" and "hmc");
    ``prior_sample(gen, (N,))`` draws [N, d]. ``rejuvenation``: "rwm"
    (random-walk Metropolis adapted toward 0.234), "mala" (toward 0.574)
    or "hmc" (5 jittered leapfrog steps, toward 0.8). ``waste_free``
    needs N divisible by ``rejuvenation_steps``."""
    if rejuvenation not in ("rwm", "mala", "hmc"):
        raise ValueError(f"unknown rejuvenation kernel {rejuvenation!r}")
    if waste_free:
        if num_particles % rejuvenation_steps != 0:
            raise ValueError("waste_free requires num_particles divisible "
                             "by rejuvenation_steps")
        num_roots = num_particles // rejuvenation_steps
    res_fn = get_resampler(resampler)
    n = num_particles
    dev = resolve_device(device)
    gen = None if draws is not None else make_generator(key, dev)
    x = (draws["x0"] if draws is not None
         else prior_sample(gen, (n,))).to(device=dev, dtype=dtype)
    logw = torch.zeros((n,), dtype=dtype, device=dev)
    lam = torch.zeros((), dtype=dtype, device=dev)
    log_z = torch.zeros((), dtype=dtype, device=dev)
    log_step = torch.tensor(math.log(step_size), dtype=dtype, device=dev)
    acc = torch.zeros((), dtype=dtype, device=dev)
    stage = 0
    # The stage's one host read: lambda against 1.
    while stage < max_stages and host_scalar(lam) < 1.0:
        res_d, move_d = ((gen, [None] * rejuvenation_steps) if draws is None
                         else draws["stages"][stage])
        log_ratio = log_target(x) - log_prior(x)
        delta = torch.clamp(_next_delta(logw, log_ratio, target_ess, n),
                            min=1e-4)  # guard against stalling
        lam_new = torch.clamp(lam + delta, max=1.0)
        step_exp = lam_new - lam

        logw_unnorm = logw + step_exp * log_ratio
        lse = torch.logsumexp(logw_unnorm, dim=0)
        log_z = log_z + lse - torch.logsumexp(logw, dim=0)
        logw_norm = logw_unnorm - lse

        def logpdf_now(xx, lam_new=lam_new):
            return (1.0 - lam_new) * log_prior(xx) + lam_new * log_target(xx)

        if waste_free:
            # M roots, each expanded into its full chain of K states.
            a = categorical(gen, logw_norm, num=num_roots,
                            noise=None if draws is None else res_d)
            num_moves = rejuvenation_steps - 1
        else:
            a = _ancestors(res_fn, logw_norm, res_d).long()
            num_moves = rejuvenation_steps
        starts = x[a]
        c = starts.shape[0]
        zeros = torch.zeros((c,), dtype=dtype, device=dev)
        if rejuvenation == "rwm":
            mv = MHState(x=starts, logp=logpdf_now(starts),
                         log_step=log_step, accept_count=zeros)
            move = mh_step
        else:
            logp0, grad0 = _value_and_grad_batched(logpdf_now)(starts)
            cls = MALAState if rejuvenation == "mala" else HMCState
            mv = cls(x=starts, logp=logp0, grad=grad0, log_step=log_step,
                     accept_count=zeros)
            move = mala_step if rejuvenation == "mala" else (
                lambda g, st, lp, **kw: hmc_step(g, st, lp, num_leapfrog=5,
                                                 **kw))
        trail = [starts]
        for j in range(num_moves):
            mv, acc = move(gen, mv, logpdf_now, adapt_rate=0.05,
                           draws=move_d[j])
            trail.append(mv.x)
        x = torch.cat(trail, dim=0) if waste_free else mv.x
        logw = torch.full((n,), -math.log(n), dtype=dtype, device=dev)
        lam, log_step = lam_new, mv.log_step
        stage += 1
    return SMCSamplerResult(
        particles=x, log_weights=logw - torch.logsumexp(logw, dim=0),
        log_evidence=log_z, num_stages=stage, accept_rate=acc)
