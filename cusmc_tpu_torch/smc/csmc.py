"""Conditional SMC and particle Gibbs.

Port of ``cusmc_tpu/smc/csmc.py:31-137``. Conditional SMC runs the
bootstrap filter with slot 0 clamped to a reference trajectory (state
forced, ancestor forced to slot 0), which leaves the exact joint smoothing
posterior invariant (Andrieu, Doucet & Holenstein 2010); drawing a path by
ancestral tracing and feeding it back is the particle Gibbs kernel over
p(x_{0:T} | y_{1:T}). Batch layout [N, d], registry resamplers and row
gathers, as in the JAX package.

The T-step ``lax.scan`` and the ``num_iters`` sweeps of ``particle_gibbs``
are Python loops on the model's device with no host read. The traced
path's final index is ``jax.random.categorical``'s law (``ops/random
.categorical``, Gumbel noise over the N final log-weights).

``draws`` replays given numbers (the JAX key schedule: ``k_init, k_scan,
k_trace = split(key, 3)``; per step ``k_res, k_prop =
split(fold_in(k_scan, t))``): ``{"init": noise of model.sample_initial,
"steps": [(resampler keyword draws, noise of model.propagate), ...],
"trace": Gumbel noise [N]}``. ``particle_gibbs``'s ``draws`` is ``(draws
of the initial sweep or None, [draws of sweep i, ...])``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from cusmc_tpu_torch.device import KeyLike, as_tensor, make_generator
from cusmc_tpu_torch.diagnostics.metrics import effective_sample_size, \
    log_normalize
from cusmc_tpu_torch.models.base import draw
from cusmc_tpu_torch.ops.random import categorical
from cusmc_tpu_torch.resampling import get_resampler
from cusmc_tpu_torch.smc.apf import step_draws
from cusmc_tpu_torch.smc.particle_filter import _ancestors, model_device


@dataclass
class CSMCResult:
    particles: torch.Tensor     # [T, N, d]
    obs_loglik: torch.Tensor    # [T, N]
    ancestors: torch.Tensor     # [T, N] int32
    ess: torch.Tensor           # [T]
    log_evidence: torch.Tensor
    sampled_path: torch.Tensor  # [T, d], an ancestral-trace draw


def _trace_path(gen, particles, ancestors, final_logw, noise=None):
    """One path by ancestral tracing from a final index drawn from the
    final weights."""
    idx = categorical(gen, final_logw, noise=noise)
    num_steps = particles.shape[0]
    path = torch.empty((num_steps,) + tuple(particles.shape[2:]),
                       dtype=particles.dtype, device=particles.device)
    for t in range(num_steps - 1, 0, -1):
        path[t] = particles[t][idx]
        idx = ancestors[t][idx].long()
    path[0] = particles[0][idx]
    return path


def conditional_smc(
    key: KeyLike,
    model,
    ys,
    ref_path,
    num_particles: int,
    resampler: str = "multinomial",
    device=None,
    draws: Optional[dict] = None,
) -> CSMCResult:
    """One cSMC sweep conditioned on ``ref_path`` [T, d]; multinomial
    resampling by default (the invariance argument is cleanest for it).
    ``device`` as in ``bootstrap_filter``."""
    res_fn = get_resampler(resampler)
    n = num_particles
    log_n = math.log(n)
    dev = model_device(model, device)
    gen = make_generator(key, dev)

    x = draw(model.sample_initial, gen, (n,),
             noise=None if draws is None else draws["init"])
    ref_path = as_tensor(ref_path, dtype=x.dtype, device=dev)
    x[0] = ref_path[0]
    ys = as_tensor(ys, dtype=x.dtype, device=dev)
    num_steps = ys.shape[0]
    logw0 = torch.full((n,), -log_n, dtype=x.dtype, device=dev)
    logw = logw0
    particles = torch.empty((num_steps,) + tuple(x.shape), dtype=x.dtype,
                            device=dev)
    lls = torch.empty((num_steps, n), dtype=x.dtype, device=dev)
    ancs = torch.empty((num_steps, n), dtype=torch.int32, device=dev)
    esss = torch.empty(num_steps, dtype=x.dtype, device=dev)
    lzs = torch.empty(num_steps - 1, dtype=x.dtype, device=dev)
    particles[0], lls[0] = x, logw0
    ancs[0] = torch.arange(n, dtype=torch.int32, device=dev)
    esss[0] = effective_sample_size(logw0)

    for t in range(1, num_steps):
        res_d, prop_d = step_draws(draws, gen, t)
        esss[t] = effective_sample_size(logw)
        a = _ancestors(res_fn, logw, res_d).clone()
        a[0] = 0                                  # clamp slot-0 ancestry
        x = draw(model.propagate, gen, x[a.long()], noise=prop_d)
        x[0] = ref_path[t]                        # clamp slot-0 state
        ll = model.observation_logpdf(ys[t], x)
        logw, lse = log_normalize(ll)
        lzs[t - 1] = lse - log_n
        particles[t], lls[t], ancs[t] = x, ll, a

    path = _trace_path(gen, particles, ancs, logw,
                       noise=None if draws is None else draws["trace"])
    return CSMCResult(particles=particles, obs_loglik=lls, ancestors=ancs,
                      ess=esss, log_evidence=torch.sum(lzs),
                      sampled_path=path)


def particle_gibbs(
    key: KeyLike,
    model,
    ys,
    num_particles: int,
    num_iters: int,
    init_path=None,
    resampler: str = "multinomial",
    device=None,
    draws: Optional[tuple] = None,
) -> torch.Tensor:
    """Run the particle Gibbs chain; returns the sampled paths [I, T, d].
    ``init_path`` defaults to the traced path of a cSMC sweep conditioned
    on a zero path."""
    dev = model_device(model, device)
    gen = make_generator(key, dev)
    init_draws, sweep_draws = (None, None) if draws is None else draws
    if init_path is None:
        num_steps = len(ys)
        zero = torch.zeros((num_steps, model.state_dim),
                           dtype=torch.float32, device=dev)
        init_path = conditional_smc(gen, model, ys, zero, num_particles,
                                    resampler, draws=init_draws).sampled_path
    path = init_path
    paths = []
    for i in range(num_iters):
        path = conditional_smc(
            gen, model, ys, path, num_particles, resampler,
            draws=None if sweep_draws is None else sweep_draws[i]
        ).sampled_path
        paths.append(path)
    return torch.stack(paths)
