"""Hamiltonian Monte Carlo with a fixed-length leapfrog.

Port of ``cusmc_tpu/mcmc/hmc.py:31-159``. Each sweep draws momenta p0
~ N(0, I) (identity mass matrix), runs ``num_leapfrog`` = L leapfrog steps
of the whole [C, d] chain block (each one batched gradient,
``mala._value_and_grad_batched``), and accepts on the joint energy.
Divergences (a non-finite energy) always reject. The step size adapts by
Robbins-Monro toward 0.8 on the acceptance pooled over the chains (and
over the ranks of ``axis_name``, a ``parallel.mesh.ParticleAxis``-like
group, when the chains are sharded).

``jitter=True`` draws the trajectory length uniformly from [1, L] each
sweep, shared by the chains. It is drawn on the device and the leapfrog
runs all L steps, masked with ``torch.where`` past that length, as the
JAX scan masks them (``:76-100``): reading the length on the host would
put a device sync in every sweep. ``jitter=False`` runs all L. A sweep
therefore evaluates L gradients whatever length it drew.

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``init_x``'s device; each sweep draws p0 [C, d], the length (when
``jitter``) and the accept uniforms u [C]. ``draws`` replays given
numbers: a sequence of ``(p0, length, u)``, one a sweep, ``length`` an
int or a 0-dim tensor, or None without jitter (the JAX key schedule:
``kp, kl, ku = split(fold_in(key, t), 3)``, ``length = randint(kl, (),
1, L + 1)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.mcmc.chains import accept_uniforms, log_step_size, \
    pooled_mean, run_sweeps
from cusmc_tpu_torch.mcmc.mala import _value_and_grad_batched
from cusmc_tpu_torch.ops.random import normal


@dataclass
class HMCState:
    x: torch.Tensor             # [C, d]
    logp: torch.Tensor          # [C]
    grad: torch.Tensor          # [C, d]
    log_step: torch.Tensor      # 0-dim
    accept_count: torch.Tensor  # [C]


@dataclass
class HMCResult:
    state: HMCState
    samples: Optional[torch.Tensor]
    accept_rate: torch.Tensor
    step_size: torch.Tensor


def hmc_init(log_prob: Callable, init_x: torch.Tensor,
             step_size: float = 0.1) -> HMCState:
    logp, grad = _value_and_grad_batched(log_prob)(init_x)
    return HMCState(x=init_x, logp=logp, grad=grad,
                    log_step=log_step_size(step_size, init_x),
                    accept_count=torch.zeros_like(logp))


def hmc_step(gen: Optional[torch.Generator], state: HMCState,
             log_prob: Callable, num_leapfrog: int = 10,
             target_accept: float = 0.8, adapt_rate: float = 0.0,
             axis_name=None, jitter: bool = True, draws=None):
    """One HMC sweep over all chains; ``draws`` = (p0, length, u)
    replaces the draws from ``gen``. Returns ``(state, pooled
    acceptance)``."""
    c, d = state.x.shape
    dtype, dev = state.x.dtype, state.x.device
    if draws is None:
        p0 = normal(gen, (c, d), dtype, dev)
        length = (torch.randint(1, num_leapfrog + 1, (), generator=gen,
                                device=dev) if jitter else None)
        u = accept_uniforms(gen, c, state.x)
    else:
        p0, length, u = draws
        if not jitter:
            length = None
    eps = torch.exp(state.log_step)
    vg = _value_and_grad_batched(log_prob)

    x, p, grad, logp = state.x, p0, state.grad, state.logp
    for i in range(num_leapfrog):
        p_half = p + 0.5 * eps * grad
        x_new = x + eps * p_half
        logp_new, grad_new = vg(x_new)
        p_new = p_half + 0.5 * eps * grad_new
        if length is None:
            x, p, grad, logp = x_new, p_new, grad_new, logp_new
        else:
            active = torch.as_tensor(length, device=dev) > i
            x = torch.where(active, x_new, x)
            p = torch.where(active, p_new, p)
            grad = torch.where(active, grad_new, grad)
            logp = torch.where(active, logp_new, logp)

    # Metropolis correction on the joint (x, p) energy.
    ke0 = 0.5 * torch.sum(p0 * p0, dim=-1)
    ke1 = 0.5 * torch.sum(p * p, dim=-1)
    log_alpha = (logp - ke1) - (state.logp - ke0)
    # Divergences (non-finite energies) always reject.
    accept = (torch.log(u) < log_alpha) & torch.isfinite(log_alpha)
    acc = accept.to(dtype)
    pooled = pooled_mean(acc, axis_name)
    return HMCState(
        x=torch.where(accept[:, None], x, state.x),
        logp=torch.where(accept, logp, state.logp),
        grad=torch.where(accept[:, None], grad, state.grad),
        log_step=state.log_step + adapt_rate * (pooled - target_accept),
        accept_count=state.accept_count + acc), pooled


def hmc_sampler(
    key: KeyLike,
    log_prob: Callable,
    init_x: torch.Tensor,
    num_steps: int,
    num_leapfrog: int = 10,
    step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name=None,
    jitter: bool = True,
    draws: Optional[Sequence] = None,
) -> HMCResult:
    """Run ``num_steps`` HMC sweeps over [C, d] chains (step adaptation
    for the first ``num_adapt``, default num_steps // 2, then frozen);
    ``samples`` [ceil(T / thin), C, d] when ``keep_samples``."""
    if num_adapt is None:
        num_adapt = num_steps // 2
    gen = None if draws is not None else make_generator(key, init_x.device)
    state = hmc_init(log_prob, init_x, step_size)

    def sweep(state, t, adapt, step_draws):
        return hmc_step(gen, state, log_prob, num_leapfrog, target_accept,
                        adapt, axis_name, jitter, step_draws)

    final, samples = run_sweeps(sweep, state, num_steps, num_adapt,
                                adapt_rate, keep_samples, thin, draws)
    return HMCResult(
        state=final, samples=samples,
        accept_rate=pooled_mean(final.accept_count / num_steps, axis_name),
        step_size=torch.exp(final.log_step))
