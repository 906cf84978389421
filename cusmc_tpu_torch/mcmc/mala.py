"""Metropolis-adjusted Langevin algorithm (MALA).

Port of ``cusmc_tpu/mcmc/mala.py:51-143``. The Langevin proposal

    x' = x + (eps^2 / 2) grad log p(x) + eps z,   z ~ N(0, I)

with the asymmetric-proposal Metropolis correction; chains are the
leading axis [C, d], and the step size adapts by Robbins-Monro toward the
MALA optimum 0.574 on the acceptance pooled over the chains (and over the
ranks of ``axis_name``, a ``parallel.mesh.ParticleAxis``-like group, when
the chains are sharded).

Gradients come from autograd: ``_value_and_grad_batched`` runs one
forward and one backward pass that pulls back a ones cotangent, as the
JAX function pulls one back through ``jax.vjp``; the chains are
independent, so each gets its own gradient without ``vmap``. ``log_prob``
maps [C, d] -> [C] and must be differentiable by autograd (the port's
``distributions.make_{mvn,mvt}_logprob`` are).

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``init_x``'s device; each sweep draws its normals z [C, d], then its
accept uniforms u [C]. ``draws`` replays given numbers: a sequence of
``(z, u)``, one a sweep (the JAX key schedule: ``kz, ku =
split(fold_in(key, t))``, ``z = normal(kz, (C, d))``, ``u = uniform(ku,
(C,))``). The sweep loop is ``mcmc/chains.run_sweeps``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.mcmc.chains import accept_uniforms, log_step_size, \
    pooled_mean, run_sweeps
from cusmc_tpu_torch.ops.random import normal


@dataclass
class MALAState:
    """``x`` [C, d], ``logp`` [C], ``grad`` [C, d] (grad log p at x),
    ``log_step`` 0-dim (shared by the chains), ``accept_count`` [C]."""

    x: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    log_step: torch.Tensor
    accept_count: torch.Tensor


@dataclass
class MALAResult:
    state: MALAState
    samples: Optional[torch.Tensor]
    accept_rate: torch.Tensor
    step_size: torch.Tensor


def _value_and_grad_batched(log_prob: Callable) -> Callable:
    """x [C, d] -> (log p [C], grad log p [C, d]) in one forward and one
    backward pass, detached from the graph."""

    def vg(x: torch.Tensor):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            logp = log_prob(xg)
            (grad,) = torch.autograd.grad(logp, xg, torch.ones_like(logp))
        return logp.detach(), grad

    return vg


def mala_init(log_prob: Callable, init_x: torch.Tensor,
              step_size: float = 0.1) -> MALAState:
    logp, grad = _value_and_grad_batched(log_prob)(init_x)
    return MALAState(x=init_x, logp=logp, grad=grad,
                     log_step=log_step_size(step_size, init_x),
                     accept_count=torch.zeros_like(logp))


def mala_step(gen: Optional[torch.Generator], state: MALAState,
              log_prob: Callable, target_accept: float = 0.574,
              adapt_rate: float = 0.0, axis_name=None, draws=None):
    """One MALA sweep over all chains; ``draws`` = (z, u) replaces the
    draws from ``gen``. Returns ``(state, pooled acceptance)``."""
    c, d = state.x.shape
    if draws is None:
        z = normal(gen, (c, d), state.x.dtype, state.x.device)
        u = accept_uniforms(gen, c, state.x)
    else:
        z, u = draws
    eps = torch.exp(state.log_step)
    eps2 = eps * eps
    mean_fwd = state.x + 0.5 * eps2 * state.grad
    x_prop = mean_fwd + eps * z
    logp_prop, grad_prop = _value_and_grad_batched(log_prob)(x_prop)

    # log q(x | x') - log q(x' | x): Gaussian with mean x' + eps^2/2 grad'.
    mean_rev = x_prop + 0.5 * eps2 * grad_prop
    fwd = -torch.sum((x_prop - mean_fwd) ** 2, dim=-1) / (2.0 * eps2)
    rev = -torch.sum((state.x - mean_rev) ** 2, dim=-1) / (2.0 * eps2)
    log_alpha = logp_prop - state.logp + rev - fwd

    accept = torch.log(u) < log_alpha
    acc = accept.to(state.x.dtype)
    pooled = pooled_mean(acc, axis_name)
    return MALAState(
        x=torch.where(accept[:, None], x_prop, state.x),
        logp=torch.where(accept, logp_prop, state.logp),
        grad=torch.where(accept[:, None], grad_prop, state.grad),
        log_step=state.log_step + adapt_rate * (pooled - target_accept),
        accept_count=state.accept_count + acc), pooled


def mala_sampler(
    key: KeyLike,
    log_prob: Callable,
    init_x: torch.Tensor,
    num_steps: int,
    step_size: float = 0.1,
    target_accept: float = 0.574,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name=None,
    draws: Optional[Sequence] = None,
) -> MALAResult:
    """Run ``num_steps`` MALA sweeps over [C, d] chains: step adaptation
    for the first ``num_adapt`` (default num_steps // 2), then frozen;
    ``samples`` [ceil(T / thin), C, d] when ``keep_samples``."""
    if num_adapt is None:
        num_adapt = num_steps // 2
    gen = None if draws is not None else make_generator(key, init_x.device)
    state = mala_init(log_prob, init_x, step_size)

    def sweep(state, t, adapt, step_draws):
        return mala_step(gen, state, log_prob, target_accept, adapt,
                         axis_name, step_draws)

    final, samples = run_sweeps(sweep, state, num_steps, num_adapt,
                                adapt_rate, keep_samples, thin, draws)
    return MALAResult(
        state=final, samples=samples,
        accept_rate=pooled_mean(final.accept_count / num_steps, axis_name),
        step_size=torch.exp(final.log_step))
