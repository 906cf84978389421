"""Random-walk Metropolis-Hastings over [C, d] chains.

Port of ``cusmc_tpu/mcmc/metropolis.py:27-155``. Each sweep proposes
``x' = x + exp(log_step) (z L')`` (L = ``proposal_chol``, identity when
None) for every chain, accepts on ``log u < log p(x') - log p(x)``, and
adapts ``log_step`` by Robbins-Monro toward ``target_accept`` on the
acceptance pooled over the chains (and over the ranks of ``axis_name``, a
``parallel.mesh.ParticleAxis``-like group, when the chains are sharded).

``noise_dtype=torch.bfloat16`` draws the proposal normals with
``jax.random.normal``'s bfloat16 law (``ops/random.normal``, the
128-value table of ``bf16_normal_table``) and casts them to the state's
type, as the JAX sampler does. The JAX docstring calls this exact by
symmetry (``:81-88``), but that law is not symmetric: its 128 levels have
mean -0.012, so the proposal drifts and a long walk is biased (at d = 128
over 20000 sweeps the coordinates' mean reaches -0.25; ROADMAP section
3). The port keeps JAX's law; float32 noise is exact.

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``init_x``'s device; each sweep draws its normals z [C, d], then its
accept uniforms u [C]. ``draws`` replays given numbers: a sequence of
``(z, u)``, one a sweep (the JAX key schedule: ``kz, ku =
split(fold_in(key, t))``; z in ``noise_dtype``). The sweep loop is
``mcmc/chains.run_sweeps``: a Python loop with no host read.
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
class MHState:
    """``x`` [C, d] positions, ``logp`` [C], ``log_step`` 0-dim log
    proposal scale (shared by the chains), ``accept_count`` [C]."""

    x: torch.Tensor
    logp: torch.Tensor
    log_step: torch.Tensor
    accept_count: torch.Tensor


@dataclass
class MHResult:
    state: MHState
    samples: Optional[torch.Tensor]     # [T, C, d] when keep_samples
    accept_rate: torch.Tensor           # 0-dim, pooled over the chains
    step_size: torch.Tensor             # the final adapted scale


def mh_init(key, log_prob: Callable, init_x: torch.Tensor,
            step_size: float = 0.5) -> MHState:
    """``init_x`` [C, d] the chains' first positions (``key`` is unused,
    as in the JAX function)."""
    del key
    logp = log_prob(init_x)
    return MHState(x=init_x, logp=logp,
                   log_step=log_step_size(step_size, init_x),
                   accept_count=torch.zeros_like(logp))


def proposal_normals(gen, shape, like: torch.Tensor,
                     noise_dtype=None) -> torch.Tensor:
    """Proposal normals of ``shape``, drawn in ``noise_dtype`` (None:
    ``like``'s type) and cast to ``like``'s type."""
    z = normal(gen, shape, noise_dtype or like.dtype, like.device)
    return z.to(like.dtype)


def mh_step(gen: Optional[torch.Generator], state: MHState,
            log_prob: Callable, proposal_chol: Optional[torch.Tensor] = None,
            target_accept: float = 0.234, adapt_rate: float = 0.0,
            axis_name=None, noise_dtype=None, draws=None):
    """One random-walk MH sweep over all chains; ``draws`` = (z, u)
    replaces the draws from ``gen``. Returns ``(state, pooled
    acceptance)``."""
    c, d = state.x.shape
    if draws is None:
        z = proposal_normals(gen, (c, d), state.x, noise_dtype)
        u = accept_uniforms(gen, c, state.x)
    else:
        z, u = draws
        z = z.to(state.x.dtype)
    if proposal_chol is not None:
        z = z @ proposal_chol.T
    x_prop = state.x + torch.exp(state.log_step) * z
    logp_prop = log_prob(x_prop)
    accept = torch.log(u) < (logp_prop - state.logp)
    acc = accept.to(state.x.dtype)
    pooled = pooled_mean(acc, axis_name)
    return MHState(
        x=torch.where(accept[:, None], x_prop, state.x),
        logp=torch.where(accept, logp_prop, state.logp),
        log_step=state.log_step + adapt_rate * (pooled - target_accept),
        accept_count=state.accept_count + acc), pooled


def metropolis_hastings_sampler(
    key: KeyLike,
    log_prob: Callable,
    init_x: torch.Tensor,
    num_steps: int,
    step_size: float = 0.5,
    proposal_chol: Optional[torch.Tensor] = None,
    target_accept: float = 0.234,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name=None,
    noise_dtype=None,
    draws: Optional[Sequence] = None,
) -> MHResult:
    """Run ``num_steps`` MH sweeps over [C, d] chains. The first
    ``num_adapt`` (default num_steps // 2) adapt the scale, which then
    freezes; ``samples`` [ceil(T / thin), C, d] (every ``thin``-th sweep,
    the adaptation phase included) when ``keep_samples``."""
    if num_adapt is None:
        num_adapt = num_steps // 2
    gen = None if draws is not None else make_generator(key, init_x.device)
    state = mh_init(key, log_prob, init_x, step_size)

    def sweep(state, t, adapt, step_draws):
        return mh_step(gen, state, log_prob, proposal_chol, target_accept,
                       adapt, axis_name, noise_dtype, step_draws)

    final, samples = run_sweeps(sweep, state, num_steps, num_adapt,
                                adapt_rate, keep_samples, thin, draws)
    return MHResult(
        state=final, samples=samples,
        accept_rate=pooled_mean(final.accept_count / num_steps, axis_name),
        step_size=torch.exp(final.log_step))
