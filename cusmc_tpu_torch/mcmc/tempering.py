"""Parallel tempering (replica exchange) over [R, C, d] replicas.

Port of ``cusmc_tpu/mcmc/tempering.py:36-284``. R rungs sample ``beta_r
log p`` with ``1 = beta_0 > ... > beta_{R-1}``; each sweep is one
tempered random-walk MH sweep over all R C points (one log-density
evaluation) and, when ``t % swap_every == 0``, one even/odd (DEO) pass of
swaps between adjacent rungs, accepted with probability
``min(1, exp((beta_i - beta_j) (logp_j - logp_i)))``. Swaps are
chain-local: rung r takes rung r+1's state (or r-1's) where that pair
accepted, as two selects over the rung axis of two rolls. Per-rung step
sizes adapt by Robbins-Monro toward ``target_accept`` on the acceptance
pooled over the rung's chains (and over the ranks of ``axis_name``, a
``parallel.mesh.ParticleAxis``-like group, when the chains are sharded).
``adapt_ladder=True`` equalises the pairs' swap probabilities by moving
the interior betas (softmax log-spacings, endpoints fixed).

The sweep loop is ``mcmc/chains.run_sweeps``, and t a host int: the
adaptation rate, the swap parity (``(t // swap_every) % 2``) and whether
a swap pass runs are Python branches; nothing is read back from the
device in the loop. The ladder, when given, is checked once on the host
(``betas[0] == 1``, strictly decreasing).

``noise_dtype=torch.bfloat16`` draws the proposal normals with
``jax.random.normal``'s bfloat16 law (``ops/random.normal``), whose mean
is -0.012: the proposal drifts, as for ``mcmc/metropolis.py`` (ROADMAP
section 3).

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``init_x``'s device; each sweep draws its normals z [R, C, d] (in
``noise_dtype``), its accept uniforms [R, C] and, on a sweep that swaps,
the swap uniforms [R-1, C]. ``draws`` replays given numbers: a sequence
of ``(z, u, u_swap)``, one a sweep (``u_swap`` None on a sweep without a
swap pass; the JAX key schedule: ``kz, ku, ks = split(fold_in(key, t),
3)``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.mcmc.chains import run_sweeps
from cusmc_tpu_torch.mcmc.metropolis import proposal_normals
from cusmc_tpu_torch.parallel.mesh import pmean


@dataclass
class PTState:
    """``x`` [R, C, d] replica states (rung 0 is the cold, beta = 1
    chain), ``logp`` [R, C] untempered log-densities, ``log_step`` [R]
    per-rung proposal scales, ``accept_count`` [R] pooled within-rung
    acceptance totals, ``swap_count`` [R-1] pooled accepted-swap totals
    per adjacent pair, ``ladder_s`` [R-1] the ladder's log-spacing
    weights, ``swap_ema`` [R-1] the EMA of each pair's swap
    probability."""

    x: torch.Tensor
    logp: torch.Tensor
    log_step: torch.Tensor
    accept_count: torch.Tensor
    swap_count: torch.Tensor
    ladder_s: torch.Tensor
    swap_ema: torch.Tensor


@dataclass
class PTResult:
    state: PTState
    samples: Optional[torch.Tensor]   # [ceil(T / thin), C, d] cold rung
    accept_rate: torch.Tensor         # [R] within-rung, pooled
    swap_rate: torch.Tensor           # [R-1] per adjacent pair
    step_size: torch.Tensor           # [R] final adapted scales
    betas: torch.Tensor               # [R] the ladder used


def geometric_ladder(num_rungs: int, beta_min: float = 0.1,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """beta_r = beta_min^(r / (R-1)): equal log-spacing."""
    if num_rungs < 2:
        return torch.ones((num_rungs,), dtype=dtype, device=device)
    r = torch.arange(num_rungs, dtype=dtype, device=device) / (num_rungs - 1)
    return torch.tensor(beta_min, dtype=dtype, device=device) ** r


def _check_ladder(betas: torch.Tensor) -> None:
    b = betas.detach().double().cpu()
    if b.numel() and abs(float(b[0]) - 1.0) > 1e-6:
        raise ValueError(f"betas[0] must be 1 (cold chain); got {float(b[0])}")
    if b.numel() > 1 and not bool((torch.diff(b) < 0).all()):
        raise ValueError("betas must be strictly decreasing")


def sweep_draws(gen, shape, like: torch.Tensor, noise_dtype, swap: bool):
    """One sweep's (z, u, u_swap) from ``gen``."""
    r, c, _ = shape
    z = proposal_normals(gen, shape, like, noise_dtype)
    u = torch.rand((r, c), generator=gen, dtype=like.dtype,
                   device=like.device)
    us = (torch.rand((r - 1, c), generator=gen, dtype=like.dtype,
                     device=like.device) if swap and r > 1 else None)
    return z, u, us


def parallel_tempering_sampler(
    key: KeyLike,
    log_prob: Callable,
    init_x: torch.Tensor,
    num_steps: int,
    betas: Optional[torch.Tensor] = None,
    num_rungs: int = 8,
    beta_min: float = 0.1,
    step_size: float = 0.5,
    target_accept: float = 0.234,
    adapt_rate: float = 0.05,
    num_adapt: Optional[int] = None,
    swap_every: int = 1,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name=None,
    noise_dtype=None,
    adapt_ladder: bool = False,
    ladder_lr: float = 0.1,
    init_log_step: Optional[torch.Tensor] = None,
    draws: Optional[Sequence] = None,
) -> PTResult:
    """Run ``num_steps`` PT sweeps. ``init_x`` is [C, d] (broadcast to
    every rung) or [R, C, d]; ``betas`` overrides the geometric ladder of
    ``num_rungs`` rungs down to ``beta_min`` (betas[0] must be 1). The
    step sizes start at ``step_size / sqrt(beta)`` (or ``init_log_step``
    [R], a warm restart's) and adapt for the first ``num_adapt`` sweeps
    (default num_steps // 2), as does the ladder with ``adapt_ladder``.
    Returns the cold rung's samples and per-pair swap rates."""
    dtype, dev = init_x.dtype, init_x.device
    if betas is None:
        betas = geometric_ladder(num_rungs, beta_min, dtype, dev)
    else:
        betas = torch.as_tensor(betas, dtype=dtype).to(dev)
        _check_ladder(betas)
    R = betas.shape[0]
    if init_x.ndim == 2:
        init_x = init_x[None].expand((R,) + tuple(init_x.shape))
    if init_x.shape[0] != R:
        raise ValueError(f"init_x rung axis {init_x.shape[0]} != {R} betas")
    if num_adapt is None:
        num_adapt = num_steps // 2
    _, c, d = init_x.shape
    gen = None if draws is not None else make_generator(key, dev)

    logp0 = log_prob(init_x.reshape(R * c, d)).reshape(R, c)
    if init_log_step is not None:
        log_step = torch.as_tensor(init_log_step, dtype=dtype).to(dev)
    else:
        log_step = torch.log(torch.tensor(step_size, dtype=dtype, device=dev)
                             / torch.sqrt(betas))
    n_pairs = max(R - 1, 0)
    state = PTState(
        x=init_x, logp=logp0, log_step=log_step,
        accept_count=torch.zeros((R,), dtype=dtype, device=dev),
        swap_count=torch.zeros((n_pairs,), dtype=dtype, device=dev),
        # softmax(ladder_s) * log(1 / beta_min) reproduces the initial
        # spacings exactly (s_i = log rho_i up to a constant).
        ladder_s=(torch.log(torch.clamp(
            torch.log(betas[:-1]) - torch.log(betas[1:]), min=1e-6))
            if R > 1 else torch.zeros((0,), dtype=dtype, device=dev)),
        swap_ema=torch.full((n_pairs,), 0.3, dtype=dtype, device=dev))
    total_gap = torch.log(betas[0]) - torch.log(betas[-1]) if R > 1 else None
    parity_of = torch.arange(n_pairs, device=dev) % 2

    def ladder_betas(st):
        if not adapt_ladder or R < 2:
            return betas
        rho = torch.softmax(st.ladder_s, dim=0) * total_gap
        logb = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                          -torch.cumsum(rho, dim=0)])
        return torch.exp(logb)

    def rung_sweep(st, z, u, adapt, bet):
        x_prop = st.x + torch.exp(st.log_step)[:, None, None] * z
        logp_prop = log_prob(x_prop.reshape(R * c, d)).reshape(R, c)
        # The tempered acceptance on beta_r * logp.
        accept = torch.log(u) < bet[:, None] * (logp_prop - st.logp)
        pooled = pmean(torch.mean(accept.to(dtype), dim=1), axis_name)
        return replace(
            st, x=torch.where(accept[..., None], x_prop, st.x),
            logp=torch.where(accept, logp_prop, st.logp),
            log_step=st.log_step + adapt * (pooled - target_accept),
            accept_count=st.accept_count + pooled)

    def swap_pass(st, us, parity, bet, adapt_on):
        """One DEO half-pass over the pairs (r, r+1) with r % 2 ==
        parity."""
        active = parity_of == parity                     # [R-1]
        dbeta = bet[:-1] - bet[1:]                       # [R-1]
        dlogp = st.logp[1:] - st.logp[:-1]               # [R-1, C]
        acc = (torch.log(us) < dbeta[:, None] * dlogp) & active[:, None]
        none = torch.zeros((1, c), dtype=torch.bool, device=dev)
        take_up = torch.cat([acc, none], dim=0)          # r <- r+1
        take_dn = torch.cat([none, acc], dim=0)          # r <- r-1

        def exchange(a):
            up = torch.roll(a, -1, dims=0)
            dn = torch.roll(a, 1, dims=0)
            tu, td = take_up, take_dn
            if a.ndim == 3:
                tu, td = tu[..., None], td[..., None]
            return torch.where(tu, up, torch.where(td, dn, a))

        pooled_sw = pmean(torch.mean(acc.to(dtype), dim=1), axis_name)
        new = replace(st, x=exchange(st.x), logp=exchange(st.logp),
                      swap_count=st.swap_count + pooled_sw)
        if adapt_ladder:
            # The Rao-Blackwellised (expected) swap probability.
            p_sw = pmean(torch.mean(torch.exp(torch.clamp(
                dbeta[:, None] * dlogp, max=0.0)), dim=1), axis_name)
            ema = torch.where(active, 0.9 * st.swap_ema + 0.1 * p_sw,
                              st.swap_ema)
            step = ladder_lr * (ema - torch.mean(ema))
            new = replace(new, ladder_s=st.ladder_s + adapt_on * step,
                          swap_ema=ema)
        return new

    def sweep(state, t, adapt, step_draws):
        swap = R > 1 and t % swap_every == 0
        z, u, us = step_draws or sweep_draws(gen, (R, c, d), init_x,
                                             noise_dtype, swap)
        bet = ladder_betas(state)
        state = rung_sweep(state, z.to(dtype), u, adapt, bet)
        if swap:
            # DEO: even pairs at even swap events, odd pairs at odd ones.
            state = swap_pass(state, us, (t // swap_every) % 2, bet,
                              1.0 if t < num_adapt else 0.0)
        return state, None

    state, kept = run_sweeps(sweep, state, num_steps, num_adapt, adapt_rate,
                             keep_samples, thin, draws,
                             sample=lambda state: state.x[0])

    # Swap events fire at t % swap_every == 0 (t = 0 included); event e
    # has parity e % 2, so even pairs are proposed ceil(E / 2) times and
    # odd pairs E // 2 times.
    n_events = -(-num_steps // swap_every)
    n_lo = max((n_events + 1) // 2, 1)
    n_hi = max(n_events // 2, 1)
    pair_events = torch.where(parity_of == 0, n_lo, n_hi).to(dtype)
    return PTResult(
        state=state, samples=kept,
        accept_rate=state.accept_count / num_steps,
        swap_rate=state.swap_count / pair_events,
        step_size=torch.exp(state.log_step),
        betas=ladder_betas(state))
