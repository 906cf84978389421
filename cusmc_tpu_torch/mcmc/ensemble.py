"""Affine-invariant ensemble sampler (the Goodman & Weare 2010 stretch
move, the ``emcee`` algorithm).

Port of ``cusmc_tpu/mcmc/ensemble.py:37-101``. The ensemble updates in
two half-batches, each proposing against the other, frozen, half: walker
i of one half stretches toward a random partner j of the other,

    y = x_j + z (x_i - x_j),   z = ((a - 1) u + 1)^2 / a,

accepted with probability min(1, z^(d-1) p(y) / p(x_i)). One sweep is two
vectorised [W/2, d] updates, two log-density evaluations of W/2 points.

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``init_x``'s device. Each half-update draws its stretch uniforms u [W/2],
its partners j [W/2] (uniform over the other half, the law of
``jax.random.randint``) and its accept uniforms [W/2], in that order, the
first half before the second. ``draws`` replays given numbers: a sequence
of ``((u, j, v), (u, j, v))``, one a sweep, the two halves' draws (the
JAX key schedule: ``k1, k2 = split(fold_in(key, t))``, each half's key
split as ``kz, kj, ku``). The sweep loop is ``mcmc/chains.run_sweeps``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.mcmc.chains import run_sweeps


@dataclass
class EnsembleResult:
    x: torch.Tensor                  # [W, d] final walkers
    samples: Optional[torch.Tensor]  # [ceil(T / thin), W, d]
    accept_rate: torch.Tensor        # 0-dim


def half_draws(gen, half: int, like: torch.Tensor):
    """One half-update's (stretch uniforms, partners, accept uniforms)."""
    dev, dtype = like.device, like.dtype
    u = torch.rand((half,), generator=gen, dtype=dtype, device=dev)
    j = torch.randint(0, half, (half,), generator=gen, device=dev)
    v = torch.rand((half,), generator=gen, dtype=dtype, device=dev)
    return u, j, v


def stretch_move_sampler(
    key: KeyLike,
    log_prob: Callable,
    init_x: torch.Tensor,
    num_steps: int,
    a: float = 2.0,
    keep_samples: bool = True,
    thin: int = 1,
    draws: Optional[Sequence] = None,
) -> EnsembleResult:
    """Run ``num_steps`` stretch-move sweeps over [W, d] walkers. ``a`` is
    the stretch scale (2.0, the universal default). W must be even and at
    least 2d + 2 (Goodman & Weare: the ensemble must span the proposal
    space)."""
    w, d = init_x.shape
    if w % 2 or w < 2 * d + 2:
        raise ValueError(
            f"stretch move needs an EVEN walker count >= 2d+2 "
            f"(got W={w}, d={d})")
    half = w // 2
    dtype = init_x.dtype
    gen = None if draws is not None else make_generator(key, init_x.device)

    def half_update(step_draws, x_mine, logp_mine, x_other):
        u, j, v = step_draws or half_draws(gen, half, x_mine)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        partner = x_other[j.long()]
        y = partner + z[:, None] * (x_mine - partner)
        logp_y = log_prob(y)
        log_alpha = (d - 1.0) * torch.log(z) + logp_y - logp_mine
        accept = torch.log(v) < log_alpha
        return (torch.where(accept[:, None], y, x_mine),
                torch.where(accept, logp_y, logp_mine),
                torch.mean(accept.to(dtype)))

    def sweep(state, t, adapt, step_draws):
        x, logp, acc_sum = state
        da, db = step_draws or (None, None)
        xa, la, acc_a = half_update(da, x[:half], logp[:half], x[half:])
        xb, lb, acc_b = half_update(db, x[half:], logp[half:], xa)
        return (torch.cat([xa, xb], dim=0), torch.cat([la, lb], dim=0),
                acc_sum + 0.5 * (acc_a + acc_b)), None

    start = (init_x, log_prob(init_x),
             torch.zeros((), dtype=dtype, device=init_x.device))
    (x, _, acc_sum), samples = run_sweeps(
        sweep, start, num_steps, 0, 0.0, keep_samples, thin, draws,
        sample=lambda state: state[0])
    return EnsembleResult(x=x, samples=samples,
                          accept_rate=acc_sum / num_steps)
