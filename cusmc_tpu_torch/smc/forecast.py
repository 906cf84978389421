"""k-step-ahead predictive simulation from a filtered particle cloud.

Port of ``cusmc_tpu/smc/forecast.py:25-58``: the posterior predictive
p(x_{T+h}, y_{T+h} | y_{1:T}) sampled exactly, by drawing ancestors from
the weighted final cloud and rolling the model's transition and
observation samplers forward ``horizon`` steps (a Python loop where the
JAX package has a ``lax.scan``). Works with any model exposing
``propagate(gen, x)`` and ``sample_observation(gen, x)`` over batched
[..., d] states (the DLM, stochastic volatility).

The ancestors of a weighted cloud are ``jax.random.categorical``'s law
(``ops/random.categorical``: an argmax of the log-weights plus Gumbel
noise, an [M, N] draw made in blocks). ``draws`` replays given numbers
(the JAX key schedule: ``k_anc, k_scan = split(key)``; per step ``kp, ko
= split(k_h)``): ``{"anc": the Gumbel noise [M, N] (weights given) or the
indices [M] (uniform weights, M < N), "steps": [(noise of propagate,
noise of sample_observation), ...]}``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.models.base import draw
from cusmc_tpu_torch.ops.random import categorical


def forecast(key: KeyLike, model, particles: torch.Tensor,
             log_weights: Optional[torch.Tensor], horizon: int,
             num_draws: Optional[int] = None,
             draws: Optional[dict] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``num_draws`` (None: N) predictive trajectories of length
    ``horizon`` from the cloud ``particles`` [N, d] with ``log_weights``
    [N] (None: uniform), on the cloud's device. Returns ``(xs [H, M, d],
    ys [H, M, k])``, equally weighted draws of the joint posterior
    predictive."""
    n = particles.shape[0]
    m = n if num_draws is None else num_draws
    gen = make_generator(key, particles.device)
    anc = None if draws is None else draws["anc"]
    if log_weights is None:
        if m == n:
            x = particles
        else:
            idx = anc if anc is not None else torch.randint(
                0, n, (m,), generator=gen, device=particles.device)
            x = particles[idx.long()]
    else:
        x = particles[categorical(gen, log_weights, m, noise=anc)]
    xs, ys = [], []
    for h in range(horizon):
        prop_d, obs_d = (None, None) if draws is None else draws["steps"][h]
        x = draw(model.propagate, gen, x, noise=prop_d)
        xs.append(x)
        ys.append(draw(model.sample_observation, gen, x, noise=obs_d))
    return torch.stack(xs), torch.stack(ys)
