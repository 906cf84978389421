"""Particle marginal Metropolis-Hastings (PMMH): parameter inference for
state-space models.

Port of ``cusmc_tpu/mcmc/pmmh.py:30-94`` (Andrieu, Doucet & Holenstein
2010). The bootstrap filter's unbiased likelihood estimate drives an
exact MH chain over the parameters theta:

    propose theta' ~ N(theta, step_size^2 Sigma)
    run a fresh filter  -> log Zhat(theta')
    accept w.p. min(1, exp(logZ' + logprior' - logZ - logprior))

``model_builder(theta)`` receives theta as a tensor on ``theta0``'s
device and builds the model there on every step (``DLM.create`` takes
card tensors and factors them on the card). Each step runs
``smc/particle_filter.bootstrap_filter`` in full: with its systematic
default on the composed path, every filter run launches the cumsum and
the search-and-apply kernels T-1 times on the card. The accept decision
stays on the device (``torch.where``): the loop reads nothing back.

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``theta0``'s device; the first filter draws from it, then each step its
proposal normals z [p], its filter run and its accept uniform. ``draws``
replays given numbers: ``{"init": the first filter's draws, "steps":
[(z, filter draws, u), ...]}``, a filter's draws in
``bootstrap_filter``'s ``draws=`` layout (the JAX key schedule:
``k_init, k_chain = split(key)``; per step ``kp, kf, ku =
split(fold_in(k_chain, t), 3)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.ops.random import normal
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter


@dataclass
class PMMHResult:
    thetas: torch.Tensor         # [T, p] parameter chain
    log_evidences: torch.Tensor  # [T] the filter logZ at the chain's state
    accept_rate: torch.Tensor    # 0-dim
    final_theta: torch.Tensor    # [p]


def pmmh(
    key: KeyLike,
    model_builder: Callable,
    log_prior: Callable,
    theta0: torch.Tensor,
    ys,
    num_particles: int,
    num_steps: int,
    step_size: float = 0.1,
    proposal_chol: Optional[torch.Tensor] = None,
    resampler: str = "systematic",
    filter_kwargs: Optional[dict] = None,
    draws: Optional[dict] = None,
) -> PMMHResult:
    """Run a PMMH chain of ``num_steps`` steps from ``theta0`` [p] on
    observations ``ys`` [T, k]. ``model_builder(theta [p]) -> model``;
    ``log_prior(theta) -> 0-dim``. Systematic resampling is the default:
    the metropolis resampler's finite-B bias in logZ would leak into the
    parameter posterior."""
    filter_kwargs = dict(filter_kwargs or {})
    filter_kwargs.setdefault("return_history", False)
    dev, dtype = theta0.device, theta0.dtype
    p = theta0.shape[0]
    gen = None if draws is not None else make_generator(key, dev)
    ys = torch.as_tensor(ys, dtype=dtype).to(dev)

    def log_z(theta, filter_draws):
        res = bootstrap_filter(gen, model_builder(theta), ys, num_particles,
                               resampler=resampler, draws=filter_draws,
                               **filter_kwargs)
        return res.log_evidence

    theta = theta0
    lz = log_z(theta, None if draws is None else draws["init"])
    thetas = torch.empty((num_steps, p), dtype=dtype, device=dev)
    lzs = torch.empty((num_steps,), dtype=lz.dtype, device=dev)
    accepts = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(num_steps):
        if draws is None:
            z = normal(gen, (p,), dtype, dev)
        else:
            z, filter_draws, u = draws["steps"][t]
        if proposal_chol is not None:
            z = proposal_chol @ z
        theta_prop = theta + step_size * z
        lz_prop = log_z(theta_prop, None if draws is None else filter_draws)
        if draws is None:
            u = torch.rand((), generator=gen, dtype=dtype, device=dev)
        log_alpha = (lz_prop + log_prior(theta_prop) - lz
                     - log_prior(theta))
        accept = torch.log(u) < log_alpha
        theta = torch.where(accept, theta_prop, theta)
        lz = torch.where(accept, lz_prop, lz)
        accepts = accepts + accept.to(torch.int32)
        thetas[t] = theta
        lzs[t] = lz
    return PMMHResult(thetas=thetas, log_evidences=lzs,
                      accept_rate=accepts / num_steps, final_theta=theta)
