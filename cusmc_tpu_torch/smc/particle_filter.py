"""Bootstrap particle filter: the packed exp-space main path, on one shard.

Port of ``cusmc_tpu/smc/particle_filter.py``: ``FilterResult`` (``:47``),
``_fast_exp_step_factory`` (``:158-275``, always-resample and
ESS-adaptive), ``packed_exp_resample_op`` (``:278-325``, metropolis with
``num_steps="auto"`` and the ``POSITION_FNS`` family) and the packed path
of ``bootstrap_filter`` (``:604-839``). The T-step ``lax.scan`` becomes a
Python loop; tensors stay on the model's device and the always-resample
loop reads nothing back to the host.

Each step resamples, propagates and reweights, carrying max-normalised
exp-space weights ``w`` instead of log weights (see the JAX docstring for
the evidence algebra and the 88-nat flush of exp-space weights, which the
port shares). The resample goes through the hand-written kernels on a CUDA
device: ``ops/cumsum.blocked_cumsum`` and
``ops/monotone_gather.inverse_cdf_apply`` for the CDF family,
``resampling/rolls.roll_metropolis_sweeps_expspace`` for metropolis.

Randomness comes from one ``torch.Generator``, drawn in a fixed order: the
initial cloud, then per step the resample draws (when it resamples) and
the propagation noise. A step can instead be handed ``draws=(resample
draws, noise)``, which is how the tests replay JAX's numbers.

Not ported yet (``NotImplementedError``, see ROADMAP queue 1): the fused
Pallas engines (``engine="pallas"``), ``layout="batch"``, the residual
resampler, injected ``resample_op``s and the sharded filter
(``axis_name``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator, resolve_device
from cusmc_tpu_torch.diagnostics.metrics import effective_sample_size
from cusmc_tpu_torch.models.base import supports_packed
from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply
from cusmc_tpu_torch.resampling.classic import POSITION_FNS
from cusmc_tpu_torch.resampling.rolls import (
    auto_num_steps,
    roll_metropolis_draws,
    roll_metropolis_sweeps_expspace,
)


@dataclass
class FilterResult:
    """Outputs of one filter run.

    ``particles`` [T, N, d], ``obs_loglik`` [T, N] (unnormalised per-step
    observation log-likelihood), ``ancestors`` [T, N] int32 — None when
    ``return_history=False``. ``ess`` [T], ``log_evidence`` (0-dim), plus
    the final particle cloud [N, d] and its normalised log weights [N].
    """

    final_particles: torch.Tensor
    final_log_weights: torch.Tensor
    ess: torch.Tensor
    log_evidence: torch.Tensor
    particles: Optional[torch.Tensor] = None
    obs_loglik: Optional[torch.Tensor] = None
    ancestors: Optional[torch.Tensor] = None


class ExpResampleOp:
    """Single-shard exp-space resample op: ``draw(gen, w)`` makes the
    draws, ``op(X, w, draws) -> (x_anc, a)`` applies them.

    metropolis: draws are ``(shifts [B], u [B, N])``; the CDF family:
    unit positions [N] in [0, 1) from ``POSITION_FNS``, scaled here by
    the unnormalised cdf total (the search is scale-invariant, so no
    softmax pass)."""

    def __init__(self, resampler_name: str, num_particles: int,
                 num_steps=10, base_steps: int = 10):
        self.name = resampler_name
        self.n = num_particles
        self.num_steps = num_steps
        self.base_steps = base_steps

    def draw(self, gen: Optional[torch.Generator], w: torch.Tensor):
        if self.name == "metropolis":
            b = (auto_num_steps(w, self.base_steps)
                 if self.num_steps == "auto" else self.num_steps)
            return roll_metropolis_draws(gen, self.n, b, w.device, w.dtype)
        return POSITION_FNS[self.name](gen, self.n, w.dtype, w.device)

    def __call__(self, X: torch.Tensor, w: torch.Tensor, draws):
        if self.name == "metropolis":
            shifts, u = draws
            return roll_metropolis_sweeps_expspace(w, shifts, u, X)
        cdf, _ = blocked_cumsum(w)
        return inverse_cdf_apply(cdf, draws * cdf[-1], X)


def packed_exp_resample_op(resampler_name: str, num_particles_global: int,
                           **kwargs) -> ExpResampleOp:
    """The exp-space resample op for a resampler name."""
    if resampler_name == "metropolis":
        return ExpResampleOp("metropolis", num_particles_global,
                             num_steps=kwargs.get("num_steps", 10),
                             base_steps=kwargs.get("base_steps", 10))
    if resampler_name in POSITION_FNS:
        return ExpResampleOp(resampler_name, num_particles_global)
    if resampler_name == "residual":
        raise NotImplementedError(
            "the residual resampler is not ported yet (ROADMAP queue 1, "
            "item 5)")
    raise KeyError(f"no exp-space fast op for resampler {resampler_name!r}")


def _fast_exp_step_factory(model, n_global: int, resample_op: ExpResampleOp,
                           ess_threshold: Optional[float]) -> Callable:
    """The exp-space step ``step(x, w, y_t, gen=None, draws=None) ->
    (x_new, w_new, ess, lz_inc, ll, a)``. ESS-adaptive steps read the
    resample decision back to the host (the JAX ``lax.cond``)."""
    log_n = math.log(n_global)

    def step(x, w, y_t, gen=None, draws=None):
        s1 = torch.sum(w)
        s2 = torch.sum(w * w)
        ess = s1 * s1 / s2
        pred = (ess_threshold is None
                or bool(ess < ess_threshold * n_global))
        if pred:
            res_draws = (draws[0] if draws is not None
                         else resample_op.draw(gen, w))
            x_anc, a = resample_op(x, w, res_draws)
        else:
            x_anc = x
            a = torch.arange(w.shape[0], dtype=torch.int32, device=w.device)
        noise = draws[1] if draws is not None else None
        x_new = model.propagate_packed(gen, x_anc, noise)
        ll = model.observation_logpdf_packed(y_t, x_new)
        m = torch.max(ll)
        w_new = torch.exp(ll - m)
        if ess_threshold is None:
            lz_inc = m + torch.log(torch.sum(w_new)) - log_n
        else:
            if pred:
                denom = torch.full((), float(n_global), dtype=s1.dtype,
                                   device=s1.device)
            else:
                denom = s1
                w_new = w * w_new
            lz_inc = m + torch.log(torch.sum(w_new)) - torch.log(denom)
            # Renormalise by the max so long skip runs cannot creep toward
            # f32 underflow (everything downstream is scale-invariant).
            w_new = w_new / torch.max(w_new)
        return x_new, w_new, ess, lz_inc, ll, a

    return step


def bootstrap_filter(
    key: KeyLike,
    model,
    ys,
    num_particles: int,
    resampler: str = "metropolis",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = None,
    return_history: bool = True,
    layout: str = "auto",
    engine: str = "auto",
    axis_name: Optional[str] = None,
    num_particles_global: Optional[int] = None,
    resample_op: Optional[Callable] = None,
    device=None,
) -> FilterResult:
    """Run the bootstrap filter on observations ``ys`` [T, k]; row 0 is
    ignored (t=0 is the prior draw).

    ``key``: an int seed or a ``torch.Generator`` on the model's device.
    ``device``: where to run; the model must already live there (None ->
    the model's device). ``resampler``: "metropolis" | "systematic" |
    "stratified" | "multinomial". ``ess_threshold=None`` resamples every
    step; a float in (0, 1] resamples when ESS < threshold * N.
    """
    if engine == "pallas":
        raise NotImplementedError(
            "engine='pallas' (the fused Pallas step kernels) is not ported "
            "yet: ROADMAP queue 2, TPU kernels 5 and 6")
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}")
    if layout == "batch":
        raise NotImplementedError("layout='batch' is not ported yet "
                                  "(ROADMAP queue 1, item 6)")
    if layout not in ("auto", "packed"):
        raise ValueError(f"unknown layout {layout!r}")
    if axis_name is not None or (num_particles_global not in
                                 (None, num_particles)):
        raise NotImplementedError("the sharded filter is not ported yet "
                                  "(ROADMAP queue 1, item 15)")
    if resample_op is not None:
        raise NotImplementedError("injected resample ops are not ported yet "
                                  "(ROADMAP queue 1, item 6)")
    if not supports_packed(model):
        raise NotImplementedError("models without packed-layout methods "
                                  "need layout='batch', not ported yet")
    dev = model.device
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"model lives on {dev}, not on {device}")

    n = num_particles
    op = packed_exp_resample_op(resampler, n, **(resampler_kwargs or {}))
    step = _fast_exp_step_factory(model, n, op, ess_threshold)
    gen = make_generator(key, dev)
    wdtype = model.V_chol.dtype
    ys = torch.as_tensor(ys, dtype=wdtype).to(dev)
    num_steps = ys.shape[0]

    x = model.sample_initial_packed(gen, n)
    logw0 = torch.full((n,), -math.log(n), dtype=wdtype, device=dev)
    w = torch.exp(logw0 - torch.max(logw0))  # uniform -> ones
    esss = torch.empty((num_steps - 1,), dtype=wdtype, device=dev)
    lzs = torch.empty((num_steps - 1,), dtype=wdtype, device=dev)
    if return_history:
        xs = torch.empty((num_steps,) + tuple(x.shape), dtype=x.dtype,
                         device=dev)
        lls = torch.empty((num_steps, n), dtype=wdtype, device=dev)
        ancs = torch.empty((num_steps, n), dtype=torch.int32, device=dev)
        xs[0] = x
        lls[0] = logw0  # t=0 raw weight is the uniform 1/N fill
        ancs[0] = torch.arange(n, dtype=torch.int32, device=dev)

    for t in range(1, num_steps):
        x, w, ess, lz_inc, ll, a = step(x, w, ys[t], gen)
        esss[t - 1] = ess
        lzs[t - 1] = lz_inc
        if return_history:
            xs[t] = x
            lls[t] = ll
            ancs[t] = a

    logw_f = torch.log(w) - torch.log(torch.sum(w))
    ess = torch.cat([effective_sample_size(logw0)[None], esss])
    log_evidence = torch.sum(lzs)
    x_f = x.T
    if not return_history:
        return FilterResult(final_particles=x_f, final_log_weights=logw_f,
                            ess=ess, log_evidence=log_evidence)
    return FilterResult(
        final_particles=x_f, final_log_weights=logw_f, ess=ess,
        log_evidence=log_evidence, particles=xs.transpose(1, 2),
        obs_loglik=lls, ancestors=ancs)
