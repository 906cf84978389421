"""Auxiliary particle filter (Pitt & Shephard 1999).

Port of ``cusmc_tpu/smc/apf.py:44-119``. A one-step lookahead enters the
first-stage weights, so resampling favours particles that will explain
y_t; the second-stage weight corrects the bias exactly::

    stage 1:  v_i    = logw_i + lambda_i(y_t),   a ~ resample(v)
    stage 2:  x_t    ~ p(. | x_{t-1}^a),  logw_t = log p(y_t | x_t) - lambda_a(y_t)

with lambda ``model.lookahead_logpdf(y, x_prev)`` when the model has it
(the DLM's exact predictive: the fully adapted APF), else the point
lookahead ``observation_logpdf(y, propagate_mean(x_prev))``.

The batch layout [N, d] with a registry resampler and a row gather
``x[a]``, as in the JAX package (XLA there, no Pallas kernel): plain torch
here, with no host read in the loop. The T-step ``lax.scan`` becomes a
Python loop on the model's device.

Randomness comes from one ``torch.Generator`` (``key``: an int seed or a
generator on the run's device), drawn in order: the initial cloud, then
per step the resample and the propagation noise. ``draws`` replays given
numbers instead: ``{"init": noise of model.sample_initial, "steps":
[(resampler keyword draws, noise of model.propagate), ...]}`` for steps
1..T-1 (the JAX key schedule: ``k_init, k_scan = split(key)``; per step
``k_res, k_prop = split(fold_in(k_scan, t))``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cusmc_tpu_torch.device import KeyLike, as_tensor, make_generator
from cusmc_tpu_torch.diagnostics.metrics import effective_sample_size, \
    log_normalize
from cusmc_tpu_torch.models.base import draw
from cusmc_tpu_torch.resampling import get_resampler
from cusmc_tpu_torch.smc.particle_filter import FilterResult, _ancestors, \
    model_device


def step_draws(draws: Optional[dict], gen, t: int):
    """(resample draws, propagation noise) of step t: the generator and
    None, or the replayed entry ``draws["steps"][t - 1]``."""
    if draws is None:
        return gen, None
    return draws["steps"][t - 1]


def auxiliary_filter(
    key: KeyLike,
    model,
    ys,
    num_particles: int,
    resampler: str = "systematic",
    resampler_kwargs: Optional[dict] = None,
    return_history: bool = True,
    device=None,
    draws: Optional[dict] = None,
) -> FilterResult:
    """Run the APF on observations ``ys`` [T, k] (row 0 is the prior
    step). ``device``: as in ``bootstrap_filter`` (the model's device; None
    for a model without one means the card). The history stores the
    second-stage log-weights ``ll - look[a]`` as ``obs_loglik``, from which
    posterior means and FFBS rebuild the filter weights."""
    if hasattr(model, "lookahead_logpdf"):
        lookahead = model.lookahead_logpdf
    elif hasattr(model, "propagate_mean"):
        def lookahead(y, x):
            return model.observation_logpdf(y, model.propagate_mean(x))
    else:
        raise ValueError("auxiliary_filter needs model.lookahead_logpdf "
                         "or model.propagate_mean")
    res_fn = get_resampler(resampler, **(resampler_kwargs or {}))
    n = num_particles
    log_n = math.log(n)
    dev = model_device(model, device)
    gen = make_generator(key, dev)

    x = draw(model.sample_initial, gen, (n,),
             noise=None if draws is None else draws["init"])
    wdtype = torch.promote_types(x.dtype, torch.float32)
    ys = as_tensor(ys, dtype=wdtype, device=dev)
    num_steps = ys.shape[0]
    logw0 = torch.full((n,), -log_n, dtype=wdtype, device=dev)
    logw = logw0
    esss = torch.empty(num_steps, dtype=wdtype, device=dev)
    lzs = torch.empty(num_steps - 1, dtype=wdtype, device=dev)
    esss[0] = effective_sample_size(logw0)
    if return_history:
        xs = torch.empty((num_steps,) + tuple(x.shape), dtype=x.dtype,
                         device=dev)
        lls = torch.empty((num_steps, n), dtype=wdtype, device=dev)
        ancs = torch.empty((num_steps, n), dtype=torch.int32, device=dev)
        xs[0], lls[0] = x, logw0
        ancs[0] = torch.arange(n, dtype=torch.int32, device=dev)

    for t in range(1, num_steps):
        res_d, prop_d = step_draws(draws, gen, t)
        y = ys[t]
        esss[t] = effective_sample_size(logw)
        look = lookahead(y, x)
        v = logw + look
        lse_v = torch.logsumexp(v, dim=0)
        a = _ancestors(res_fn, v - lse_v, res_d)
        al = a.long()
        x = draw(model.propagate, gen, x[al], noise=prop_d)
        logw_raw = model.observation_logpdf(y, x) - look[al]
        logw, lse_w = log_normalize(logw_raw)
        lzs[t - 1] = lse_v + lse_w - log_n
        if return_history:
            xs[t], lls[t], ancs[t] = x, logw_raw, a
    out = FilterResult(final_particles=x, final_log_weights=logw, ess=esss,
                       log_evidence=torch.sum(lzs))
    if return_history:
        out.particles, out.obs_loglik, out.ancestors = xs, lls, ancs
    return out
