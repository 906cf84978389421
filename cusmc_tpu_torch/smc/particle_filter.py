"""Bootstrap particle filter: the packed exp-space path, the generic
log-space step, the fused engines, one shard or many.

Port of ``cusmc_tpu/smc/particle_filter.py``: ``FilterResult`` (``:47``),
``_step_factory`` (``:66-155``, the generic step), ``_fast_exp_step_factory``
(``:158-275``, always-resample and ESS-adaptive, on one shard or over a
particle axis), ``packed_exp_resample_op`` (``:278-334``, metropolis with
``num_steps="auto"``, the ``POSITION_FNS`` family and residual),
``_residual_resample_packed`` (``:417-463``), ``local_resample_op`` and
``packed_resample_op`` (``:466-535``) and ``bootstrap_filter`` (``:604-839``,
its layout and engine checks line by line). The T-step ``lax.scan``
becomes a Python loop; tensors stay on the model's device and the
always-resample fast loop reads nothing back to the host.

The fast step resamples, propagates and reweights, carrying max-normalised
exp-space weights ``w`` instead of log weights (see the JAX docstring for
the evidence algebra and the 88-nat flush of exp-space weights, which the
port shares). The resample goes through the hand-written kernels on a CUDA
device: ``ops/cumsum.blocked_cumsum`` and
``ops/monotone_gather.inverse_cdf_apply`` for the CDF family and (twice a
step) for residual, ``resampling/rolls.roll_metropolis_sweeps_expspace``
for metropolis.

The generic step carries normalised log weights and resamples through an
op object (``draw(streams, logw)``, then ``op(x, logw, draws) -> (x_anc,
logw_after, a)``). It serves everything outside the fast path, as in the
JAX package: ``layout="batch"`` (the registry's ancestor functions and a
row gather, plain torch, ``local_resample_op``), models without packed
methods (``models.base.CustomSSM``; ``layout="auto"`` picks "batch" for
them and for an injected ``resample_op``), injected log-space ops,
``debug_checks=True`` (a weight guard that prints, one host read a step)
and, in the packed layout, ``packed_resample_op``: the roll kernel on
``exp(logw - max)`` for metropolis, the cumsum and the search-and-apply
kernels on the softmax for the CDF family and residual, and the
take-columns kernel after the registry's ancestor function for any other
key. Its results stay in the chosen layout: batch particles are [T, N, d]
as drawn. Model hooks that declare a parameter ``t`` (time-varying models)
receive the step, 1..T-1, in both steps (``models.base.normalize_time_hook``).

Randomness on one shard comes from one ``torch.Generator``, drawn in a
fixed order: the initial cloud, then per step the resample draws (when it
resamples) and the propagation noise; both steps draw alike, so the fast
and the generic metropolis paths draw the same numbers. A step can instead
be handed ``draws=(resample draws, noise)``, which is how the tests replay
JAX's numbers (a registry resampler's draws are the keyword arguments of
its ancestor function, e.g. ``{"u": u}``).

The sharded filter (``axis_name``, a ``parallel.mesh.ParticleAxis``) runs
these same steps on each rank's block of ``num_particles`` of
``num_particles_global`` particles, with an injected op of
``parallel/resampling.py`` (exp-space ops in the packed layout, the
all-gather op with log weights in the batch layout): the weight sums are
all-reduced (``psum``, ``pmax``), the resample decision of the
ESS-adaptive step comes from the reduced ESS (so every rank takes the same
branch), ancestors are global, and each rank draws from the two streams of
``parallel.mesh`` (the rank stream for its initial cloud and noise).
Without an injected op, a sharded run resamples each shard locally, as the
JAX package does.

``engine="pallas"`` (``:538-601``, ``:337-414``, ``:662-793``) runs one
fused kernel per step: ``ops/fused_step`` (windowed Metropolis; the step
carries normalised log weights) or ``ops/fused_cdf_step`` (systematic and
stratified; the step carries exp-space weights and runs ``blocked_cumsum``
first). Their draws per step are ``(s, seed)`` or ``(u, seed)``, and the
kernels make their own noise. ``engine="xla"`` is the composed path above,
and ``"auto"`` always takes it: the windowed proposal is biased at finite
B and the fused CDF step was never faster on the TPU (``:680-716``). As in
the JAX package, the fused Metropolis step ignores ``debug_checks`` and the
fused CDF step refuses it. ``pallas_interpret`` is TPU-only and not
ported: on a CPU tensor the fused ops run their plain versions.

Mixed precision (a DLM with ``state_dtype=torch.bfloat16``): the state,
its history and the resample's gathers are bfloat16; the weights, ESS,
evidence and log-likelihoods stay float32 (``:776-777``). Both engines
take it for metropolis, and ``engine="xla"`` for every resampler; the
fused CDF step refuses it, as in the JAX package.

Tracing (``utils.timing``): ``bootstrap_filter`` opens the run's spans
and ``scan_steps`` one ``cusmc.filter.step`` a step, which stores the
step's ESS and increment; every other kernel of a step is in exactly one
of its phases: ``cusmc.normalize`` twice
(the carried weights' ESS at the start; the max, exp and sums, the
evidence increment and the renormalisation at the end),
``cusmc.resample`` (the ESS-adaptive decision, the draws, the resample op;
the fused CDF step's cumsum), ``cusmc.propagate``, ``cusmc.likelihood``,
or in the fused steps ``cusmc.fused_step`` (the kernel's draws and call).
Every read back to the host goes through ``host_scalar``: the
ESS-adaptive decision once a step, the fused steps' log-normaliser once
a run, ``num_steps="auto"``'s ratio once a resample.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator, resolve_device
from cusmc_tpu_torch.diagnostics.metrics import (
    effective_sample_size,
    log_normalize,
)
from cusmc_tpu_torch.models.base import normalize_time_hook, supports_packed
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
from cusmc_tpu_torch.ops.fused_cdf_step import (
    DEFAULT_SROWS,
    cdf_auto_tile,
    fused_cdf_filter_step,
    fused_cdf_filter_step_draws,
)
from cusmc_tpu_torch.ops.fused_step import (
    MAX_MXU_DIM,
    auto_tile,
    fused_filter_step,
    fused_filter_step_draws,
)
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
    take_columns
from cusmc_tpu_torch.parallel.mesh import (
    Streams,
    global_slots,
    make_streams,
    pmax,
    psum,
)
from cusmc_tpu_torch.resampling.classic import (
    POSITION_FNS,
    capped_residual_values,
    residual_draws,
    roll_right,
)
from cusmc_tpu_torch.resampling import get_resampler
from cusmc_tpu_torch.resampling.rolls import (
    auto_num_steps,
    roll_metropolis_draws,
    roll_metropolis_resample_op,
    roll_metropolis_sweeps_expspace,
)
from cusmc_tpu_torch.utils.debug import assert_finite_weights, \
    nan_checks_enabled, raise_on_nan
from cusmc_tpu_torch.utils.timing import host_scalar, named_scope, \
    span_sequence


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
    """Single-shard exp-space resample op: ``draw(streams, w)`` makes the
    draws (from ``streams.rank``), ``op(X, w, draws) -> (x_anc, a)``
    applies them.

    metropolis: draws are ``(shifts [B], u [B, N])``; the CDF family:
    unit positions [N] in [0, 1) from ``POSITION_FNS``, scaled here by
    the unnormalised cdf total (the search is scale-invariant, so no
    softmax pass); residual: N+1 uniforms in [tiny, 1), the weights scaled
    to sum to N here."""

    def __init__(self, resampler_name: str, num_particles: int,
                 num_steps=10, base_steps: int = 10):
        self.name = resampler_name
        self.n = num_particles
        self.num_steps = num_steps
        self.base_steps = base_steps

    def draw(self, streams: Streams, w: torch.Tensor):
        gen = streams.rank
        if self.name == "metropolis":
            b = (auto_num_steps(w, self.base_steps)
                 if self.num_steps == "auto" else self.num_steps)
            return roll_metropolis_draws(gen, self.n, b, w.device, w.dtype)
        if self.name == "residual":
            return residual_draws(gen, self.n, w.dtype, w.device)
        return POSITION_FNS[self.name](gen, self.n, w.dtype, w.device)

    def __call__(self, X: torch.Tensor, w: torch.Tensor, draws):
        if self.name == "metropolis":
            shifts, u = draws
            return roll_metropolis_sweeps_expspace(w, shifts, u, X)
        if self.name == "residual":
            scale = torch.full((), float(self.n), dtype=w.dtype,
                               device=w.device) / torch.sum(w)
            return _residual_resample_packed(X, w * scale, draws)
        cdf, _ = blocked_cumsum(w)
        return inverse_cdf_apply(cdf, draws * cdf[-1], X)


def packed_exp_resample_op(resampler_name: str, num_particles_global: int,
                           **kwargs) -> ExpResampleOp:
    """The exp-space resample op for a resampler name."""
    if resampler_name == "metropolis":
        return ExpResampleOp("metropolis", num_particles_global,
                             num_steps=kwargs.get("num_steps", 10),
                             base_steps=kwargs.get("base_steps", 10))
    if resampler_name in POSITION_FNS or resampler_name == "residual":
        return ExpResampleOp(resampler_name, num_particles_global)
    raise KeyError(f"no exp-space fast op for resampler {resampler_name!r}")


def _residual_resample_packed(X: torch.Tensor, nw: torch.Tensor,
                              u: torch.Tensor):
    """Residual resampling of packed X [d, n] from pre-scaled weights
    ``nw`` [n] (n w / sum w) and n+1 uniforms ``u``: two inverse-CDF
    kernel passes (the floor-count grid and the remainder order
    statistics, capped by ``capped_residual_values``) and a roll right by
    n_det as a device index map, so n_det is never read back to the host.
    Returns ``(x_anc [d, n], ancestors [n])``."""
    n = nw.shape[0]
    counts = torch.floor(nw)
    ccum, _ = blocked_cumsum(counts)
    n_det = torch.clamp(ccum[-1], max=n).to(torch.int32)
    rcdf, _ = blocked_cumsum(torch.clamp(nw - counts, min=0.0))
    slots = torch.arange(n, dtype=nw.dtype, device=nw.device)
    # Deterministic queries clamped inside the active range; the slots
    # past n_det are masked below.
    p_det = torch.minimum(slots + 0.5, n_det.to(nw.dtype) - 0.5)
    x_det, a_det = inverse_cdf_apply(ccum, p_det, X)
    x_res, a_res = inverse_cdf_apply(
        rcdf, capped_residual_values(u, n_det, rcdf[-1]), X)
    # Remainder draw k belongs to slot n_det + k: roll right by n_det.
    idx = roll_right(n, n_det)
    mask = slots < n_det
    a = torch.where(mask, a_det, a_res[idx])
    x_anc = torch.where(mask[None, :], x_det, x_res[:, idx])
    return x_anc, a


def _ancestors(fn: Callable, logw: torch.Tensor, draws) -> torch.Tensor:
    """A registry resampler's ancestors: ``draws`` is the generator it
    draws from, or the keyword arguments of its draws (a replay)."""
    if isinstance(draws, dict):
        return fn(None, logw, **draws)
    return fn(draws, logw)


def _uniform_logw(logw: torch.Tensor, n_global: int) -> torch.Tensor:
    return torch.full(logw.shape, -math.log(n_global), dtype=logw.dtype,
                      device=logw.device)


class LocalResampleOp:
    """Batch-layout op from a registry resampler ``fn(gen, logw) -> a``:
    ``(x[a], -log N, a)`` for x [N, d]. Its draws come from the common
    stream (the JAX step's resample key is common to the shards)."""

    def __init__(self, resampler: Callable, num_particles_global: int):
        self.fn = resampler
        self.n = num_particles_global

    def draw(self, streams: Streams, logw: torch.Tensor):
        return streams.common

    def __call__(self, x: torch.Tensor, logw: torch.Tensor, draws):
        a = _ancestors(self.fn, logw, draws)
        return x[a.long()], _uniform_logw(logw, self.n), a


def local_resample_op(resampler: Callable,
                      num_particles_global: int) -> LocalResampleOp:
    """The batch-layout resample op of a (gen, logw) -> ancestors fn."""
    return LocalResampleOp(resampler, num_particles_global)


class PackedResampleOp:
    """Packed-layout [d, N] op of the generic step for a registry key other
    than metropolis: the CDF family (positions of ``POSITION_FNS`` against
    the blocked cumsum of the softmax, ``inverse_cdf_apply``), residual (N
    times the softmax into ``_residual_resample_packed``), or any other key
    (its registry ancestor function, then ``take_columns`` on ancestors in
    any order). Returns ``(X[:, a], -log N, a)``; draws from the common
    stream."""

    def __init__(self, name: str, num_particles_global: int, **kwargs):
        self.name = name
        self.n = num_particles_global
        self.fn = (None if name in POSITION_FNS or name == "residual"
                   else get_resampler(name, **kwargs))

    def draw(self, streams: Streams, logw: torch.Tensor):
        gen = streams.common
        if self.fn is not None:
            return gen
        wdt = torch.promote_types(logw.dtype, torch.float32)
        if self.name == "residual":
            return residual_draws(gen, logw.shape[0], wdt, logw.device)
        return POSITION_FNS[self.name](gen, logw.shape[0], wdt, logw.device)

    def __call__(self, X: torch.Tensor, logw: torch.Tensor, draws):
        if self.fn is not None:
            a = _ancestors(self.fn, logw, draws)
            return take_columns(X, a), _uniform_logw(logw, self.n), a
        n = logw.shape[0]
        p = torch.softmax(logw.to(torch.promote_types(logw.dtype,
                                                      torch.float32)), 0)
        if self.name == "residual":
            x_anc, a = _residual_resample_packed(X, n * p, draws)
        else:
            cdf, _ = blocked_cumsum(p)
            x_anc, a = inverse_cdf_apply(cdf, draws, X)
        return x_anc, _uniform_logw(logw, self.n), a


def packed_resample_op(resampler_name: str, num_particles_global: int,
                       **kwargs):
    """The packed-layout log-space op of a registry key: the roll op for
    metropolis (``resampling/rolls.roll_metropolis_resample_op``), else
    ``PackedResampleOp``. An unknown key raises ``KeyError``."""
    if resampler_name == "metropolis":
        return roll_metropolis_resample_op(
            num_particles=num_particles_global, **kwargs)
    return PackedResampleOp(resampler_name, num_particles_global, **kwargs)


def _propagate(fn: Callable, x: torch.Tensor, t, streams, draws):
    """A normalised propagate hook on its own draws (the rank stream) or,
    given ``draws``, on the replayed noise ``draws[1]``."""
    if draws is None:
        return fn(streams.rank, x, t)
    return fn(None, x, t, noise=draws[1])


def _step_factory(propagate_fn: Callable, logpdf_fn: Callable, resample_op,
                  ess_threshold: Optional[float], n_global: int, axis=None,
                  debug_checks: bool = False) -> Callable:
    """The generic log-space step ``step(x, logw, y_t, streams=None,
    draws=None, t=None) -> (x_new, logw_new, ess, lz_inc, ll, a)``, for
    any layout: ``x`` is whatever ``propagate_fn`` and ``resample_op``
    take. An ESS-adaptive step reads its decision back to the host (every
    rank reads the same all-reduced ESS); skipping keeps ``x``, ``logw``
    and the identity ancestry in global slots. ``debug_checks`` prints the
    weight guard (``utils.debug.assert_finite_weights``)."""
    propagate_fn = normalize_time_hook(propagate_fn, "x")
    logpdf_fn = normalize_time_hook(logpdf_fn, "y")

    def step(x, logw, y_t, streams=None, draws=None, t=None):
        phase = span_sequence()
        if phase:
            phase("cusmc.normalize")
        ess = effective_sample_size(logw, axis)
        if phase:
            phase("cusmc.resample")
        if ess_threshold is None or host_scalar(
                ess < ess_threshold * n_global):
            res_draws = (draws[0] if draws is not None
                         else resample_op.draw(streams, logw))
            x_anc, logw_pre, a = resample_op(x, logw, res_draws)
        else:
            x_anc, logw_pre = x, logw
            a = global_slots(logw.shape[0], axis, logw.device)
        if phase:
            phase("cusmc.propagate")
        x_new = _propagate(propagate_fn, x_anc, t, streams, draws)
        if phase:
            phase("cusmc.likelihood")
        ll = logpdf_fn(y_t, x_new, t)
        if phase:
            phase("cusmc.normalize")
        logw_new, lz_inc = log_normalize(logw_pre + ll, axis)
        if debug_checks:
            assert_finite_weights(logw_new, t)
        if phase:
            phase(None)
        return x_new, logw_new, ess, lz_inc, ll, a

    return step


def _fast_exp_step_factory(model, n_global: int, resample_op,
                           ess_threshold: Optional[float],
                           axis=None) -> Callable:
    """The exp-space step ``step(x, w, y_t, streams=None, draws=None,
    t=None) -> (x_new, w_new, ess, lz_inc, ll, a)`` over the model's packed
    methods. ESS-adaptive steps read the resample decision back to the
    host (the JAX ``lax.cond``). ``axis``: the particle axis of a sharded
    run (the sums and maxima are then all-reduced over it, so every rank
    computes the same ESS and takes the same branch), None for one shard.
    ``resample_op(x, w, draws)`` returns ``(x_anc, a)`` or ``(x_anc, w_pre,
    a)``."""
    log_n = math.log(n_global)
    propagate_fn = normalize_time_hook(model.propagate_packed, "x")
    logpdf_fn = normalize_time_hook(model.observation_logpdf_packed, "y")

    def step(x, w, y_t, streams=None, draws=None, t=None):
        phase = span_sequence()
        if phase:
            phase("cusmc.normalize")
        s1 = torch.sum(w)
        s2 = torch.sum(w * w)
        if axis is not None:
            s1, s2 = axis.psum(torch.stack([s1, s2])).unbind()
        ess = s1 * s1 / s2
        if phase:
            phase("cusmc.resample")
        pred = (ess_threshold is None
                or host_scalar(ess < ess_threshold * n_global))
        if pred:
            res_draws = (draws[0] if draws is not None
                         else resample_op.draw(streams, w))
            out = resample_op(x, w, res_draws)
            x_anc, a = out[0], out[-1]
        else:  # identity ancestry, in global indices
            x_anc = x
            a = global_slots(w.shape[0], axis, w.device)
        if phase:
            phase("cusmc.propagate")
        x_new = _propagate(propagate_fn, x_anc, t, streams, draws)
        if phase:
            phase("cusmc.likelihood")
        ll = logpdf_fn(y_t, x_new, t)
        if phase:
            phase("cusmc.normalize")
        m = pmax(torch.max(ll), axis)
        w_new = torch.exp(ll - m)
        if ess_threshold is None:
            lz_inc = m + torch.log(psum(torch.sum(w_new), axis)) - log_n
        else:
            if pred:
                denom = torch.full((), float(n_global), dtype=s1.dtype,
                                   device=s1.device)
            else:
                denom = s1
                w_new = w * w_new
            lz_inc = (m + torch.log(psum(torch.sum(w_new), axis))
                      - torch.log(denom))
            # Renormalise by the max so long skip runs cannot creep toward
            # f32 underflow (everything downstream is scale-invariant).
            w_new = w_new / pmax(torch.max(w_new), axis)
        if phase:
            phase(None)
        return x_new, w_new, ess, lz_inc, ll, a

    return step


def _fused_factors(model: DLM):
    """The fused kernels' model arguments: contiguous (G, Q = W_sqrt, F,
    Li = V_chol_inv), df (None for MVN) and the observation log-normaliser
    as floats (one read-back, when the step is built)."""
    mats = tuple(m.contiguous() for m in (model.G, model.W_sqrt, model.F,
                                          model.V_chol_inv))
    df = model.df_value if model.noise == "mvt" else None
    return mats, df, host_scalar(model.log_norm)


def _pallas_step_factory(model: DLM, num_particles: int, tile: int,
                         num_sweeps: int, num_window_tiles: int = 2
                         ) -> Callable:
    """The step around the fused windowed-Metropolis kernel
    (``ops/fused_step.py``): ``step(x, logw, y_t, streams=None, draws=None,
    t=None) -> (x_new, logw_new, ess, lz_inc, ll, a)``, carrying normalised
    log weights; ``draws = (s, seed)``; the DLM takes no ``t``. Always
    resamples, so the evidence increment is ``logsumexp(ll) - log N``."""
    if not isinstance(num_sweeps, int):
        raise ValueError(f"engine='pallas' needs an integer num_steps, got "
                         f"{num_sweeps!r}")
    (G, Q, F, Li), df, log_norm = _fused_factors(model)
    log_n = math.log(num_particles)

    def step(x, logw, y_t, streams=None, draws=None, t=None):
        phase = span_sequence()
        if phase:
            phase("cusmc.normalize")
        ess = effective_sample_size(logw)
        if phase:
            phase("cusmc.fused_step")
        if draws is None:
            draws = fused_filter_step_draws(streams.rank, num_particles, tile,
                                            x.device)
        x_new, ll, a = fused_filter_step(
            x, logw, y_t, G, Q, F, Li, df, log_norm, draws,
            noise=model.noise, num_sweeps=num_sweeps, tile=tile,
            df_int=model.df_int, num_window_tiles=num_window_tiles)
        if phase:
            phase("cusmc.normalize")
        logw_new, lse = log_normalize(ll)
        lz_inc = lse - log_n
        if phase:
            phase(None)
        return x_new, logw_new, ess, lz_inc, ll, a

    return step


def _fused_cdf_step_factory(model: DLM, num_particles: int, pos_mode: str,
                            tile: Optional[int], sr: int) -> Callable:
    """The step around the fused inverse-CDF kernel
    (``ops/fused_cdf_step.py``): ``step(x, w, y_t, streams=None,
    draws=None, t=None)`` with the exp-space carry and evidence algebra of
    ``_fast_exp_step_factory``; ``draws = (u, seed)``. Outside the kernel
    a step runs the blocked cumsum and the weight reductions."""
    (G, Q, F, Li), df, log_norm = _fused_factors(model)
    log_n = math.log(num_particles)

    def step(x, w, y_t, streams=None, draws=None, t=None):
        phase = span_sequence()
        if phase:
            phase("cusmc.normalize")
        s1 = torch.sum(w)
        s2 = torch.sum(w * w)
        ess = s1 * s1 / s2
        if phase:
            phase("cusmc.resample")
        cdf, _ = blocked_cumsum(w)
        if phase:
            phase("cusmc.fused_step")
        if draws is None:
            draws = fused_cdf_filter_step_draws(streams.rank, x.device)
        x_new, ll, a = fused_cdf_filter_step(
            cdf, x, y_t, G, Q, F, Li, df, log_norm, draws,
            noise=model.noise, mode=pos_mode, tile=tile, sr=sr,
            df_int=model.df_int)
        if phase:
            phase("cusmc.normalize")
        m = torch.max(ll)
        w_new = torch.exp(ll - m)
        lz_inc = m + torch.log(torch.sum(w_new)) - log_n
        if phase:
            phase(None)
        return x_new, w_new, ess, lz_inc, ll, a

    return step


def _fused_model_ok(model, bf16_ok: bool = False) -> bool:
    """A DLM within the kernels' dimension cap with one chi-square a
    particle (no ``per_dim_chi``); MVT with df >= 2 (the in-kernel
    Marsaglia-Tsang sampler has no alpha < 1 boost); a float32 state, or
    with ``bf16_ok`` a bfloat16 one at even d."""
    if not (isinstance(model, DLM)
            and max(model.state_dim, model.obs_dim) <= MAX_MXU_DIM
            and not model.per_dim_chi
            and (model.state_dtype == torch.float32
                 or (bf16_ok and model.state_dtype == torch.bfloat16
                     and model.state_dim % 2 == 0))):
        return False
    return model.noise != "mvt" or model.df_value >= 2.0


def _pallas_eligible(model, n: int, tile: int) -> bool:
    """``particle_filter.py:577-601``: a float32 or bfloat16 state."""
    return (_fused_model_ok(model, bf16_ok=True) and n % tile == 0
            and n >= 2 * tile and tile % 128 == 0)


def _fused_cdf_eligible(model, n: int) -> bool:
    """``particle_filter.py:389-414``: the model check (float32 only), and
    N divisible by the auto tile, large enough for the window walk, at
    most 2^24."""
    if not _fused_model_ok(model):
        return False
    tile = cdf_auto_tile(n, max(model.state_dim, model.obs_dim))
    return (n % tile == 0 and n >= 2 * DEFAULT_SROWS * 128
            and n % 128 == 0 and n <= 1 << 24)


def model_device(model, device=None) -> torch.device:
    """Where a run on ``model`` happens: the model's ``device`` when it has
    one (``device``, if given, must name it), else ``resolve_device(device)``
    (None: the card)."""
    dev = getattr(model, "device", None)
    if dev is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"model lives on {dev}, not on {device}")
    return dev


class FilterSetup(NamedTuple):
    """What a filter loop needs, from ``filter_setup``: the step function
    ``step(x, w, y_t, streams, t=t) -> (x_new, w_new, ess, lz_inc, ll,
    a)``; whether its carried weights are normalised log weights
    (``log_carry``) or max-normalised exp-space weights; the layout; the
    generator(s) it draws from; the initial cloud ``x0`` (packed [d, N] or
    batch [N, d]), the carried initial weights ``w0`` and the initial log
    weights ``logw0`` (uniform, -log N global); and the device."""

    step: Callable
    log_carry: bool
    packed: bool
    streams: Streams
    x0: torch.Tensor
    w0: torch.Tensor
    logw0: torch.Tensor
    device: torch.device


def filter_setup(
    key: KeyLike,
    model,
    num_particles: int,
    resampler: str = "metropolis",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = None,
    layout: str = "auto",
    engine: str = "auto",
    pallas_tile: Optional[int] = None,
    axis_name=None,
    num_particles_global: Optional[int] = None,
    resample_op=None,
    resample_op_weights: str = "log",
    debug_checks: bool = False,
    device=None,
) -> FilterSetup:
    """The step, the carry's form and the initial carry of a run of
    ``bootstrap_filter`` with these arguments (see its docstring): the
    layout and engine checks, the choice of step, the generator(s) and
    the initial draw. ``bootstrap_filter`` and the streaming filter
    (``smc/streaming.py``) both start here, so a chunked run executes the
    same step object on the same generators in the same order."""
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown engine {engine!r}")
    if isinstance(axis_name, str):
        raise TypeError("axis_name is a parallel.mesh.ParticleAxis, not a "
                        "mesh axis name")
    resampler_kwargs = resampler_kwargs or {}
    n = num_particles
    n_global = num_particles_global or n
    if layout == "auto":
        layout = ("batch" if resample_op is not None
                  or not supports_packed(model) else "packed")
    if layout not in ("packed", "batch"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "packed" and not supports_packed(model):
        raise ValueError("model has no packed-layout methods; use "
                         "layout='batch'")
    packed = layout == "packed"

    user_tile = pallas_tile  # the fused CDF step has its own auto tile
    if pallas_tile is None:
        dk, itemsize = ((max(model.state_dim, model.obs_dim),
                         model.G.element_size())
                        if isinstance(model, DLM) else (1, 4))
        pallas_tile = auto_tile(n, dk, itemsize)
    use_fused_cdf = False
    if engine == "pallas" and resampler in ("systematic", "stratified"):
        if not (packed and ess_threshold is None and axis_name is None
                and resample_op is None and not debug_checks
                and _fused_cdf_eligible(model, n)):
            raise ValueError(
                "engine='pallas' with a CDF resampler needs packed layout, "
                "no ESS threshold, a single shard, no debug_checks, and a "
                f"float32 DLM with d,k <= {MAX_MXU_DIM} (standard MVT df >= "
                "2), N compatible with the window walk")
        use_fused_cdf = True
    if engine == "auto":
        engine = "xla"
    if engine == "pallas" and not use_fused_cdf:
        # As in the JAX package, the fused Metropolis step takes no
        # weight guard: debug_checks does not reach it.
        if not (packed and resampler == "metropolis"
                and ess_threshold is None and axis_name is None):
            raise ValueError("engine='pallas' requires packed layout, a "
                             "metropolis/systematic/stratified resampler, "
                             "no ESS threshold, and a single shard")
        if not _pallas_eligible(model, n, pallas_tile):
            raise ValueError(
                f"pallas engine needs a DLM with d,k <= {MAX_MXU_DIM}, N a "
                f"multiple of tile={pallas_tile} (and >= 2 tiles), tile a "
                f"multiple of 128, standard MVT with concrete df >= 2, and a "
                f"float32 or bfloat16 state")

    exp_op = None
    injected_exp = resample_op is not None and resample_op_weights == "exp"
    if injected_exp:
        if not packed or engine != "xla" or debug_checks:
            raise ValueError("resample_op_weights='exp' needs packed layout, "
                             "engine in ('auto', 'xla'), and "
                             "debug_checks=False")
        exp_op = resample_op
    elif (engine == "xla" and packed and not debug_checks
          and resample_op is None and axis_name is None
          and (resampler in ("metropolis", "residual")
               or resampler in POSITION_FNS)):
        exp_op = packed_exp_resample_op(resampler, n_global,
                                        **resampler_kwargs)
    if engine != "pallas" and exp_op is None and resample_op is None:
        resample_op = (packed_resample_op(resampler, n_global,
                                          **resampler_kwargs) if packed
                       else local_resample_op(
                           get_resampler(resampler, **resampler_kwargs),
                           n_global))

    dev = model_device(model, device)
    if axis_name is not None or injected_exp:
        if isinstance(key, torch.Generator):
            raise TypeError("the sharded filter takes an int seed")
        streams = make_streams(key, axis_name, dev)
    else:
        gen = make_generator(key, dev)
        streams = Streams(gen, gen)

    if use_fused_cdf:
        step = _fused_cdf_step_factory(
            model, n, resampler, user_tile,
            resampler_kwargs.get("sr", DEFAULT_SROWS))
    elif engine == "pallas":
        step = _pallas_step_factory(
            model, n, pallas_tile, resampler_kwargs.get("num_steps", 10),
            resampler_kwargs.get("num_window_tiles", 2))
    elif exp_op is not None:
        step = _fast_exp_step_factory(model, n_global, exp_op,
                                      ess_threshold, axis_name)
    elif packed:
        step = _step_factory(model.propagate_packed,
                             model.observation_logpdf_packed, resample_op,
                             ess_threshold, n_global, axis_name,
                             debug_checks)
    else:
        step = _step_factory(model.propagate, model.observation_logpdf,
                             resample_op, ess_threshold, n_global, axis_name,
                             debug_checks)
    # The carry: exp-space weights (the fast step and the fused CDF step)
    # or normalised log weights (the fused Metropolis and generic steps).
    log_carry = not (use_fused_cdf or exp_op is not None)

    x0 = (model.sample_initial_packed(streams.rank, n) if packed
          else model.sample_initial(streams.rank, (n,)))
    # Weights are at least float32, whatever the state dtype.
    wdtype = torch.promote_types(x0.dtype, torch.float32)
    logw0 = torch.full((n,), -math.log(n_global), dtype=wdtype, device=dev)
    w0 = logw0 if log_carry else torch.exp(logw0 - torch.max(logw0))
    return FilterSetup(step, log_carry, packed, streams, x0, w0, logw0, dev)


def scan_steps(step: Callable, x: torch.Tensor, w: torch.Tensor,
               ys: torch.Tensor, t0: int, streams: Streams,
               esss: torch.Tensor, lzs: torch.Tensor, xs=None, lls=None,
               ancs=None, draws=None):
    """Run the steps t0, t0 + 1, ... on the observation rows ``ys`` from
    the carry ``(x, w)``; row i of ``esss``, ``lzs`` and of each history
    buffer given (``xs``, ``lls``, ``ancs``) receives step t0 + i, and
    step i takes ``draws[i]`` when ``draws`` is given (a replay).
    Returns the carry after the last step; each step runs in a
    ``cusmc.filter.step`` span (its ``args``: t). Under
    ``utils.debug.debug_mode()`` each step's state, weights and evidence
    increment are checked for NaN (one host read a step), and the first
    NaN raises ``FloatingPointError`` naming the step."""
    check = nan_checks_enabled()
    span = span_sequence()
    try:
        for i in range(ys.shape[0]):
            t = t0 + i
            if span:
                span("cusmc.filter.step", t)
            x, w, ess, lz_inc, ll, a = step(
                x, w, ys[i], streams, t=t,
                draws=None if draws is None else draws[i])
            esss[i] = ess
            lzs[i] = lz_inc
            if xs is not None:
                xs[i] = x
            if lls is not None:
                lls[i] = ll
                ancs[i] = a
            if check:
                raise_on_nan(t, x=x, weights=w, evidence=lz_inc)
    finally:
        if span:
            span(None)
    return x, w


def final_log_weights(w: torch.Tensor, log_carry: bool,
                      axis=None) -> torch.Tensor:
    """The normalised log weights of a carry's weights (global
    normalisation over ``axis``)."""
    if log_carry:
        return w
    return torch.log(w) - torch.log(psum(torch.sum(w), axis))


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
    pallas_tile: Optional[int] = None,
    axis_name=None,
    num_particles_global: Optional[int] = None,
    resample_op=None,
    resample_op_weights: str = "log",
    debug_checks: bool = False,
    device=None,
    draws: Optional[dict] = None,
) -> FilterResult:
    """Run the bootstrap filter on observations ``ys`` [T, k]; row 0 is
    ignored (t=0 is the prior draw).

    ``key``: an int seed or a ``torch.Generator`` on the run's device.
    ``device``: where to run; a model with a ``device`` (a DLM) must
    already live there (None -> the model's device; for a model without
    one, such as a ``CustomSSM``, None means the card). ``resampler``: a
    registry key (``resampling.get_resampler``: "metropolis",
    "systematic", "stratified", "multinomial", "residual" or a registered
    one). ``ess_threshold=None`` resamples every step; a float in (0, 1]
    resamples when ESS < threshold * N.

    ``layout``: "auto" (packed, unless a ``resample_op`` is injected or
    the model has no packed methods: then "batch"), "packed" or "batch".
    Batch results keep the drawn [T, N, d] layout. ``debug_checks=True``
    takes the generic log-space step and prints a guard when the weights
    turn NaN or all -inf. Under ``utils.debug.debug_mode()`` every step
    is checked for NaN and the first raises ``FloatingPointError``.

    ``engine``: "auto" or "xla" (the composed path), or "pallas" (one
    fused kernel per step: metropolis, systematic or stratified, packed,
    no ESS threshold, one shard, a DLM with d, k <= 128, float32, or
    bfloat16 at even d for metropolis). ``pallas_tile``: the fused
    kernels' tile (None: their auto choice). ``resampler_kwargs`` of the
    fused path: ``num_steps`` and ``num_window_tiles`` (metropolis),
    ``sr`` (the CDF family).

    ``resample_op`` replaces the resampling: an op object with
    ``draw(streams, w)`` and ``op(x, w, draws) -> (x_anc, w_after, a)``
    in the chosen layout, over log weights, or over max-normalised exp
    weights with ``resample_op_weights="exp"`` (packed layout, engine
    "auto" or "xla", no ``debug_checks``: the fast step carries them).
    The sharded filter (what ``parallel.sharded_bootstrap_filter`` calls
    on each rank): ``axis_name`` a ``parallel.mesh.ParticleAxis`` (None:
    one shard), ``num_particles`` this rank's block of
    ``num_particles_global``, an op of ``parallel/resampling.py``, and
    ``key`` an int seed for the two streams of ``parallel.mesh``. The
    result holds this rank's particles and weights, global ancestors, and
    the replicated ESS and log-evidence.

    ``draws`` replays a run's numbers (one shard): ``{"x0": the initial
    cloud in the layout's shape, "steps": [(resample draws, noise), one
    for each step t = 1 .. T-1]}``, each step's pair as its step's
    ``draws=`` takes it (``key`` is then unused).

    Spans (``utils.timing.named_scope``): ``cusmc.filter.run`` holds the
    call (its ``args``: N, T, the engine, layout, resampler and ESS
    threshold asked for); inside it ``cusmc.filter.setup`` up to the first
    step, a ``cusmc.filter.step`` a step (``scan_steps``) and
    ``cusmc.filter.finish`` after the last.
    """
    with named_scope("cusmc.filter.run", dict(
            N=num_particles, T=len(ys), engine=engine, layout=layout,
            resampler=resampler, ess_threshold=ess_threshold)):
        with named_scope("cusmc.filter.setup"):
            s = filter_setup(
                key, model, num_particles, resampler=resampler,
                resampler_kwargs=resampler_kwargs,
                ess_threshold=ess_threshold, layout=layout, engine=engine,
                pallas_tile=pallas_tile, axis_name=axis_name,
                num_particles_global=num_particles_global,
                resample_op=resample_op,
                resample_op_weights=resample_op_weights,
                debug_checks=debug_checks, device=device)
            n, dev, x = num_particles, s.device, s.x0
            if draws is not None:
                x = torch.as_tensor(draws["x0"], dtype=x.dtype).to(dev)
            wdtype = s.logw0.dtype
            ys = torch.as_tensor(ys, dtype=wdtype).to(dev).contiguous()
            num_steps = ys.shape[0]
            esss = torch.empty((num_steps - 1,), dtype=wdtype, device=dev)
            lzs = torch.empty((num_steps - 1,), dtype=wdtype, device=dev)
            xs = lls = ancs = None
            if return_history:
                xs = torch.empty((num_steps,) + tuple(x.shape),
                                 dtype=x.dtype, device=dev)
                lls = torch.empty((num_steps, n), dtype=wdtype, device=dev)
                ancs = torch.empty((num_steps, n), dtype=torch.int32,
                                   device=dev)
                xs[0] = x
                lls[0] = s.logw0  # t=0 raw weight is the uniform 1/N fill
                ancs[0] = global_slots(n, axis_name, dev)
            hist = (xs[1:], lls[1:], ancs[1:]) if return_history else ()

        x, w = scan_steps(s.step, x, s.w0, ys[1:], 1, s.streams, esss, lzs,
                          *hist,
                          draws=None if draws is None else draws["steps"])

        with named_scope("cusmc.filter.finish"):
            logw_f = final_log_weights(w, s.log_carry, axis_name)
            ess = torch.cat([effective_sample_size(s.logw0, axis_name)[None],
                             esss])
            log_evidence = torch.sum(lzs)
            x_f = x.T if s.packed else x
            if not return_history:
                return FilterResult(final_particles=x_f,
                                    final_log_weights=logw_f, ess=ess,
                                    log_evidence=log_evidence)
            return FilterResult(
                final_particles=x_f, final_log_weights=logw_f, ess=ess,
                log_evidence=log_evidence,
                particles=xs.transpose(1, 2) if s.packed else xs,
                obs_loglik=lls, ancestors=ancs)
