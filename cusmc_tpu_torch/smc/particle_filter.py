"""Bootstrap particle filter: the packed exp-space path, one shard or many.

Port of ``cusmc_tpu/smc/particle_filter.py``: ``FilterResult`` (``:47``),
``_fast_exp_step_factory`` (``:158-275``, always-resample and
ESS-adaptive, on one shard or over a particle axis),
``packed_exp_resample_op`` (``:278-334``, metropolis with
``num_steps="auto"``, the ``POSITION_FNS`` family and residual),
``_residual_resample_packed`` (``:417-463``) and the packed path of
``bootstrap_filter`` (``:604-839``). The T-step ``lax.scan`` becomes a
Python loop; tensors stay on the model's device and the always-resample
loop reads nothing back to the host.

Each step resamples, propagates and reweights, carrying max-normalised
exp-space weights ``w`` instead of log weights (see the JAX docstring for
the evidence algebra and the 88-nat flush of exp-space weights, which the
port shares). The resample goes through the hand-written kernels on a CUDA
device: ``ops/cumsum.blocked_cumsum`` and
``ops/monotone_gather.inverse_cdf_apply`` for the CDF family and (twice a
step) for residual, ``resampling/rolls.roll_metropolis_sweeps_expspace``
for metropolis.

Randomness on one shard comes from one ``torch.Generator``, drawn in a
fixed order: the initial cloud, then per step the resample draws (when it
resamples) and the propagation noise. A step can instead be handed
``draws=(resample draws, noise)``, which is how the tests replay JAX's
numbers.

The sharded filter (``axis_name``, a ``parallel.mesh.ParticleAxis``) runs
this same step on each rank's block of ``num_particles`` of
``num_particles_global`` particles, with an injected exp-space resample op
of ``parallel/resampling.py``: the weight sums are all-reduced (``psum``,
``pmax``), the resample decision of the ESS-adaptive step comes from the
reduced ESS (so every rank takes the same branch), ancestors are global,
and each rank draws from the two streams of ``parallel.mesh`` (the rank
stream for its initial cloud and noise).

``engine="pallas"`` (``:538-601``, ``:337-414``, ``:662-793``) runs one
fused kernel per step: ``ops/fused_step`` (windowed Metropolis; the step
carries normalised log weights) or ``ops/fused_cdf_step`` (systematic and
stratified; the step carries exp-space weights and runs ``blocked_cumsum``
first). Their draws per step are ``(s, seed)`` or ``(u, seed)``, and the
kernels make their own noise. ``engine="xla"`` is the composed path above,
and ``"auto"`` always takes it: the windowed proposal is biased at finite
B and the fused CDF step was never faster on the TPU (``:680-716``).
``pallas_interpret`` is TPU-only and not ported: on a CPU tensor the fused
ops run their plain versions.

Not ported yet (``NotImplementedError``, see ROADMAP queue 1):
``layout="batch"``, injected log-space ``resample_op``s (the registry path
``packed_resample_op``) and ``debug_checks``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator, resolve_device
from cusmc_tpu_torch.diagnostics.metrics import (
    effective_sample_size,
    log_normalize,
)
from cusmc_tpu_torch.models.base import supports_packed
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
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply
from cusmc_tpu_torch.parallel.mesh import (
    Streams,
    global_slots,
    make_streams,
    pmax,
    psum,
)
from cusmc_tpu_torch.resampling.classic import (
    POSITION_FNS,
    clamped_residual_values,
    residual_draws,
    roll_right,
)
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
    statistics, clamped by ``clamped_residual_values``) and a roll right by
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
        rcdf, clamped_residual_values(u, n_det, rcdf[-1]), X)
    # Remainder draw k belongs to slot n_det + k: roll right by n_det.
    idx = roll_right(n, n_det)
    mask = slots < n_det
    a = torch.where(mask, a_det, a_res[idx])
    x_anc = torch.where(mask[None, :], x_det, x_res[:, idx])
    return x_anc, a


def _fast_exp_step_factory(model, n_global: int, resample_op,
                           ess_threshold: Optional[float],
                           axis=None) -> Callable:
    """The exp-space step ``step(x, w, y_t, streams=None, draws=None) ->
    (x_new, w_new, ess, lz_inc, ll, a)``. ESS-adaptive steps read the
    resample decision back to the host (the JAX ``lax.cond``). ``axis``:
    the particle axis of a sharded run (the sums and maxima are then
    all-reduced over it, so every rank computes the same ESS and takes
    the same branch), None for one shard. ``resample_op(x, w, draws)``
    returns ``(x_anc, a)`` or ``(x_anc, w_pre, a)``."""
    log_n = math.log(n_global)

    def step(x, w, y_t, streams=None, draws=None):
        s1 = torch.sum(w)
        s2 = torch.sum(w * w)
        if axis is not None:
            s1, s2 = axis.psum(torch.stack([s1, s2])).unbind()
        ess = s1 * s1 / s2
        pred = (ess_threshold is None
                or bool(ess < ess_threshold * n_global))
        if pred:
            res_draws = (draws[0] if draws is not None
                         else resample_op.draw(streams, w))
            out = resample_op(x, w, res_draws)
            x_anc, a = out[0], out[-1]
        else:  # identity ancestry, in global indices
            x_anc = x
            a = global_slots(w.shape[0], axis, w.device)
        noise = draws[1] if draws is not None else None
        gen = streams.rank if streams is not None else None
        x_new = model.propagate_packed(gen, x_anc, noise)
        ll = model.observation_logpdf_packed(y_t, x_new)
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
        return x_new, w_new, ess, lz_inc, ll, a

    return step


def _fused_factors(model: DLM):
    """The fused kernels' model arguments: contiguous (G, Q = W_sqrt, F,
    Li = V_chol_inv), df (None for MVN) and the observation log-normaliser
    as floats (one read-back, when the step is built)."""
    mats = tuple(m.contiguous() for m in (model.G, model.W_sqrt, model.F,
                                          model.V_chol_inv))
    df = model.df_value if model.noise == "mvt" else None
    return mats, df, float(model.log_norm)


def _pallas_step_factory(model: DLM, num_particles: int, tile: int,
                         num_sweeps: int, num_window_tiles: int = 2
                         ) -> Callable:
    """The step around the fused windowed-Metropolis kernel
    (``ops/fused_step.py``): ``step(x, logw, y_t, streams=None, draws=None)
    ->
    (x_new, logw_new, ess, lz_inc, ll, a)``, carrying normalised log
    weights; ``draws = (s, seed)``. Always resamples, so the evidence
    increment is ``logsumexp(ll) - log N``."""
    if not isinstance(num_sweeps, int):
        raise ValueError(f"engine='pallas' needs an integer num_steps, got "
                         f"{num_sweeps!r}")
    (G, Q, F, Li), df, log_norm = _fused_factors(model)
    log_n = math.log(num_particles)

    def step(x, logw, y_t, streams=None, draws=None):
        ess = effective_sample_size(logw)
        if draws is None:
            draws = fused_filter_step_draws(streams.rank, num_particles, tile,
                                            x.device)
        x_new, ll, a = fused_filter_step(
            x, logw, y_t, G, Q, F, Li, df, log_norm, draws,
            noise=model.noise, num_sweeps=num_sweeps, tile=tile,
            df_int=model.df_int, num_window_tiles=num_window_tiles)
        logw_new, lse = log_normalize(ll)
        return x_new, logw_new, ess, lse - log_n, ll, a

    return step


def _fused_cdf_step_factory(model: DLM, num_particles: int, pos_mode: str,
                            tile: Optional[int], sr: int) -> Callable:
    """The step around the fused inverse-CDF kernel
    (``ops/fused_cdf_step.py``): ``step(x, w, y_t, streams=None,
    draws=None)``
    with the exp-space carry and evidence algebra of
    ``_fast_exp_step_factory``; ``draws = (u, seed)``. Outside the kernel
    a step runs the blocked cumsum and the weight reductions."""
    (G, Q, F, Li), df, log_norm = _fused_factors(model)
    log_n = math.log(num_particles)

    def step(x, w, y_t, streams=None, draws=None):
        s1 = torch.sum(w)
        s2 = torch.sum(w * w)
        ess = s1 * s1 / s2
        cdf, _ = blocked_cumsum(w)
        if draws is None:
            draws = fused_cdf_filter_step_draws(streams.rank, x.device)
        x_new, ll, a = fused_cdf_filter_step(
            cdf, x, y_t, G, Q, F, Li, df, log_norm, draws,
            noise=model.noise, mode=pos_mode, tile=tile, sr=sr,
            df_int=model.df_int)
        m = torch.max(ll)
        w_new = torch.exp(ll - m)
        lz_inc = m + torch.log(torch.sum(w_new)) - log_n
        return x_new, w_new, ess, lz_inc, ll, a

    return step


def _fused_model_ok(model) -> bool:
    """A float32 DLM within the kernels' dimension cap; MVT with df >= 2
    (the in-kernel Marsaglia-Tsang sampler has no alpha < 1 boost)."""
    if not (isinstance(model, DLM)
            and max(model.state_dim, model.obs_dim) <= MAX_MXU_DIM
            and model.G.dtype == torch.float32):
        return False
    return model.noise != "mvt" or model.df_value >= 2.0


def _pallas_eligible(model, n: int, tile: int) -> bool:
    """``particle_filter.py:577-601``, float32 only."""
    return (_fused_model_ok(model) and n % tile == 0 and n >= 2 * tile
            and tile % 128 == 0)


def _fused_cdf_eligible(model, n: int) -> bool:
    """``particle_filter.py:389-414``: the model check, and N divisible by
    the auto tile, large enough for the window walk, at most 2^24."""
    if not _fused_model_ok(model):
        return False
    tile = cdf_auto_tile(n, max(model.state_dim, model.obs_dim))
    return (n % tile == 0 and n >= 2 * DEFAULT_SROWS * 128
            and n % 128 == 0 and n <= 1 << 24)


def _engine_step(engine: str, model, n: int, resampler: str,
                 resampler_kwargs: dict, ess_threshold: Optional[float],
                 pallas_tile: Optional[int]):
    """``(step, carries_log_weights)`` for the engine (the dispatch of
    ``particle_filter.py:662-729, 781-793``)."""
    if engine in ("auto", "xla"):
        op = packed_exp_resample_op(resampler, n, **resampler_kwargs)
        return _fast_exp_step_factory(model, n, op, ess_threshold), False
    if resampler in ("systematic", "stratified"):
        if ess_threshold is not None or not _fused_cdf_eligible(model, n):
            raise ValueError(
                "engine='pallas' with a CDF resampler needs no ESS "
                f"threshold and a float32 DLM with d,k <= {MAX_MXU_DIM} "
                "(standard MVT df >= 2), N compatible with the window walk")
        return _fused_cdf_step_factory(
            model, n, resampler, pallas_tile,
            resampler_kwargs.get("sr", DEFAULT_SROWS)), False
    if resampler != "metropolis" or ess_threshold is not None:
        raise ValueError("engine='pallas' requires a "
                         "metropolis/systematic/stratified resampler and no "
                         "ESS threshold")
    if pallas_tile is None:
        dk = (max(model.state_dim, model.obs_dim)
              if isinstance(model, DLM) else 1)
        pallas_tile = auto_tile(n, dk)
    if not _pallas_eligible(model, n, pallas_tile):
        raise ValueError(
            f"pallas engine needs a DLM with d,k <= {MAX_MXU_DIM}, N a "
            f"multiple of tile={pallas_tile} (and >= 2 tiles), tile a "
            f"multiple of 128, standard MVT with df >= 2, and a float32 "
            f"state")
    return _pallas_step_factory(
        model, n, pallas_tile, resampler_kwargs.get("num_steps", 10),
        resampler_kwargs.get("num_window_tiles", 2)), True


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
    resample_op: Optional[Callable] = None,
    resample_op_weights: str = "log",
    debug_checks: bool = False,
    device=None,
) -> FilterResult:
    """Run the bootstrap filter on observations ``ys`` [T, k]; row 0 is
    ignored (t=0 is the prior draw).

    ``key``: an int seed or a ``torch.Generator`` on the model's device.
    ``device``: where to run; the model must already live there (None ->
    the model's device). ``resampler``: "metropolis" | "systematic" |
    "stratified" | "multinomial". ``ess_threshold=None`` resamples every
    step; a float in (0, 1] resamples when ESS < threshold * N.

    ``engine``: "auto" or "xla" (the composed path), or "pallas" (one
    fused kernel per step: metropolis, systematic or stratified, no ESS
    threshold, a float32 DLM with d, k <= 128). ``pallas_tile``: the fused
    kernels' tile (None: their auto choice). ``resampler_kwargs`` of the
    fused path: ``num_steps`` and ``num_window_tiles`` (metropolis),
    ``sr`` (the CDF family).

    The sharded filter (what ``parallel.sharded_bootstrap_filter`` calls
    on each rank): ``axis_name`` a ``parallel.mesh.ParticleAxis`` (None:
    one shard), ``num_particles`` this rank's block of
    ``num_particles_global``, ``resample_op`` an exp-space op of
    ``parallel/resampling.py`` with ``resample_op_weights="exp"``, and
    ``key`` an int seed for the two streams of ``parallel.mesh``. The
    result holds this rank's particles and weights, global ancestors, and
    the replicated ESS and log-evidence.
    """
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown engine {engine!r}")
    if layout == "batch":
        raise NotImplementedError("layout='batch' is not ported yet "
                                  "(ROADMAP queue 1, item 6)")
    if layout not in ("auto", "packed"):
        raise ValueError(f"unknown layout {layout!r}")
    if debug_checks:
        raise NotImplementedError("debug_checks is not ported yet (ROADMAP "
                                  "queue 1, item 6)")
    n_global = num_particles_global or num_particles
    sharded = (axis_name is not None or resample_op is not None
               or n_global != num_particles)
    if sharded and (resample_op is None or resample_op_weights != "exp"):
        raise NotImplementedError(
            "a sharded run needs an injected exp-space resample op "
            "(parallel.sharded_bootstrap_filter builds one); shard-local "
            "and log-space injected ops (packed_resample_op) are not "
            "ported yet (ROADMAP queue 1, item 6)")
    if sharded and engine == "pallas":
        raise ValueError("engine='pallas' runs a single shard only")
    if not supports_packed(model):
        raise NotImplementedError("models without packed-layout methods "
                                  "need layout='batch', not ported yet")
    dev = model.device
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"model lives on {dev}, not on {device}")

    n = num_particles
    if sharded:
        if isinstance(key, torch.Generator):
            raise TypeError("the sharded filter takes an int seed")
        step = _fast_exp_step_factory(model, n_global, resample_op,
                                      ess_threshold, axis_name)
        log_carry = False
        streams = make_streams(key, axis_name, dev)
    else:
        step, log_carry = _engine_step(engine, model, n, resampler,
                                       resampler_kwargs or {}, ess_threshold,
                                       pallas_tile)
        gen = make_generator(key, dev)
        streams = Streams(gen, gen)
    wdtype = model.V_chol.dtype
    ys = torch.as_tensor(ys, dtype=wdtype).to(dev).contiguous()
    num_steps = ys.shape[0]

    x = model.sample_initial_packed(streams.rank, n)
    logw0 = torch.full((n,), -math.log(n_global), dtype=wdtype, device=dev)
    # The carry: normalised log weights (fused Metropolis) or exp-space
    # weights, uniform -> ones.
    w = logw0 if log_carry else torch.exp(logw0 - torch.max(logw0))
    esss = torch.empty((num_steps - 1,), dtype=wdtype, device=dev)
    lzs = torch.empty((num_steps - 1,), dtype=wdtype, device=dev)
    if return_history:
        xs = torch.empty((num_steps,) + tuple(x.shape), dtype=x.dtype,
                         device=dev)
        lls = torch.empty((num_steps, n), dtype=wdtype, device=dev)
        ancs = torch.empty((num_steps, n), dtype=torch.int32, device=dev)
        xs[0] = x
        lls[0] = logw0  # t=0 raw weight is the uniform 1/N fill
        ancs[0] = global_slots(n, axis_name, dev)

    for t in range(1, num_steps):
        x, w, ess, lz_inc, ll, a = step(x, w, ys[t], streams)
        esss[t - 1] = ess
        lzs[t - 1] = lz_inc
        if return_history:
            xs[t] = x
            lls[t] = ll
            ancs[t] = a

    logw_f = (w if log_carry else
              torch.log(w) - torch.log(psum(torch.sum(w), axis_name)))
    ess = torch.cat([effective_sample_size(logw0, axis_name)[None], esss])
    log_evidence = torch.sum(lzs)
    x_f = x.T
    if not return_history:
        return FilterResult(final_particles=x_f, final_log_weights=logw_f,
                            ess=ess, log_evidence=log_evidence)
    return FilterResult(
        final_particles=x_f, final_log_weights=logw_f, ess=ess,
        log_evidence=log_evidence, particles=xs.transpose(1, 2),
        obs_loglik=lls, ancestors=ancs)
