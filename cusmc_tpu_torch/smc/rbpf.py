"""Rao-Blackwellized (marginalized) particle filter.

Port of ``cusmc_tpu/smc/rbpf.py:37-206`` (Doucet et al. 2000; Schön et al.
2005) over a ``models.clgssm.CLGSSM``: each particle carries its sampled
nonlinear state u and a Kalman mean and covariance of the linear substate
z; the weight is the closed-form predictive N(y; F m_pred + c, F P_pred F'
+ V).

- ``_kf_general``: the per-particle Kalman bank. The user's matrix
  callables are mapped over the particles with ``torch.func.vmap`` (a
  constant one is broadcast), then each particle's predict and update is a
  batched product of [N, ., .] matrices: the Cholesky factor of S
  (``torch.linalg.cholesky_ex``), a triangular solve for the residual and
  a Cholesky solve for the gain, as the JAX package's vmapped body does.
  On the H100 the batched library calls over [16384, 2, 2] ran the
  general bank at the rate of a written-out 2 x 2 factor and solves
  (PERF.md section 6), so the library's are kept.
- ``_kf_constant`` (``mats_constant=True``): F, G, V, W evaluated once at
  a zero u, one shared covariance recursion, per-particle means only.

The ESS-adaptive ``lax.cond`` becomes one host read a step (a bool,
through ``host_scalar``), as in the port's generic step; nothing else in
the loop reads back. Randomness: one ``torch.Generator`` (the initial
cloud, then per step the resample, when it resamples, and the model's
``propagate_nl``); ``draws={"steps": [resampler keyword draws, ...]}``
replays the resampler's (the JAX key schedule: ``k_init, k_scan =
split(key)``; per step ``k_res, k_prop = split(fold_in(k_scan, t))``), and
the model's callables then receive ``gen=None``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from cusmc_tpu_torch.device import KeyLike, as_tensor, make_generator
from cusmc_tpu_torch.diagnostics.metrics import effective_sample_size, \
    log_normalize
from cusmc_tpu_torch.models.clgssm import CLGSSM
from cusmc_tpu_torch.resampling import get_resampler
from cusmc_tpu_torch.smc.particle_filter import _ancestors, model_device
from cusmc_tpu_torch.utils.linalg import tri_solve
from cusmc_tpu_torch.utils.timing import host_scalar

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class RBPFResult:
    """``filtered_mean`` [T, dz]: E[z_t | y_{1:t}], the weighted mixture
    of the Kalman means; ``filtered_nl_mean`` [T, p]: E[u_t | y_{1:t}].
    ``final_cov`` is [N, dz, dz] (general) or [dz, dz] (mats_constant).
    ``nl_particles`` and ``means`` only with ``return_history=True``."""

    final_nl: torch.Tensor
    final_mean: torch.Tensor
    final_cov: torch.Tensor
    final_log_weights: torch.Tensor
    ess: torch.Tensor
    log_evidence: torch.Tensor
    filtered_mean: torch.Tensor
    filtered_nl_mean: torch.Tensor
    nl_particles: Optional[torch.Tensor] = None
    means: Optional[torch.Tensor] = None


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [..., m, n] @ x [..., n] -> [..., m]."""
    return (A @ x[..., None])[..., 0]


def _kf_general(model: CLGSSM, y, u, m, P):
    """Per-particle conditional Kalman predict and update. Returns (m_new
    [N, dz], P_new [N, dz, dz], ll [N])."""
    k_dim = model.obs_dim
    G, W, F, V, b, c = torch.func.vmap(
        lambda ui: (model.Gmat(ui), model.Wcov(ui), model.Fmat(ui),
                    model.Vcov(ui), model.b(ui), model.c(ui)),
        out_dims=0)(u)
    m_pred = _mv(G, m) + b
    P_pred = G @ P @ G.mT + W
    S = F @ P_pred @ F.mT + V
    L = torch.linalg.cholesky_ex(S).L
    r = y - _mv(F, m_pred) - c
    alpha = torch.linalg.solve_triangular(L, r[..., None],
                                          upper=False)[..., 0]
    ll = (-0.5 * torch.sum(alpha * alpha, -1)
          - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
          - 0.5 * k_dim * _LOG_2PI)
    K = torch.cholesky_solve(F @ P_pred, L).mT   # P_pred F' S^-1 [N, dz, k]
    m_new = m_pred + _mv(K, r)
    eye = torch.eye(model.lin_dim, dtype=m.dtype, device=m.device)
    ikf = eye - K @ F
    P_new = ikf @ P_pred @ ikf.mT + K @ V @ K.mT  # Joseph form
    return m_new, P_new, ll


def _kf_constant(model: CLGSSM, y, u, m, P):
    """The common-covariance path (``mats_constant=True``): ``P`` is one
    [dz, dz]; per-particle work is the offset-dependent mean and residual.
    Returns (m_new [N, dz], P_new [dz, dz], ll [N])."""
    k_dim = model.obs_dim
    u_ref = torch.zeros((model.nl_dim,), dtype=m.dtype, device=m.device)
    G, W = model.Gmat(u_ref), model.Wcov(u_ref)
    F, V = model.Fmat(u_ref), model.Vcov(u_ref)
    bs = torch.func.vmap(model.b, out_dims=0)(u)           # [N, dz]
    cs = torch.func.vmap(model.c, out_dims=0)(u)           # [N, k]
    m_pred = m @ G.T + bs
    P_pred = G @ P @ G.T + W
    S = F @ P_pred @ F.T + V
    L = torch.linalg.cholesky_ex(S).L
    r = y[None, :] - m_pred @ F.T - cs
    alpha = tri_solve(L, r)
    ll = (-0.5 * torch.sum(alpha * alpha, dim=-1)
          - torch.sum(torch.log(torch.diagonal(L))) - 0.5 * k_dim * _LOG_2PI)
    K = torch.cholesky_solve(F @ P_pred, L).T              # [dz, k]
    m_new = m_pred + r @ K.T
    eye = torch.eye(model.lin_dim, dtype=m.dtype, device=m.device)
    ikf = eye - K @ F
    P_new = ikf @ P_pred @ ikf.T + K @ V @ K.T
    return m_new, P_new, ll


def rao_blackwell_filter(
    key: KeyLike,
    model: CLGSSM,
    ys,
    num_particles: int,
    resampler: str = "systematic",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = 0.5,
    return_history: bool = False,
    device=None,
    draws: Optional[dict] = None,
) -> RBPFResult:
    """Run the RBPF on observations ``ys`` [T, k] (row 0 is the prior
    step) on the model's device. ``ess_threshold`` in (0, 1] resamples when
    the Kish ESS falls below it times N (None: every step)."""
    ancestor_fn = get_resampler(resampler, **(resampler_kwargs or {}))
    n = num_particles
    log_n = math.log(n)
    kf = _kf_constant if model.mats_constant else _kf_general
    dev = model_device(model, device)
    gen = make_generator(key, dev)
    replay = draws is not None
    mgen = None if replay else gen

    u = model.sample_initial_nl(mgen, n)
    dtype = u.dtype
    dz = model.lin_dim
    m = model.m0.to(dtype).expand(n, dz)
    P = model.C0.to(dtype)
    if not model.mats_constant:
        P = P.expand(n, dz, dz)
    ys = as_tensor(ys, dtype=dtype, device=dev)
    num_steps = ys.shape[0]
    logw0 = torch.full((n,), -log_n, dtype=dtype, device=dev)
    logw = logw0
    esss = torch.empty(num_steps, dtype=dtype, device=dev)
    lzs = torch.empty(num_steps - 1, dtype=dtype, device=dev)
    fms = torch.empty((num_steps, dz), dtype=dtype, device=dev)
    fus = torch.empty((num_steps, u.shape[-1]), dtype=dtype, device=dev)
    esss[0] = effective_sample_size(logw0)
    fms[0], fus[0] = m.mean(dim=0), u.mean(dim=0)
    if return_history:
        us = torch.empty((num_steps,) + tuple(u.shape), dtype=dtype,
                         device=dev)
        ms = torch.empty((num_steps, n, dz), dtype=dtype, device=dev)
        us[0], ms[0] = u, m

    for t in range(1, num_steps):
        ess = effective_sample_size(logw)
        esss[t] = ess
        if ess_threshold is None or host_scalar(ess < ess_threshold * n):
            res_d = gen if not replay else draws["steps"][t - 1]
            a = _ancestors(ancestor_fn, logw, res_d).long()
            u, m = u[a], m[a]
            if not model.mats_constant:
                P = P[a]
            logw = logw0
        u = model.propagate_nl(mgen, u)
        m, P, ll = kf(model, ys[t], u, m, P)
        logw, lzs[t - 1] = log_normalize(logw + ll)
        w = torch.exp(logw)
        fms[t], fus[t] = w @ m, w @ u
        if return_history:
            us[t], ms[t] = u, m

    result = RBPFResult(
        final_nl=u, final_mean=m, final_cov=P, final_log_weights=logw,
        ess=esss, log_evidence=torch.sum(lzs), filtered_mean=fms,
        filtered_nl_mean=fus)
    if return_history:
        result.nl_particles, result.means = us, ms
    return result
