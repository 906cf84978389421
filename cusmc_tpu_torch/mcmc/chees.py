"""ChEES-HMC: HMC whose one trajectory length, shared by all chains,
adapts on the Change-in-the-Estimator-of-the-Expected-Square criterion.

Port of ``cusmc_tpu/mcmc/chees.py:46-251`` (Hoffman, Radul & Sountsov,
AISTATS 2021). Each sweep integrates ``tau = 2 u_t h`` of trajectory time
(``u_t`` the t-th base-2 Halton point, so the mean is h) with
``ceil(tau / eps)`` leapfrog steps of the whole [C, d] block, accepts on
the joint energy (a divergence rejects), and for the first ``num_adapt``
sweeps adapts ``log h`` by Adam on the ChEES gradient

    dChEES/dtau ~ mean_c w_c Delta_c (x'_c - mean x') . v'_c,

(``w_c`` the acceptance probability, ``v'`` the metric-weighted end
velocity), ``eps`` by Robbins-Monro toward ``target_accept`` and, with
``precondition``, a diagonal inverse mass matrix as an EMA of the
cross-chain variance. Every cross-chain mean is pooled over the ranks of
``axis_name`` (a ``parallel.mesh.ParticleAxis``-like group) when the
chains are sharded, so every rank integrates the same number of steps.

The leapfrog count is a device value; the JAX function runs it as a
``fori_loop`` trip count. Here it is read to the host once per sweep,
the one host read of a sweep, and the Python loop runs exactly that many
leapfrog steps (masking ``max_leapfrog`` steps would evaluate up to 1000
gradients a sweep). ``mean_leapfrog`` is the mean of those counts.

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``init_x``'s device; each sweep draws its momenta p0 [C, d], then its
accept uniforms u [C]. ``draws`` replays given numbers: a sequence of
``(p0, u)``, one a sweep (the JAX key schedule: ``kp, ku =
split(fold_in(key, t))``). The sweep loop is ``mcmc/chains.run_sweeps``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.mcmc.chains import accept_uniforms, run_sweeps
from cusmc_tpu_torch.mcmc.mala import _value_and_grad_batched
from cusmc_tpu_torch.ops.random import normal
from cusmc_tpu_torch.parallel.mesh import pmean


@dataclass
class ChEESState:
    x: torch.Tensor             # [C, d]
    logp: torch.Tensor          # [C]
    grad: torch.Tensor          # [C, d]
    log_step: torch.Tensor      # 0-dim: log leapfrog step size eps
    log_traj: torch.Tensor      # 0-dim: log mean trajectory time h
    adam_m: torch.Tensor        # 0-dim Adam moments of log_traj
    adam_v: torch.Tensor
    var_est: torch.Tensor       # [d] diagonal inverse mass
    accept_count: torch.Tensor  # [C]


@dataclass
class ChEESResult:
    state: ChEESState
    samples: Optional[torch.Tensor]
    accept_rate: torch.Tensor
    step_size: torch.Tensor     # final eps
    traj_length: torch.Tensor   # final mean trajectory time h
    mean_leapfrog: torch.Tensor  # mean leapfrog steps actually taken
    mass_var: torch.Tensor      # [d] learned inverse-mass diagonal


def _halton2(t: int, bits: int = 24) -> float:
    """Base-2 radical inverse of the integer ``t`` plus 0.5^(bits+1), as
    the float32 number the JAX function computes: the sum of the ``bits``
    lowest bits' terms is exact in float32, and the offset's addition
    rounds to nearest even, as ``np.float32`` rounds the exact double."""
    s = sum(((t >> i) & 1) * 0.5 ** (i + 1) for i in range(bits))
    return float(np.float32(s + 0.5 ** (bits + 1)))


def _log0(v, like: torch.Tensor) -> torch.Tensor:
    """log(v) as a 0-dim tensor of ``like``'s type and device: ``v`` a
    number (its log taken in double and rounded once) or a tensor (a warm
    restart's adapted value, its log taken in its type)."""
    if isinstance(v, torch.Tensor):
        return torch.log(v.to(device=like.device, dtype=like.dtype))
    return torch.tensor(math.log(v), dtype=like.dtype, device=like.device)


def chees_hmc_sampler(
    key: KeyLike,
    log_prob: Callable,
    init_x: torch.Tensor,
    num_steps: int,
    step_size: float = 0.1,
    init_traj: Optional[float] = None,
    target_accept: float = 0.651,
    adapt_rate: float = 0.05,
    traj_lr: float = 0.05,
    num_adapt: Optional[int] = None,
    max_leapfrog: int = 1000,
    precondition: bool = True,
    var_ema: float = 0.1,
    init_var: Optional[torch.Tensor] = None,
    keep_samples: bool = True,
    thin: int = 1,
    axis_name=None,
    draws: Optional[Sequence] = None,
) -> ChEESResult:
    """Run ``num_steps`` ChEES-HMC sweeps over [C, d] chains (adaptation
    for the first ``num_adapt``, default num_steps // 2, then frozen).
    ``init_traj`` defaults to ``10 * step_size``; ``step_size``,
    ``init_traj`` and ``init_var`` may be tensors (a warm restart's);
    ``samples`` [ceil(T / thin), C, d] when ``keep_samples``."""
    if num_adapt is None:
        num_adapt = num_steps // 2
    if init_traj is None:
        init_traj = 10.0 * step_size
    c, d = init_x.shape
    dtype, dev = init_x.dtype, init_x.device
    gen = None if draws is not None else make_generator(key, dev)

    vg = _value_and_grad_batched(log_prob)
    logp0, grad0 = vg(init_x)
    zero = torch.zeros((), dtype=dtype, device=dev)
    state = ChEESState(
        x=init_x, logp=logp0, grad=grad0,
        log_step=_log0(step_size, init_x), log_traj=_log0(init_traj, init_x),
        adam_m=zero, adam_v=zero,
        var_est=(torch.ones((d,), dtype=dtype, device=dev) if init_var is None
                 else torch.as_tensor(init_var, dtype=dtype).to(dev)),
        accept_count=torch.zeros((c,), dtype=dtype, device=dev))
    b1, b2, aeps = 0.9, 0.95, 1e-8
    log_cap = float(np.float32(math.log(0.5 * max_leapfrog)))
    leaps = []

    def sweep(s, t, adapting, step_draws):
        """One sweep; ``adapting`` is 1 for the first ``num_adapt`` sweeps
        and 0 after (``run_sweeps`` with a rate of 1)."""
        eps = torch.exp(s.log_step)
        h = torch.exp(s.log_traj)
        tau = 2.0 * _halton2(t) * h
        steps = torch.clamp(torch.nan_to_num(torch.ceil(tau / eps), nan=1.0),
                            1, max_leapfrog)
        n_leap = int(steps)  # the sweep's one host read
        leaps.append(n_leap)
        tau_eff = n_leap * eps  # the time actually integrated

        if step_draws is None:
            p0 = normal(gen, (c, d), dtype, dev)
            u = accept_uniforms(gen, c, init_x)
        else:
            p0, u = step_draws
        # Diagonal-mass leapfrog == per-dimension step scaling.
        sqrt_var = torch.sqrt(s.var_est)
        eps_d = eps * sqrt_var if precondition else eps
        x_pr, p_pr, grad_pr, logp_pr = s.x, p0, s.grad, s.logp
        for _ in range(n_leap):
            p_half = p_pr + 0.5 * eps_d * grad_pr
            x_pr = x_pr + eps_d * p_half
            logp_pr, grad_pr = vg(x_pr)
            p_pr = p_half + 0.5 * eps_d * grad_pr

        ke0 = 0.5 * torch.sum(p0 * p0, dim=-1)
        ke1 = 0.5 * torch.sum(p_pr * p_pr, dim=-1)
        log_alpha = (logp_pr - ke1) - (s.logp - ke0)
        log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha,
                                torch.full_like(log_alpha, -torch.inf))
        accept = torch.log(u) < log_alpha
        acc = accept.to(dtype)
        x_new = torch.where(accept[:, None], x_pr, s.x)

        # The ChEES gradient in log h.
        w = torch.exp(torch.clamp(log_alpha, max=0.0))
        m_cur = pmean(torch.mean(s.x, dim=0), axis_name)
        m_pr = pmean(torch.mean(x_pr, dim=0), axis_name)
        xc = s.x - m_cur
        xp = x_pr - m_pr
        delta = torch.sum(xp * xp, dim=-1) - torch.sum(xc * xc, dim=-1)
        # The preconditioned leapfrog moves x by eps_d p a step, so the
        # end velocity is sqrt(var_est) p'.
        vel = p_pr * sqrt_var if precondition else p_pr
        dot = torch.sum(xp * vel, dim=-1)
        num = pmean(torch.mean(w * delta * dot), axis_name)
        den = pmean(torch.mean(w), axis_name) + 1e-12
        g = (num / den) * tau_eff  # d tau / d log h = tau
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))

        m_new = b1 * s.adam_m + (1 - b1) * g
        v_new = b2 * s.adam_v + (1 - b2) * g * g
        # b ** tt in float32, as the JAX function takes it.
        tt = np.float32(t + 1)
        m_hat = m_new / float(np.float32(1) - np.float32(b1) ** tt)
        v_hat = v_new / float(np.float32(1) - np.float32(b2) ** tt)
        step_h = traj_lr * m_hat / (torch.sqrt(v_hat) + aeps)
        log_traj = s.log_traj + adapting * step_h
        # Keep h integrable: at least one step, at most the cap.
        log_traj = torch.minimum(torch.maximum(log_traj, s.log_step),
                                 s.log_step + log_cap)

        pooled_acc = pmean(torch.mean(acc), axis_name)
        log_step = s.log_step + adapting * adapt_rate * (
            pooled_acc - target_accept)
        var_new = s.var_est
        if precondition:
            m1 = pmean(torch.mean(x_new, dim=0), axis_name)
            m2 = pmean(torch.mean(x_new * x_new, dim=0), axis_name)
            bvar = torch.clamp(m2 - m1 * m1, min=1e-8)
            a_v = adapting * var_ema
            var_new = (1 - a_v) * s.var_est + a_v * bvar

        return ChEESState(
            x=x_new, logp=torch.where(accept, logp_pr, s.logp),
            grad=torch.where(accept[:, None], grad_pr, s.grad),
            log_step=log_step, log_traj=log_traj, var_est=var_new,
            adam_m=adapting * m_new + (1 - adapting) * s.adam_m,
            adam_v=adapting * v_new + (1 - adapting) * s.adam_v,
            accept_count=s.accept_count + acc), None

    state, kept = run_sweeps(sweep, state, num_steps, num_adapt, 1.0,
                             keep_samples, thin, draws)
    return ChEESResult(
        state=state, samples=kept,
        accept_rate=pmean(torch.mean(state.accept_count / num_steps),
                          axis_name),
        step_size=torch.exp(state.log_step),
        traj_length=torch.exp(state.log_traj),
        mean_leapfrog=torch.tensor(sum(leaps) / num_steps, dtype=dtype,
                                   device=dev),
        mass_var=state.var_est)
