"""Stochastic ensemble Kalman filter (EnKF, perturbed observations).

Port of ``cusmc_tpu/smc/enkf.py:31-136`` (Evensen 1994; Burgers et al.
1998): a linear Gaussian update of an ensemble in place of reweighting,
biased for non-Gaussian posteriors but free of weight degeneracy. The
update is ensemble-anomaly products, [N, d]'[N, k] cross-covariances and a
[k, k] solve (``torch.matmul`` and ``torch.linalg.solve_ex``, no host
read), as they are XLA in the JAX package. The ``lax.scan`` becomes a
Python loop on the model's device.

Any model with ``sample_initial(gen, (N,))`` and ``propagate(gen, x)``;
the observation operator defaults to the DLM's (F, V = V_chol V_chol')
and can be given.

``axis_name``, a ``parallel.mesh.ParticleAxis``, runs one rank's block of
``num_ensemble`` of ``num_ensemble_global`` members: the means and the
moment products are summed over the axis (the module's own ``pmean`` and
``psum``, ``enkf.py:40-43,83-131``), and each rank draws from its rank
stream (``parallel.mesh.make_streams``; ``key`` an int seed).
``parallel/enkf.sharded_ensemble_kalman_filter`` is the entry point that
sizes the block.

``draws`` replays given numbers (the JAX key schedule: ``k_init, k_scan =
split(key)``; per step ``k_prop, k_obs = split(fold_in(k_scan, t))``):
``{"init": noise of model.sample_initial, "steps": [(noise of
model.propagate, the perturbations' normals [N, k]), ...]}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from cusmc_tpu_torch.device import KeyLike, as_tensor, make_generator
from cusmc_tpu_torch.models.base import draw
from cusmc_tpu_torch.ops.random import normal
from cusmc_tpu_torch.parallel.mesh import make_streams, pmean, psum
from cusmc_tpu_torch.smc.particle_filter import model_device


@dataclass
class EnKFResult:
    """``means`` [T, d] analysis means; ``spread`` [T] the mean ensemble
    standard deviation (a collapse monitor); ``final_ensemble`` [N, d]."""

    final_ensemble: torch.Tensor
    means: torch.Tensor
    spread: torch.Tensor


def _gmean(x: torch.Tensor, axis, dim=0) -> torch.Tensor:
    """The mean over ``dim``, and over the particle axis when sharded."""
    return pmean(torch.mean(x, dim=dim), axis)


def ensemble_kalman_filter(
    key: KeyLike,
    model,
    ys,
    num_ensemble: int,
    inflation: float = 1.0,
    F=None,
    V=None,
    axis_name=None,
    num_ensemble_global: Optional[int] = None,
    device=None,
    draws: Optional[dict] = None,
) -> EnKFResult:
    """Run the stochastic EnKF on observations ``ys`` [T, k] (row 0 is the
    prior step). ``inflation`` >= 1 scales the forecast anomalies
    (multiplicative covariance inflation)."""
    n = num_ensemble
    n_global = num_ensemble_global or n
    dev = model_device(model, device)
    if axis_name is not None:
        gen = make_streams(key, axis_name, dev).rank
    else:
        gen = make_generator(key, dev)
    F = model.F if F is None else F
    V = model.V_chol @ model.V_chol.T if V is None else V
    F = as_tensor(F, device=dev)
    V = as_tensor(V, device=dev)
    v_chol = torch.linalg.cholesky_ex(V).L
    k_dim = F.shape[0]

    x = draw(model.sample_initial, gen, (n,),
             noise=None if draws is None else draws["init"])
    dtype = x.dtype
    ys = as_tensor(ys, dtype=dtype, device=dev)
    num_steps = ys.shape[0]
    means = torch.empty((num_steps, x.shape[-1]), dtype=dtype, device=dev)
    spread = torch.empty(num_steps, dtype=dtype, device=dev)

    def moments(xa, t):
        means[t] = _gmean(xa, axis_name)
        spread[t] = torch.sqrt(_gmean((xa - means[t][None, :]) ** 2,
                                      axis_name, dim=(0, 1)))

    moments(x, 0)
    denom = 1.0 / (n_global - 1)
    for t in range(1, num_steps):
        prop_d, z_obs = (None, None) if draws is None \
            else draws["steps"][t - 1]
        xf = draw(model.propagate, gen, x, noise=prop_d)
        mean_f = _gmean(xf, axis_name)
        A = (xf - mean_f[None, :]) * inflation          # [N, d] anomalies
        xf = mean_f[None, :] + A
        HX = xf @ F.T                                    # [N, k]
        AH = HX - _gmean(HX, axis_name)[None, :]
        s_hh = psum(AH.T @ AH, axis_name)
        s_xh = psum(A.T @ AH, axis_name)
        cov_hh = s_hh * denom + V                        # [k, k]
        cov_xh = s_xh * denom                            # [d, k]
        if z_obs is None:
            z_obs = normal(gen, (n, k_dim), dtype, dev)
        innov = (ys[t][None, :] + z_obs @ v_chol.T) - HX
        gain_t = torch.linalg.solve_ex(cov_hh, cov_xh.T).result  # [k, d]
        x = xf + innov @ gain_t
        moments(x, t)
    return EnKFResult(final_ensemble=x, means=means, spread=spread)
