"""Multivariate Student-T: log-density and sampling on batched tensors.

Port of ``cusmc_tpu/distributions/mvt.py``: ``make_mvt_logprob``
(``:40-76``), ``mvt_logpdf``, ``mvt_logpdf_cov``, ``mvt_sample`` and
``mvt_sample_cov``. The normaliser
keeps the pi term, ``(pi * nu)^{-d/2}`` (``mvt.py:91-96``); the original
CUDA code's defect of leaving it out is not brought back.

``mvt_sample`` draws its chi-square with the port's own samplers
(``ops/random``: the exact integer-df construction, else the fixed-round
Marsaglia-Tsang sampler), because no torch gamma sampler takes an explicit
``torch.Generator``; the JAX function calls ``jax.random.gamma``. A sample
follows the scale's dtype (``mvn.py``); the chi-square and its
``sqrt(df / g)`` stay float32 and are cast once to the scale's dtype
(``mvt.py:119-131``). ``per_dim_chi=True`` is the reference's product-t:
one chi-square per component, applied after the linear map. ``noise=(z,
g)`` replaces the draws with given normals and chi-square variates, so
that tests can hand in what ``jax.random.gamma`` drew.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cusmc_tpu_torch.ops.packed import matvec
from cusmc_tpu_torch.ops.random import chi2_draws, chi2_transform, \
    integer_df, normal
from cusmc_tpu_torch.distributions.mvn import PRECISIONS
from cusmc_tpu_torch.utils.linalg import cov_sqrt, log_det_from_chol, \
    tri_inverse, tri_solve


def mvt_log_norm(df: float, d: int, log_det: torch.Tensor) -> torch.Tensor:
    """lgamma((nu+d)/2) - lgamma(nu/2) - (d/2) log(nu*pi) - (1/2) log|Sigma|,
    evaluated in the dtype of ``log_det``."""
    df_t = torch.as_tensor(df, dtype=log_det.dtype, device=log_det.device)
    return (torch.lgamma(0.5 * (df_t + d)) - torch.lgamma(0.5 * df_t)
            - 0.5 * d * (torch.log(df_t) + math.log(math.pi))
            - 0.5 * log_det)


def make_mvt_logprob(mean, cov, df, precision: str = "highest"):
    """Closure evaluating log MVT(x; mean, cov, df) for x [..., d], with
    the Cholesky factor's inverse and the normaliser computed once."""
    if precision not in PRECISIONS:
        raise KeyError(precision)
    mean = torch.as_tensor(mean)
    L = cov_sqrt(torch.as_tensor(cov, dtype=mean.dtype,
                                 device=mean.device), "cholesky")
    Linv_t = tri_inverse(L).T
    d = mean.shape[-1]
    df_t = torch.as_tensor(df, dtype=mean.dtype, device=mean.device)
    log_norm = (torch.lgamma(0.5 * (df_t + d)) - torch.lgamma(0.5 * df_t)
                - 0.5 * d * (torch.log(df_t) + math.log(math.pi))
                - 0.5 * log_det_from_chol(L))

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        z = torch.matmul(x - mean, Linv_t)
        quad = torch.sum(z * z, dim=-1)
        return log_norm - 0.5 * (df_t + d) * torch.log1p(quad / df_t)

    return log_prob


def mvt_logpdf(x: torch.Tensor, mean, scale_tril: torch.Tensor,
               df) -> torch.Tensor:
    """log MVT(x; mean, Sigma = L L^T, nu) for batched x [..., d]."""
    d = x.shape[-1]
    z = tri_solve(scale_tril, x - mean)
    quad = torch.sum(z * z, dim=-1)
    log_norm = mvt_log_norm(float(df), d, log_det_from_chol(scale_tril))
    return log_norm - 0.5 * (float(df) + d) * torch.log1p(quad / float(df))


def mvt_logpdf_cov(x: torch.Tensor, mean, cov: torch.Tensor,
                   df) -> torch.Tensor:
    return mvt_logpdf(x, mean, cov_sqrt(cov, "cholesky"), df)


def mvt_sample(gen: Optional[torch.Generator], mean: torch.Tensor,
               scale: torch.Tensor, df, shape: tuple = (),
               per_dim_chi: bool = False,
               noise: Optional[tuple] = None) -> torch.Tensor:
    """Draw from MVT(mean, Sigma = scale scale^T, df), shape
    ``shape + (d,)``: ``x = mean + (scale @ z) * sqrt(df / g)`` with one
    ``g ~ chi2(df)`` per sample vector (``per_dim_chi``: one per
    component). ``noise=(z, g)``: z [shape + (d,)] in the scale's dtype and
    g [shape + (1,)] (or ``(d,)``) float32, in place of the draws."""
    d = scale.shape[-1]
    shape = tuple(shape)
    df, df_int = float(df), integer_df(df)
    if noise is None:
        z = normal(gen, shape + (d,), scale.dtype, scale.device)
        gshape = shape + ((d,) if per_dim_chi else (1,))
        g = chi2_transform(df, df_int, chi2_draws(
            gen, df, df_int, gshape, torch.float32, scale.device))
    else:
        z, g = noise
    lz = matvec(z, scale.T)
    # torch.div, not ``df / g``: a Python scalar over a tensor is computed
    # as ``g.reciprocal() * df``, which rounds twice.
    df_t = torch.tensor(df, dtype=g.dtype, device=g.device)
    return mean + lz * torch.sqrt(torch.div(df_t, g)).to(scale.dtype)


def mvt_sample_cov(gen: Optional[torch.Generator], mean: torch.Tensor,
                   cov: torch.Tensor, df, shape: tuple = (),
                   method: str = "cholesky",
                   per_dim_chi: bool = False) -> torch.Tensor:
    return mvt_sample(gen, mean, cov_sqrt(cov, method), df, shape,
                      per_dim_chi)
