"""Multivariate normal: log-density and sampling on batched tensors.

Port of ``cusmc_tpu/distributions/mvn.py``: ``make_mvn_logprob``
(``:38-67``), ``mvn_logpdf``, ``mvn_logpdf_cov``, ``mvn_sample`` and
``mvn_sample_cov``. Log-space throughout, like the JAX package. A sample
follows the scale's dtype: in
bfloat16 its normals take ``jax.random.normal``'s bfloat16 law
(``ops/random.normal``) and the product is taken in float32 and rounded
once, as XLA computes it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cusmc_tpu_torch.ops.packed import matvec
from cusmc_tpu_torch.ops.random import normal
from cusmc_tpu_torch.utils.linalg import cov_sqrt, log_det_from_chol, \
    tri_inverse, tri_solve

_LOG_2PI = math.log(2.0 * math.pi)
# The JAX closures' matmul precisions. The port's products are full
# float32 under both (the package turns TF32 off); the key is checked.
PRECISIONS = ("highest", "default")


def make_mvn_logprob(mean, cov, precision: str = "highest"):
    """Closure evaluating log N(x; mean, cov) for x [..., d], with the
    Cholesky factor's inverse and the normaliser computed once: each call
    is one product ``(x - mean) @ Linv.T`` and a row sum."""
    if precision not in PRECISIONS:
        raise KeyError(precision)
    mean = torch.as_tensor(mean)
    L = cov_sqrt(torch.as_tensor(cov, dtype=mean.dtype,
                                 device=mean.device), "cholesky")
    Linv_t = tri_inverse(L).T
    d = mean.shape[-1]
    const = -0.5 * (d * _LOG_2PI + log_det_from_chol(L))

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        z = torch.matmul(x - mean, Linv_t)
        return const - 0.5 * torch.sum(z * z, dim=-1)

    return log_prob


def mvn_logpdf(x: torch.Tensor, mean, scale_tril: torch.Tensor) -> torch.Tensor:
    """log N(x; mean, L L^T) for batched x [..., d]."""
    d = x.shape[-1]
    z = tri_solve(scale_tril, x - mean)
    quad = torch.sum(z * z, dim=-1)
    return -0.5 * (quad + d * _LOG_2PI + log_det_from_chol(scale_tril))


def mvn_logpdf_cov(x: torch.Tensor, mean, cov: torch.Tensor) -> torch.Tensor:
    return mvn_logpdf(x, mean, cov_sqrt(cov, "cholesky"))


def mvn_sample(gen: Optional[torch.Generator], mean: torch.Tensor,
               scale: torch.Tensor, shape: tuple = (),
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x = mean + scale @ z with z ~ N(0, I), shape ``shape + (d,)``;
    ``z`` replaces the draw when given."""
    d = scale.shape[-1]
    if z is None:
        z = normal(gen, tuple(shape) + (d,), scale.dtype, scale.device)
    return mean + matvec(z, scale.T)


def mvn_sample_cov(gen: Optional[torch.Generator], mean: torch.Tensor,
                   cov: torch.Tensor, shape: tuple = (),
                   method: str = "cholesky") -> torch.Tensor:
    return mvn_sample(gen, mean, cov_sqrt(cov, method), shape)
