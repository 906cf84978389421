"""Multivariate normal: log-density and sampling on batched tensors.

Port of ``cusmc_tpu/distributions/mvn.py:70-95`` (``mvn_logpdf``,
``mvn_sample``): what ``DLM`` and ``DLM.simulate`` need. Log-space
throughout, like the JAX package. A sample follows the scale's dtype: in
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
from cusmc_tpu_torch.utils.linalg import log_det_from_chol, tri_solve

_LOG_2PI = math.log(2.0 * math.pi)


def mvn_logpdf(x: torch.Tensor, mean, scale_tril: torch.Tensor) -> torch.Tensor:
    """log N(x; mean, L L^T) for batched x [..., d]."""
    d = x.shape[-1]
    z = tri_solve(scale_tril, x - mean)
    quad = torch.sum(z * z, dim=-1)
    return -0.5 * (quad + d * _LOG_2PI + log_det_from_chol(scale_tril))


def mvn_sample(gen: Optional[torch.Generator], mean: torch.Tensor,
               scale: torch.Tensor, shape: tuple = (),
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x = mean + scale @ z with z ~ N(0, I), shape ``shape + (d,)``;
    ``z`` replaces the draw when given."""
    d = scale.shape[-1]
    if z is None:
        z = normal(gen, tuple(shape) + (d,), scale.dtype, scale.device)
    return mean + matvec(z, scale.T)
