"""Covariance factorization helpers.

Port of ``cusmc_tpu/utils/linalg.py:19-50`` (``chol_sqrt``, ``eigh_sqrt``,
``cov_sqrt``). Factors are computed once when a model is built, never in
the filter's step, so they run wherever the input tensor lies.
"""

from __future__ import annotations

import torch


def chol_sqrt(cov: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor L with L @ L.T == cov."""
    return torch.linalg.cholesky(cov)


def eigh_sqrt(cov: torch.Tensor) -> torch.Tensor:
    """Symmetric eigendecomposition square root ``U @ sqrt(diag(w))``;
    any PSD matrix works (eigenvalues clipped at 0). Not triangular."""
    w, u = torch.linalg.eigh(cov)
    w = torch.clamp(w, min=0.0)
    return u * torch.sqrt(w)[..., None, :]


def cov_sqrt(cov: torch.Tensor, method: str = "cholesky") -> torch.Tensor:
    """Factor ``cov`` into Q with Q @ Q.T == cov; method "cholesky"
    (requires PD) or "eigh" (PSD-robust)."""
    if method == "cholesky":
        return chol_sqrt(cov)
    if method == "eigh":
        return eigh_sqrt(cov)
    raise ValueError(f"unknown cov sqrt method: {method!r}")


def tri_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L z = b for z with L lower triangular [d, d]; b is [..., d]
    (``cusmc_tpu/utils/linalg.py:51-61``)."""
    batch = b.shape[:-1]
    d = b.shape[-1]
    flat = b.reshape(-1, d)
    z = torch.linalg.solve_triangular(chol, flat.T, upper=False)
    return z.T.reshape(*batch, d)


def log_det_from_chol(chol: torch.Tensor) -> torch.Tensor:
    """log|Sigma| from its Cholesky factor: 2 * sum(log diag L)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                           dim=-1)
