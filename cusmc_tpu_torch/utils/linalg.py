"""Covariance factorization helpers.

Port of ``cusmc_tpu/utils/linalg.py`` (``chol_sqrt`` with its jitter,
``eigh_sqrt``, ``cov_sqrt``, ``tri_solve``, ``tri_inverse``,
``log_det_from_chol``). Factors are computed once, when a model or a
log-density closure is built, never in the filter's step, so they run
wherever the input tensor lies.
"""

from __future__ import annotations

import torch


def chol_sqrt(cov: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower-triangular Cholesky factor L with L @ L.T == cov (+ jitter I
    when ``jitter`` is non-zero). On the card the factor comes from
    ``torch.linalg.cholesky_ex`` without a host read of its info flag, and
    a matrix that is not positive definite gives NaN, as JAX's cholesky
    does; on the CPU it raises."""
    if jitter:
        cov = cov + jitter * torch.eye(cov.shape[-1], dtype=cov.dtype,
                                       device=cov.device)
    if cov.device.type == "cuda":
        L, info = torch.linalg.cholesky_ex(cov)
        return torch.where(info[..., None, None] == 0, L, torch.nan)
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
    (``cusmc_tpu/utils/linalg.py:51-61``). Forward substitution over the d
    rows, each an elementwise pass over the batch: on the card
    ``torch.linalg.solve_triangular`` with 2^20 right-hand sides took
    minutes a call (PERF.md section 6), while d passes of [N] are what
    the batch layout's log-densities need."""
    zs = []
    for i in range(b.shape[-1]):
        acc = b[..., i]
        if i:
            acc = acc - torch.matmul(torch.stack(zs, -1), chol[i, :i])
        zs.append(acc / chol[i, i])
    return torch.stack(zs, -1)


def tri_inverse(chol: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a lower-triangular [d, d] factor
    (``cusmc_tpu/utils/linalg.py:64-77``): one solve when a density is
    built, so each evaluation is a product, not a triangular solve."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye, upper=False)


def log_det_from_chol(chol: torch.Tensor) -> torch.Tensor:
    """log|Sigma| from its Cholesky factor: 2 * sum(log diag L)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)),
                           dim=-1)
