"""Packed (structure-of-arrays) particle ops: state is [d, N].

Port of ``cusmc_tpu/ops/packed.py:24-42``. The JAX package computes these
with XLA outside any Pallas kernel, so the port leaves them to
``torch.matmul`` (full float32: the package turns TF32 off on import).
"""

from __future__ import annotations

import torch


def matvec(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """[m, d] @ [d, N] -> [m, N] batched over particles."""
    return torch.matmul(A, X)


def quadform(Linv: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """sum_j (Linv @ R)_j^2 over the state axis -> [N]: the Mahalanobis
    form of residuals R [k, N] given the inverse Cholesky factor."""
    Z = matvec(Linv, R)
    return torch.sum(Z * Z, dim=0)
