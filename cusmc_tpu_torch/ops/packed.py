"""Packed (structure-of-arrays) particle ops: state is [d, N].

Port of ``cusmc_tpu/ops/packed.py:24-42``. The JAX package computes these
with XLA outside any Pallas kernel, so the port leaves them to
``torch.matmul`` (full float32: the package turns TF32 off on import).

Under mixed precision (bfloat16 operands) ``matvec`` multiplies in
float32 and rounds once to the output type, as XLA's bfloat16 matmul does
(the products of two bfloat16 values are exact in float32). A bfloat16
GEMM on the card may instead reduce in reduced precision
(``allow_bf16_reduced_precision_reduction``), so the port never runs one.
"""

from __future__ import annotations

from typing import Optional

import torch


def matvec(A: torch.Tensor, X: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[m, d] @ [d, N] -> [m, N] batched over particles (or any
    ``torch.matmul`` shapes, as in ``x @ G.T`` of the batch layout).
    ``out_dtype`` (None: X's type) is the output type; a bfloat16 operand
    is widened to float32, and the product rounded once to it. The one
    place of this rule in the port."""
    out_dtype = X.dtype if out_dtype is None else out_dtype
    if A.dtype == X.dtype == torch.float32:
        return torch.matmul(A, X).to(out_dtype)
    return torch.matmul(A.float(), X.float()).to(out_dtype)


def quadform(Linv: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """sum_j (Linv @ R)_j^2 over the state axis -> [N]: the Mahalanobis
    form of residuals R [k, N] given the inverse Cholesky factor."""
    Z = matvec(Linv, R)
    return torch.sum(Z * Z, dim=0)
