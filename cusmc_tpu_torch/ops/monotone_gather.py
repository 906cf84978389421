"""Fused inverse-CDF resample: ancestors and resampled state in one pass.

Port of ``cusmc_tpu/ops/monotone_gather.py::inverse_cdf_apply``
(``:648-768``, the ``_search_kernel`` at ``:277``), without the sharded
``local_base`` mode. On a CUDA tensor it launches ``csrc/monotone_gather.cu``
(one thread per sorted query, a binary search of the cdf in global memory,
then the d-row gather); on a CPU tensor it takes the plain version,
``torch.searchsorted`` and an index gather.

The JAX wrapper's coarse placement (an argsort over the 128-strided cdf)
and merge-path windows are TPU workarounds and are not ported. The other
kernels of the JAX module (``_search_only_kernel``, ``_take_kernel``) are
not on this path yet (ROADMAP, TPU kernels 3 and 4).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels


def inverse_cdf_apply_plain(cdf: torch.Tensor, positions: torch.Tensor,
                            X: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: searchsorted (right) clipped to N-1, gather."""
    n = cdf.shape[0]
    a = torch.searchsorted(cdf, positions.to(cdf.dtype), right=True)
    a = a.clamp_(max=n - 1)
    return X.index_select(1, a), a.to(torch.int32)


def inverse_cdf_apply(cdf: torch.Tensor, positions: torch.Tensor,
                      X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(X[:, a], a)`` with ``a[i] = #{j: cdf[j] <= positions[i]}``
    clipped to N-1, int32.

    ``cdf`` [N] is an inclusive weight cumsum, monotone, not necessarily
    normalised (scale ``positions`` by ``cdf[-1]``); ``positions`` [L]
    sorted; ``X`` [d, N] packed particles. CUDA: the kernel (float32,
    contiguous); CPU: the plain version. ``inverse_cdf_apply.launches``
    counts kernel launches."""
    if not is_cuda(cdf, "inverse_cdf_apply"):
        return inverse_cdf_apply_plain(cdf, positions, X)
    dev = cdf.device
    kernels.require(cdf, "cdf", torch.float32, 1, dev)
    kernels.require(positions, "positions", torch.float32, 1, dev)
    kernels.require(X, "X", torch.float32, 2, dev)
    n = cdf.shape[0]
    d = X.shape[0]
    nq = positions.shape[0]
    if X.shape[1] != n or n < 1:
        raise ValueError(f"X {tuple(X.shape)} does not match cdf [{n}]")
    lib = kernels.library()
    out = torch.empty((d, nq), dtype=X.dtype, device=dev)
    a = torch.empty((nq,), dtype=torch.int32, device=dev)
    if nq == 0:
        return out, a
    rc = lib.cusmc_inverse_cdf_apply(
        cdf.data_ptr(), positions.data_ptr(), X.data_ptr(), out.data_ptr(),
        a.data_ptr(), n, nq, d, kernels.stream_of(cdf))
    kernels.check(rc, "inverse_cdf_apply")
    inverse_cdf_apply.launches += 1
    return out, a


inverse_cdf_apply.launches = 0
