"""Monotone prefix sum for the CDF-resampler weight pipeline.

Port of ``cusmc_tpu/ops/cumsum.py:45-122`` (``_cumsum_kernel`` behind
``blocked_cumsum``). On a CUDA tensor ``blocked_cumsum`` launches the
hand-written kernel ``csrc/cumsum.cu`` (a three-launch tile scan whose
output is monotone non-decreasing for non-negative weights); on a CPU
tensor it takes the plain version, ``torch.cumsum``. Any N >= 1 is taken:
the JAX kernel's N % 4096 limit was a TPU tiling limit.

``cdf128`` (the JAX kernel's 128-strided by-product, the TPU search's
coarse placement input) is returned as the strided view ``cdf[127::128]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels

FOLD = 128


def blocked_cumsum_plain(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``torch.cumsum`` and its 128-strided view."""
    cdf = torch.cumsum(w, dim=0)
    return cdf, cdf[FOLD - 1::FOLD]


def blocked_cumsum(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix sum of ``w`` [N] -> ``(cdf [N], cdf[127::128])``.

    CUDA: the kernel (float32, contiguous, N >= 1); CPU: the plain
    version. ``blocked_cumsum.launches`` counts kernel launches."""
    if not is_cuda(w, "blocked_cumsum"):
        return blocked_cumsum_plain(w)
    kernels.require(w, "w", torch.float32, 1, w.device)
    n = w.shape[0]
    if n < 1:
        raise ValueError("blocked_cumsum needs N >= 1")
    lib = kernels.library()
    tile = lib.cusmc_cumsum_tile()
    cdf = torch.empty_like(w)
    scratch = torch.empty(((n + tile - 1) // tile,), dtype=torch.float32,
                          device=w.device)
    rc = lib.cusmc_blocked_cumsum(w.data_ptr(), cdf.data_ptr(),
                                  scratch.data_ptr(), n, kernels.stream_of(w))
    kernels.check(rc, "blocked_cumsum")
    blocked_cumsum.launches += 1
    return cdf, cdf[FOLD - 1::FOLD]


blocked_cumsum.launches = 0
