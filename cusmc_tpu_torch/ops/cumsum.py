"""Monotone prefix sum for the CDF-resampler weight pipeline.

Port of ``cusmc_tpu/ops/cumsum.py:45-122`` (``_cumsum_kernel`` behind
``blocked_cumsum``). On a CUDA tensor ``blocked_cumsum`` launches the
hand-written kernel ``csrc/cumsum.cu`` (one launch: a single-pass scan with
decoupled look-back whose output is monotone non-decreasing for
non-negative weights and the same on every run); on a CPU tensor it takes
the plain version, ``torch.cumsum``. Any N >= 1 is taken: the JAX kernel's
N % 4096 limit was a TPU tiling limit.

The kernel's look-back state (a ticket counter and one status word per
tile) lives in a buffer kept per device and stream, zeroed once when it is
allocated (``ScanState``); each call tags its status words with a new
epoch, so no call resets anything. Each call then makes one ``torch.empty``
(the cdf) and one ctypes call.

``cdf128`` (the JAX kernel's 128-strided by-product, the TPU search's
coarse placement input) is returned as the strided view ``cdf[127::128]``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels

FOLD = 128
TILE = 8192             # elements per block of csrc/cumsum.cu (kTile)
EPOCH_LIMIT = 1 << 30   # the status words hold a 30-bit epoch


class ScanState:
    """The look-back state of one device and stream: an int64 buffer of
    1 + tiles words (the ticket counter, then the status words), the epoch
    of the last call and the tickets handed out so far. A call that needs
    more tiles than the buffer holds, or would reach ``EPOCH_LIMIT``,
    starts over on a fresh zeroed buffer."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.buf = torch.zeros((0,), dtype=torch.int64, device=self.device)
        self.epoch = 0
        self.tickets = 0

    def next_call(self, n: int) -> Tuple[torch.Tensor, int, int]:
        """(buffer, epoch, ticket base) for a call over ``n`` elements."""
        tiles = -(-n // TILE)
        if 1 + tiles > self.buf.numel() or self.epoch + 1 >= EPOCH_LIMIT:
            size = max(1 + tiles, 2 * self.buf.numel())
            self.buf = torch.zeros((size,), dtype=torch.int64,
                                   device=self.device)
            self.epoch = 0
            self.tickets = 0
        self.epoch += 1
        base = self.tickets
        self.tickets += tiles
        return self.buf, self.epoch, base


_states: Dict[Tuple[torch.device, int], ScanState] = {}


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
    stream = kernels.stream_of(w)
    key = (w.device, stream)
    state = _states.get(key)
    if state is None:
        state = _states[key] = ScanState(w.device)
    buf, epoch, base = state.next_call(n)
    cdf = torch.empty_like(w)
    rc = lib.cusmc_blocked_cumsum(w.data_ptr(), cdf.data_ptr(),
                                  buf.data_ptr(), buf.numel(), n, base,
                                  epoch, stream)
    if rc != 0:
        del _states[key]  # the counter did not move: start over
    kernels.check(rc, "blocked_cumsum")
    blocked_cumsum.launches += 1
    return cdf, cdf[FOLD - 1::FOLD]


blocked_cumsum.launches = 0
