"""Counter-based random bits for the fused step kernels (Philox4x32-10).

The port's counterpart of ``pltpu.prng_seed`` / ``pltpu.prng_random_bits``
inside ``cusmc_tpu/ops/fused_step.py`` and ``ops/fused_cdf_step.py``. The
TPU's hardware generator cannot be reproduced, so the port fixes its own:
Philox4x32-10 (Salmon et al., SC'11, "Parallel random numbers: as easy as
1, 2, 3"), computed here with int64 tensor ops on any device and in
``csrc/philox.cuh`` inside the kernels. Both give the same bits.

Counter layout, shared by both files. The bits of one kernel call are a
pure function of (seed pair, block id, stream, row, lane):

- key = (seed[0], seed[1] ^ (block * 0x9E3779B9)), as uint32; the block mix
  is the JAX kernels' (``fused_step.py:158-159``), the int32 product
  wrapped to 32 bits;
- counter = (lane, row // 4, stream, 0); the call's four output words are
  rows 4 (row // 4) .. 4 (row // 4) + 3 of that lane, and ``row`` takes
  word ``row % 4``;
- stream 0 holds the per-particle rows, one lane per particle of the
  block; stream 1 holds the fused step's per-block scalars.

Every value is a uint32 carried in an int64 tensor. The 32x32 -> 64
multiply of a Philox round does not fit a signed int64, so it runs on
16-bit limbs (``_mulhilo``).
"""

from __future__ import annotations

from typing import Tuple

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
GOLDEN = 0x9E3779B9  # the per-block seed mix
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product m * b for uint32 ``m``
    and ``b`` (b in an int64 tensor), without overflowing int64."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    p_lo = b_lo * m          # < 2^48
    p_hi = b_hi * m          # < 2^48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = ROUNDS):
    """Philox4x32 on broadcastable int64 tensors holding uint32 values;
    returns the four output words."""
    for i in range(rounds):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def block_keys(seed: torch.Tensor, blocks: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k0, k1) for each block id: ``seed`` [2] int32, ``blocks`` [nb]
    int64 -> k0 0-dim, k1 [nb], uint32 values in int64."""
    s = seed.to(torch.int64) & MASK32
    mix = (blocks.to(torch.int64) * GOLDEN) & MASK32
    return s[0], s[1] ^ mix


def philox_bits(seed: torch.Tensor, blocks: torch.Tensor, stream: int,
                rows: int, lanes: torch.Tensor) -> torch.Tensor:
    """Rows 0 .. rows-1 of ``stream`` for every block and lane:
    int64 [rows, nb, L] of uint32 values, in the layout of the module
    docstring. ``seed`` [2] int32; ``blocks`` [nb] and ``lanes`` [L]
    integer tensors on the same device."""
    nb, nl = blocks.shape[0], lanes.shape[0]
    if rows <= 0:
        return torch.zeros((0, nb, nl), dtype=torch.int64,
                           device=seed.device)
    k0, k1 = block_keys(seed, blocks)
    groups = (rows + 3) // 4
    c0 = lanes.to(torch.int64).view(1, 1, nl)
    c1 = torch.arange(groups, dtype=torch.int64,
                      device=seed.device).view(groups, 1, 1)
    zero = torch.zeros((), dtype=torch.int64, device=seed.device)
    words = philox4x32(c0, c1, zero + stream, zero, k0, k1.view(1, nb, 1))
    shape = (groups, nb, nl)
    out = torch.stack([w.expand(shape) for w in words], dim=1)
    return out.reshape(4 * groups, nb, nl)[:rows]
