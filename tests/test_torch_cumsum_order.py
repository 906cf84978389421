"""The order of ``csrc/cumsum.cu``'s float32 arithmetic, emulated in numpy.

The kernel's tile scan (``tile_scan``) adds each thread's 16 items in
order, takes the thread prefixes from a shuffle tree within each warp and a
second one over the 16 warp totals, adds them, and raises every value to an
exact max-scan floor. The shuffle tree's prefix p of a thread can sit an
ulp above the previous thread's last value, so a thread whose leading
items have zero weight must give them the floor (bitwise the previous
thread's last value), not p + 0: otherwise the cdf steps up over a zero
weight, and an inverse-CDF draw can land on a zero-weight particle. The
emulation runs both orders on the same weights: the old one steps over
zeros, the kernel's does not. No kernel is imported; the card tests
(``tests/test_torch_cuda.py``) hold the kernel itself to flatness.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest

THREADS, ITEMS = 512, 16
TILE = THREADS * ITEMS
F32 = np.float32


def _warp_inclusive_sum(v):
    """cusmc::warp_inclusive_sum over the last axis (32 lanes): the
    Kogge-Stone tree of __shfl_up_sync, one float32 addition a level."""
    v = v.astype(F32).copy()
    for off in (1, 2, 4, 8, 16):
        up = np.zeros_like(v)
        up[..., off:] = v[..., :-off]
        lanes = np.arange(v.shape[-1]) >= off
        v = np.where(lanes, (v + up).astype(F32), v)
    return v


def _exclusive(incl):
    """The value of the lane before (__shfl_up_sync by 1), lane 0 zero."""
    ex = np.zeros_like(incl)
    ex[..., 1:] = incl[..., :-1]
    return ex


def _tile_scan(w, flat_zeros):
    """Local values [8192] and aggregate of one tile, in the kernel's
    float32 order; ``flat_zeros`` selects the kernel's rule for a
    thread's leading zeros (and its all-zero threads' max-scan entry),
    else the order before it."""
    items = w.reshape(THREADS, ITEMS).astype(F32)
    local = np.add.accumulate(items, axis=1, dtype=F32)  # sequential
    acc = local[:, -1]
    incl = _warp_inclusive_sum(acc.reshape(16, 32))
    excl = _exclusive(incl)
    warp_tot = np.zeros(32, F32)
    warp_tot[:16] = incl[:, 31]
    warp_excl = _exclusive(_warp_inclusive_sum(warp_tot))[:16]
    p = (warp_excl[:, None] + excl).astype(F32).reshape(THREADS)
    if flat_zeros:
        mine = np.where(acc == 0, F32(0), (p + acc).astype(F32))
        floor = np.maximum.accumulate(np.concatenate([[F32(0)], mine[:-1]]))
        vals = np.where(local == 0, floor[:, None],
                        np.maximum((p[:, None] + local).astype(F32),
                                   floor[:, None]))
    else:
        vals = (p[:, None] + local).astype(F32)
        last = vals[:, -1]
        floor = np.maximum.accumulate(
            np.concatenate([[F32(-np.inf)], last[:-1]]))
        vals = np.maximum(vals, floor[:, None])
    return vals.reshape(TILE), F32(vals.max())


def emulated_cumsum(w, flat_zeros=True):
    """The kernel's cdf of w [N] float32: each tile's local scan, the
    sequential tile prefix S(b+1) = S(b) + agg(b), then max(excl + local,
    excl)."""
    n = w.shape[0]
    tiles = -(-n // TILE)
    padded = np.zeros(tiles * TILE, F32)
    padded[:n] = w
    out = np.empty_like(padded)
    excl = F32(0)
    for b in range(tiles):
        vals, agg = _tile_scan(padded[b * TILE:(b + 1) * TILE], flat_zeros)
        out[b * TILE:(b + 1) * TILE] = np.maximum((excl + vals).astype(F32),
                                                  excl)
        excl = F32(excl + agg)
    return out[:n]


def zero_steps(w, cdf):
    """Places where the cdf moves over a zero weight (cdf[0] != 0 counts
    where w[0] == 0)."""
    steps = int(np.sum((cdf[1:] != cdf[:-1]) & (w[1:] == 0)))
    return steps + int(w[0] == 0 and cdf[0] != 0)


def _half_zeroed_uniform(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.random(n, dtype=F32)
    w[rng.random(n) < 0.5] = 0
    return w


@pytest.mark.parametrize("seed", [0, 1])
def test_old_order_steps_over_zeros_and_the_kernels_does_not(seed):
    w = _half_zeroed_uniform(1 << 16, seed)
    old = emulated_cumsum(w, flat_zeros=False)
    new = emulated_cumsum(w)
    steps = np.nonzero((old[1:] != old[:-1]) & (w[1:] == 0))[0] + 1
    assert steps.size > 0
    assert np.all(steps % ITEMS == 0)  # always a thread's first item
    assert zero_steps(w, new) == 0
    assert np.all(np.diff(old) >= 0) and np.all(np.diff(new) >= 0)
    # The fix only lowers values, to a floor the old order also had.
    assert np.all(new <= old)
    moved = new != old
    assert np.all(np.abs(new[moved] - old[moved])
                  <= 4 * np.spacing(np.abs(old[moved])))


@pytest.mark.parametrize("case", ["all-zero-threads", "zero-tiles",
                                  "leading-zeros"])
def test_kernel_order_is_flat_monotone_and_within_its_bound(case):
    rng = np.random.default_rng(3)
    n = 3 * TILE + 77
    w = rng.random(n, dtype=F32)
    i = np.arange(n)
    if case == "all-zero-threads":     # whole threads and warps of zeros
        w[(i // ITEMS) % 3 != 0] = 0
        w[(i // (32 * ITEMS)) % 2 == 1] = 0
    elif case == "zero-tiles":         # a whole tile, and the head, zero
        w[TILE:2 * TILE] = 0
        w[:5] = 0
    else:                              # leading zeros in every thread
        w[(i % ITEMS) < 7] = 0
    cdf = emulated_cumsum(w)
    ref = np.cumsum(w.astype(np.float64))
    k = 26 + -(-n // TILE)
    u = 2.0 ** -24
    assert zero_steps(w, cdf) == 0
    assert np.all(np.diff(cdf) >= 0)
    assert np.max(np.abs(cdf - ref)) <= k * u / (1 - k * u) * ref[-1]
