"""Roll-Metropolis resampling in packed [d, N] layout.

Port of ``cusmc_tpu/resampling/rolls.py:57-157``: sweep b proposes ancestor
j = (i + s_b) mod N for every chain i with one shared random shift per
sweep, and chain i accepts iff ``u[b, i] * w_cur < w[j]`` (strict, f32, so
a 0/0 pair rejects). ``jnp.roll(w, -s)[i] == w[(i + s) mod N]``.

- ``roll_metropolis_weight_walk``, ``apply_winning_rolls`` and
  ``winning_ancestors`` are the JAX functions in torch; together they are
  the plain version of the kernel.
- ``roll_metropolis_sweeps_expspace(w, shifts, u, X)`` launches the
  hand-written kernel ``csrc/rolls.cu`` on a CUDA tensor and takes the
  plain version on a CPU tensor. The state ``X`` is float32 or bfloat16
  (mixed precision); the weights, the uniforms and the walk are float32
  either way, and the apply copies the winners' values exactly.
- ``roll_band_rows`` plans the kernel's apply from (N, d, the state's
  bytes, the card's L2 bytes): one pass (walk, apply and ancestors) while
  X fits ``ROLL_ONE_PASS_SHARE`` of L2, else the walk with the first band
  of rows, then the other bands, each band fitting ``ROLL_BAND_SHARE`` of
  L2; ``roll_metropolis_sweeps_in_bands`` runs the kernel with a given band
  size.
- ``roll_metropolis_draws`` makes the draws: ``shifts`` from
  ``torch.randint(0, N, (B,))`` and ``u`` from ``torch.rand((B, N))``,
  both on the run's Generator, mirroring ``rolls.py:66-73``.
- ``auto_num_steps`` is the ESS bucket of ``num_steps="auto"``
  (``rolls.py:120-157``): B, ceil(B/2) or ceil(B/4) sweeps.
- ``roll_metropolis_sweeps`` takes log weights (``rolls.py:40-54``): it
  exponentiates ``logw - max(logw)`` and runs the same kernel, so its
  accept decisions equal the exp-space walk's up to that rounding.
  ``roll_metropolis_resample_op`` (``:160-175``) is the generic filter
  step's packed metropolis op, ``num_steps="auto"`` included.
- ``systematic_ancestors_sortfree`` (``:178-195``) is systematic
  resampling; its rank-by-merge is a TPU workaround for ``searchsorted``,
  so the port searches, as ``classic.systematic_ancestors`` does.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels
from cusmc_tpu_torch.resampling.classic import systematic_ancestors
from cusmc_tpu_torch.utils.timing import host_scalar

MAX_SWEEPS = 4096  # the kernel keeps the shifts in shared memory
MAX_BANDS = 65535  # the banded apply's grid.y
# The shares of the card's L2 that X may fill for the one-pass kernel, and
# that one band of the banded apply may fill; the rest holds the uniforms'
# and the output's streams, the ancestors and whatever else is resident.
ROLL_ONE_PASS_SHARE = 0.4
ROLL_BAND_SHARE = 1 / 6


def roll_metropolis_draws(gen: Optional[torch.Generator], n: int,
                          num_steps: int, device=None,
                          dtype=torch.float32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shifts [B] int32 in [0, n), u [B, n] uniforms)."""
    shifts = torch.randint(0, n, (num_steps,), generator=gen,
                           dtype=torch.int32, device=device)
    u = torch.rand((num_steps, n), generator=gen, dtype=dtype, device=device)
    return shifts, u


def _rolled_index(n: int, s: torch.Tensor, device) -> torch.Tensor:
    """(i + s) mod n for i < n: the source index of ``roll(x, -s)``."""
    return torch.remainder(torch.arange(n, device=device) + s.long(), n)


def roll_metropolis_weight_walk(w: torch.Tensor, shifts: torch.Tensor,
                                u: torch.Tensor) -> torch.Tensor:
    """The weight walk without touching the state: b_win [N] int32, the
    last accepted sweep of each chain (-1 = kept itself)."""
    n = w.shape[-1]
    w_cur = w
    b_win = torch.full((n,), -1, dtype=torch.int32, device=w.device)
    for b in range(shifts.shape[0]):
        w_cand = w[_rolled_index(n, shifts[b], w.device)]
        acc = u[b] * w_cur < w_cand
        w_cur = torch.where(acc, w_cand, w_cur)
        b_win = torch.where(acc, torch.full_like(b_win, b), b_win)
    return b_win


def apply_winning_rolls(X: torch.Tensor, b_win: torch.Tensor,
                        shifts: torch.Tensor) -> torch.Tensor:
    """X[:, a] as a (B+1)-way select over rolled copies of X."""
    n = X.shape[-1]
    x_f = X
    for b in range(shifts.shape[0]):
        rolled = X[:, _rolled_index(n, shifts[b], X.device)]
        x_f = torch.where((b_win == b)[None, :], rolled, x_f)
    return x_f


def winning_ancestors(b_win: torch.Tensor,
                      shifts: torch.Tensor) -> torch.Tensor:
    """a_i = (i + s_{b_win[i]}) mod n, int32."""
    n = b_win.shape[0]
    a_f = torch.arange(n, dtype=torch.int64, device=b_win.device)
    for b in range(shifts.shape[0]):
        j = _rolled_index(n, shifts[b], b_win.device)
        a_f = torch.where(b_win == b, j, a_f)
    return a_f.to(torch.int32)


def roll_metropolis_sweeps_expspace_plain(w: torch.Tensor,
                                          shifts: torch.Tensor,
                                          u: torch.Tensor, X: torch.Tensor
                                          ) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The plain version: the three functions above."""
    b_win = roll_metropolis_weight_walk(w, shifts, u)
    return apply_winning_rolls(X, b_win, shifts), winning_ancestors(b_win,
                                                                    shifts)


def roll_band_rows(n: int, d: int, itemsize: int, l2_bytes: int) -> int:
    """Rows a band of the kernel's apply copies for a state X [d, n] of
    ``itemsize``-byte values on a card with ``l2_bytes`` of L2: d (one
    pass) when X fits ``ROLL_ONE_PASS_SHARE`` of L2, else as many as fit
    ``ROLL_BAND_SHARE`` of it (at least 1), balanced so that the last band
    is not much shorter than the others."""
    if d * n * itemsize <= ROLL_ONE_PASS_SHARE * l2_bytes:
        return d
    fit = max(1, int(ROLL_BAND_SHARE * l2_bytes) // max(1, n * itemsize))
    bands = -(-d // fit)
    return -(-d // bands)


def roll_bands(d: int, band_rows: int) -> List[Tuple[int, int]]:
    """The row ranges ``[r0, r1)`` the kernel copies, one a band in launch
    order (band_rows >= d: one pass over all d rows)."""
    if band_rows >= d:
        return [(0, d)]
    return [(r, min(d, r + band_rows)) for r in range(0, d, band_rows)]


def roll_path(band_rows: int, d: int) -> str:
    """"one-pass" (walk, apply and ancestors in one launch) or "banded"
    (the walk with band 0, then the other bands: two launches)."""
    return "one-pass" if band_rows >= d else "banded"


@functools.lru_cache(maxsize=None)
def _l2_bytes(index: int) -> int:
    return torch.cuda.get_device_properties(index).L2_cache_size


def l2_bytes(device: torch.device) -> int:
    """The L2 bytes of a CUDA ``device``."""
    return _l2_bytes(torch.cuda.current_device() if device.index is None
                     else device.index)


def roll_metropolis_sweeps_in_bands(w: torch.Tensor, shifts: torch.Tensor,
                                    u: torch.Tensor, X: torch.Tensor,
                                    band_rows: Optional[int] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``roll_metropolis_sweeps_expspace`` with the apply's band size
    given: ``band_rows`` rows a band (d or more: one pass; None: the plan
    ``roll_band_rows`` for this card). The result does not depend on it.
    CUDA: the kernel, one call counted; CPU: the plain version."""
    if not is_cuda(w, "roll_metropolis_sweeps_expspace"):
        return roll_metropolis_sweeps_expspace_plain(w, shifts, u, X)
    dev = w.device
    kernels.require(w, "w", torch.float32, 1, dev)
    kernels.require(shifts, "shifts", torch.int32, 1, dev)
    kernels.require(u, "u", torch.float32, 2, dev)
    bf16 = kernels.require_state(X, "X", dev)
    n = w.shape[0]
    num_steps = shifts.shape[0]
    d = X.shape[0]
    if n < 1 or X.shape[1] != n or tuple(u.shape) != (num_steps, n):
        raise ValueError(f"shapes do not match: w [{n}], shifts "
                         f"[{num_steps}], u {tuple(u.shape)}, X "
                         f"{tuple(X.shape)}")
    if num_steps > MAX_SWEEPS:
        raise ValueError(f"at most {MAX_SWEEPS} sweeps, got {num_steps}")
    if band_rows is None:
        band_rows = roll_band_rows(n, d, X.element_size(), l2_bytes(dev))
    band_rows = min(band_rows, d)
    if d and (band_rows < 1 or -(-d // band_rows) > MAX_BANDS):
        raise ValueError(f"band_rows {band_rows}: need 1 to {MAX_BANDS} "
                         f"bands of d = {d} rows")
    lib = kernels.library()
    out = torch.empty_like(X)
    a = torch.empty((n,), dtype=torch.int32, device=dev)
    rc = lib.cusmc_roll_metropolis(
        w.data_ptr(), shifts.data_ptr(), u.data_ptr(), X.data_ptr(),
        out.data_ptr(), a.data_ptr(), n, num_steps, d, bf16, band_rows,
        kernels.stream_of(w))
    kernels.check(rc, "roll_metropolis_sweeps_expspace")
    if bf16:
        roll_metropolis_sweeps_expspace.bf16_launches += 1
    else:
        roll_metropolis_sweeps_expspace.launches += 1
    return out, a


def roll_metropolis_sweeps_expspace(w: torch.Tensor, shifts: torch.Tensor,
                                    u: torch.Tensor, X: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B roll-Metropolis sweeps over exp-space weights ``w`` [N] with
    ``shifts`` [B] and uniforms ``u`` [B, N]; returns ``(X[:, a], a)`` for
    packed ``X`` [d, N] (float32 or bfloat16). CUDA: the kernel, in one
    pass or banded as ``roll_band_rows`` plans it for the card; CPU: the
    plain version. ``roll_metropolis_sweeps_expspace.launches`` counts
    kernel calls on a float32 state, ``.bf16_launches`` on a bfloat16 one
    (one a call; a banded call is two CUDA launches)."""
    return roll_metropolis_sweeps_in_bands(w, shifts, u, X)


roll_metropolis_sweeps_expspace.launches = 0
roll_metropolis_sweeps_expspace.bf16_launches = 0


def auto_num_steps(w: torch.Tensor, num_steps: int = 10) -> int:
    """Sweep count of ``num_steps="auto"`` from the Kish ESS ratio:
    ess/N <= 0.5 -> B, <= 0.75 -> ceil(B/2), else ceil(B/4). Reads one
    scalar back to the host (``host_scalar``)."""
    n = w.shape[-1]
    s1 = torch.sum(w)
    s2 = torch.sum(w * w)
    ratio = host_scalar(s1 * s1 / (s2 * n))
    counts = sorted({num_steps, -(-num_steps // 2), -(-num_steps // 4)},
                    reverse=True)
    idx = int(ratio > 0.5) + int(ratio > 0.75)
    return counts[min(idx, len(counts) - 1)]


def roll_metropolis_sweeps(logw: torch.Tensor, shifts: torch.Tensor,
                           u: torch.Tensor, X: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``roll_metropolis_sweeps_expspace`` from unnormalised log weights:
    ``w = exp(logw - max(logw))``, the shift keeping exp in range (the
    ratios are shift-invariant)."""
    return roll_metropolis_sweeps_expspace(torch.exp(logw - torch.max(logw)),
                                           shifts, u, X)


class RollMetropolisResampleOp:
    """The packed-layout op of the generic filter step:
    ``draw(streams, logw)`` makes ``(shifts, u)`` from ``streams.rank``
    (B sweeps, or the ESS bucket of ``num_steps="auto"`` over base 10);
    ``op(X, logw, draws) -> (X[:, a], uniform log weights -log N, a)``."""

    def __init__(self, num_steps=10, num_particles: Optional[int] = None):
        self.num_steps = num_steps
        self.num_particles = num_particles

    def draw(self, streams, logw: torch.Tensor):
        n = logw.shape[-1]
        b = self.num_steps
        if b == "auto":
            b = auto_num_steps(torch.exp(logw - torch.max(logw)))
        return roll_metropolis_draws(streams.rank, n, b, logw.device,
                                     logw.dtype)

    def __call__(self, X: torch.Tensor, logw: torch.Tensor, draws):
        n = logw.shape[-1]
        x_anc, a = roll_metropolis_sweeps(logw, *draws, X)
        return x_anc, torch.full((n,), -math.log(self.num_particles or n),
                                 dtype=logw.dtype, device=logw.device), a


def roll_metropolis_resample_op(num_steps=10, num_particles: Optional[int]
                                = None) -> RollMetropolisResampleOp:
    """The packed metropolis op (see ``RollMetropolisResampleOp``)."""
    return RollMetropolisResampleOp(num_steps, num_particles)


def systematic_ancestors_sortfree(gen: Optional[torch.Generator],
                                  log_weights: torch.Tensor,
                                  u: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Systematic ancestors [N] int32: #{cdf <= (i + u) / N}, clipped to
    N-1, as the JAX rank-by-merge computes them (``u``: the offset)."""
    return systematic_ancestors(gen, log_weights, u)
