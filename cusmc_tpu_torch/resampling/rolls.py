"""Roll-Metropolis resampling in packed [d, N] layout.

Port of ``cusmc_tpu/resampling/rolls.py:57-157``: sweep b proposes ancestor
j = (i + s_b) mod N for every chain i with one shared random shift per
sweep, and chain i accepts iff ``u[b, i] * w_cur < w[j]`` (strict, f32, so
a 0/0 pair rejects). ``jnp.roll(w, -s)[i] == w[(i + s) mod N]``.

- ``roll_metropolis_weight_walk``, ``apply_winning_rolls`` and
  ``winning_ancestors`` are the JAX functions in torch; together they are
  the plain version of the kernel.
- ``roll_metropolis_sweeps_expspace(w, shifts, u, X)`` launches the
  hand-written kernel ``csrc/rolls.cu`` on a CUDA tensor (walk, apply and
  ancestors in one pass) and takes the plain version on a CPU tensor. The
  state ``X`` is float32 or bfloat16 (mixed precision); the weights, the
  uniforms and the walk are float32 either way, and the apply copies the
  winners' values exactly.
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

import math
from typing import Optional, Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels
from cusmc_tpu_torch.resampling.classic import systematic_ancestors

MAX_SWEEPS = 4096  # the kernel keeps the shifts in shared memory


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


def roll_metropolis_sweeps_expspace(w: torch.Tensor, shifts: torch.Tensor,
                                    u: torch.Tensor, X: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B roll-Metropolis sweeps over exp-space weights ``w`` [N] with
    ``shifts`` [B] and uniforms ``u`` [B, N]; returns ``(X[:, a], a)`` for
    packed ``X`` [d, N] (float32 or bfloat16). CUDA: the kernel; CPU: the
    plain version. ``roll_metropolis_sweeps_expspace.launches`` counts
    kernel launches on a float32 state, ``.bf16_launches`` on a bfloat16
    one."""
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
    lib = kernels.library()
    out = torch.empty_like(X)
    a = torch.empty((n,), dtype=torch.int32, device=dev)
    rc = lib.cusmc_roll_metropolis(
        w.data_ptr(), shifts.data_ptr(), u.data_ptr(), X.data_ptr(),
        out.data_ptr(), a.data_ptr(), n, num_steps, d, bf16,
        kernels.stream_of(w))
    kernels.check(rc, "roll_metropolis_sweeps_expspace")
    if bf16:
        roll_metropolis_sweeps_expspace.bf16_launches += 1
    else:
        roll_metropolis_sweeps_expspace.launches += 1
    return out, a


roll_metropolis_sweeps_expspace.launches = 0
roll_metropolis_sweeps_expspace.bf16_launches = 0


def auto_num_steps(w: torch.Tensor, num_steps: int = 10) -> int:
    """Sweep count of ``num_steps="auto"`` from the Kish ESS ratio:
    ess/N <= 0.5 -> B, <= 0.75 -> ceil(B/2), else ceil(B/4). Reads one
    scalar back to the host."""
    n = w.shape[-1]
    s1 = torch.sum(w)
    s2 = torch.sum(w * w)
    ratio = float(s1 * s1 / (s2 * n))
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
