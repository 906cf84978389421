"""Distributed resampling over the particle axis.

Port of ``cusmc_tpu/parallel/resampling.py``: the weight side
(``_global_slots``, ``_to_exp``, ``_search_sorted_positions``,
``sharded_sorted_positions_fn``, ``make_sharded_ancestor_fn``,
``make_sorted_sharded_ancestor_fn``, ``_sorted_sharded_residual_fn``,
``:47-245``), the ring exchange of the CDF family and residual
(``ring_cdf_resample_op``, ``:248-449``), the sharded roll Metropolis
(``roll_metropolis_sharded_op``, ``:452-678``) and the all-gather op
(``allgather_resample_op``, ``:681-696``, the ring's oracle in the tests).

Weights are all-gathered (O(N) scalars); each rank derives the global
ancestors of its own L slots from them, through the kernels of
``ops/cumsum`` and ``ops/monotone_gather``; the states move only in [d, L]
blocks between ranks (``ParticleAxis.ppermute``), never as a global [d, N]
array. Every op returns global ancestor indices. A bfloat16 state moves
and is gathered in bfloat16; weights, cdfs and positions stay float32.

Each op is an object with ``draw(streams, w) -> draws`` (the layout of
``parallel.mesh``: ``streams.common`` is the same on every rank,
``streams.rank`` this rank's own) and ``op(X, w, draws, pred=None) ->
(x_anc, w_out, a)``. Tests hand in JAX's numbers as ``draws``.

Every rank issues the same collectives in the same order. The JAX ops run
their collectives unconditionally and gate only the local mining on traced
values; here the gates are host values that every rank shares, read from
replicated data: ``pred`` (from the all-reduced ESS), the ring's
``(a_min, a_max)`` table (one all-gather, one host read a step when P > 1)
and the Metropolis peers ``q`` (one host read a step when P > 1). ``pred``
False returns the identity at once, on every rank alike.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
from cusmc_tpu_torch.ops.monotone_gather import (
    inverse_cdf_apply,
    inverse_cdf_search,
    take_columns,
)
from cusmc_tpu_torch.ops.random import tiny_uniform
from cusmc_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    global_slots,
    ppermute,
)
from cusmc_tpu_torch.resampling.classic import (
    clamped_residual_values,
    residual_draws,
    sorted_from_uniforms,
)
from cusmc_tpu_torch.resampling.rolls import (
    auto_num_steps,
    roll_metropolis_draws,
    roll_metropolis_sweeps_expspace,
)


def _to_exp(logw_global: torch.Tensor) -> torch.Tensor:
    """Max-normalised exp weights from gathered log weights."""
    return torch.exp(logw_global - torch.max(logw_global))


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` as a true division (a tensor divisor: PyTorch divides a
    CUDA tensor by a Python scalar as a reciprocal multiply)."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def _pack(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """States [d, L] and float32 weights [L] as one block for one
    collective: [d+1, L] float32 for a float32 state; for a bfloat16
    state, its rows and the weights' 32 bits as two bfloat16 rows, [d+2,
    L], so that the state moves in its own type (JAX's concatenate
    promotes it to float32). The block is only moved and selected, never
    computed on, so ``_unpack`` gives the weights back bitwise."""
    if X.dtype == w.dtype:
        return torch.cat([X, w[None, :]], 0)
    halves = w.contiguous().view(X.dtype).reshape(-1, 2).T
    return torch.cat([X, halves], 0)


def _unpack(both: torch.Tensor, d: int):
    """``_pack``'s block [*, L] -> (states [d, L], weights [L])."""
    if both.shape[0] == d + 1:
        return both[:d], both[d]
    w = both[d:].T.contiguous().view(torch.float32).reshape(-1)
    return both[:d], w


def _fill(n_local: int, exp_in: bool, like: torch.Tensor,
          n_global: int) -> torch.Tensor:
    """Uniform weights after a resample: ones (exp), -log N (log)."""
    value = 1.0 if exp_in else -math.log(n_global)
    return torch.full((n_local,), value, dtype=like.dtype, device=like.device)


def _search_sorted_positions(w_g: torch.Tensor,
                             positions_01: torch.Tensor) -> torch.Tensor:
    """Global ancestors for unit positions over the gathered exp weights:
    the blocked cumsum and the search-only kernel."""
    cdf, _ = blocked_cumsum(w_g)
    return inverse_cdf_search(cdf, positions_01.to(cdf.dtype) * cdf[-1])


class _Drawn:
    """A function of draws: ``draw(streams, w) -> draws`` and
    ``fn(*args, draws)``."""

    def __init__(self, draw: Callable, fn: Callable):
        self.draw = draw
        self._fn = fn

    def __call__(self, *args):
        return self._fn(*args)


def sharded_sorted_positions_fn(name: str, axis, n_global: int,
                                n_local: int) -> _Drawn:
    """This rank's sorted unit positions [L]: ``fn(draws)``. Systematic
    shares one offset (common stream); stratified and multinomial draw per
    rank."""
    slots_of = (lambda dev: global_slots(n_local, axis, dev)
                .to(torch.float32))
    if name == "systematic":
        def draw(streams, w):
            return torch.rand((), generator=streams.common,
                              dtype=torch.float32, device=w.device)

        def fn(u):
            return _div(slots_of(u.device) + u, n_global)
    elif name == "stratified":
        def draw(streams, w):
            return torch.rand((n_local,), generator=streams.rank,
                              dtype=torch.float32, device=w.device)

        def fn(u):
            return _div(slots_of(u.device) + u, n_global)
    elif name == "multinomial":
        def draw(streams, w):
            return tiny_uniform(streams.rank, (n_local + 1,), torch.float32,
                                w.device)

        fn = sorted_from_uniforms
    else:
        raise KeyError(f"no sorted sharded position law for {name!r}")
    return _Drawn(draw, fn)


def make_sharded_ancestor_fn(name: str, axis, n_global: int, n_local: int,
                             num_steps: int = 10,
                             weights: str = "log") -> _Drawn:
    """``fn(w_g, draws) -> global ancestors [L]`` of this rank's slots from
    the gathered weights ``w_g`` [N] (log, or max-normalised exp with
    ``weights="exp"``). Multinomial draws iid (unsorted) uniforms from the
    rank stream; metropolis runs ``num_steps`` indexed sweeps with iid
    global proposals (rank stream)."""
    exp_in = weights == "exp"

    def wexp(w_g):
        return w_g if exp_in else _to_exp(w_g)

    if name in ("systematic", "stratified"):
        pos = sharded_sorted_positions_fn(name, axis, n_global, n_local)
        return _Drawn(pos.draw, lambda w_g, u: _search_sorted_positions(
            wexp(w_g), pos(u)))
    if name == "multinomial":
        def draw(streams, w):
            return torch.rand((n_local,), generator=streams.rank,
                              dtype=torch.float32, device=w.device)

        return _Drawn(draw, lambda w_g, u: _search_sorted_positions(
            wexp(w_g), u))
    if name == "metropolis":
        def draw(streams, w):
            j = torch.randint(0, n_global, (num_steps, n_local),
                              generator=streams.rank, device=w.device)
            u = torch.rand((num_steps, n_local), generator=streams.rank,
                           dtype=torch.float32, device=w.device)
            return j, u

        def fn(w_g, draws):
            j, u = draws
            wv = wexp(w_g)
            k = global_slots(n_local, axis, w_g.device).long()
            for b in range(j.shape[0]):
                jb = j[b].long()
                k = torch.where(u[b] * wv[k] < wv[jb], jb, k)
            return k.to(torch.int32)

        return _Drawn(draw, fn)
    raise KeyError(f"no sharded variant of resampler {name!r}")


def _sorted_sharded_residual_fn(axis, n_global: int, n_local: int,
                                exp_in: bool) -> _Drawn:
    """Sharded residual ancestors: global slot s takes the floor-count
    grid inverse while s < n_det, else the (s - n_det)-th remainder order
    statistic. Every rank draws the same global [N+1] uniforms (common
    stream) and searches only its own slots' queries: two search-only
    kernel calls. The stitched vector is sorted within each family only."""
    def draw(streams, w):
        return residual_draws(streams.common, n_global, torch.float32,
                              w.device)

    def fn(w_g, u):
        w = w_g if exp_in else _to_exp(w_g)
        dev = w.device
        nw = w * (torch.full((), float(n_global), dtype=w.dtype, device=dev)
                  / torch.sum(w))
        counts = torch.floor(nw)
        ccum, _ = blocked_cumsum(counts)
        n_det = torch.clamp(ccum[-1], max=n_global).to(torch.int32)
        rcdf, _ = blocked_cumsum(torch.clamp(nw - counts, min=0.0))
        slots_i = global_slots(n_local, axis, dev)
        slots = slots_i.to(w.dtype)
        p_det = torch.minimum(slots + 0.5, n_det.to(w.dtype) - 0.5)
        a_det = inverse_cdf_search(ccum, p_det)
        v = clamped_residual_values(u, n_det, rcdf[-1])
        # Slot s uses remainder draw v[(s - n_det) mod N]; the draws that
        # wrap belong to deterministic slots and are masked below.
        start = axis_index(axis) * n_local
        idx = torch.remainder(torch.arange(start, start + n_local,
                                           device=dev) - n_det.long(),
                              n_global)
        mask = slots_i < n_det
        v_mine = torch.where(mask, torch.zeros((), dtype=v.dtype,
                                               device=dev), v[idx])
        a_res = inverse_cdf_search(rcdf, v_mine)
        return torch.where(mask, torch.clamp(a_det, max=n_global - 1), a_res)

    return _Drawn(draw, fn)


def make_sorted_sharded_ancestor_fn(name: str, axis, n_global: int,
                                    n_local: int,
                                    weights: str = "log") -> _Drawn:
    """Like ``make_sharded_ancestor_fn`` but sorted per rank (within each
    family for residual): multinomial at per-rank sorted order statistics,
    residual by ``_sorted_sharded_residual_fn``."""
    if name in ("systematic", "stratified"):
        return make_sharded_ancestor_fn(name, axis, n_global, n_local,
                                        weights=weights)
    exp_in = weights == "exp"
    if name == "multinomial":
        pos = sharded_sorted_positions_fn(name, axis, n_global, n_local)
        return _Drawn(pos.draw, lambda w_g, u: _search_sorted_positions(
            w_g if exp_in else _to_exp(w_g), pos(u)))
    if name == "residual":
        return _sorted_sharded_residual_fn(axis, n_global, n_local, exp_in)
    raise KeyError(f"no sorted sharded variant of resampler {name!r}")


class RingCdfResampleOp:
    """CDF-family and residual resample op with O(L d) state memory
    (``ring_cdf_resample_op``). Packed [d, L] layout.

    1. Round 0 mines the rank's own block: fused into the local-block
       ``inverse_cdf_apply`` for systematic, stratified and multinomial;
       ``take_columns`` for residual.
    2. For P <= 2K + 1 (K = ``ring_window``) one forward ring of P - 1
       one-hop ``ppermute``s; else K forward and K backward hops, then a
       forward ring whose trip count F comes from the all-gathered
       ``(a_min, a_max)`` table, so all ranks agree on it.
    3. A round mines a passing block (``take_columns`` plus a mask) only
       if this rank's ancestor range meets it.

    ``with_stats=True`` adds a 4th output, the rounds mined on this rank.
    """

    def __init__(self, name: str, axis, n_global: int, n_local: int,
                 with_stats: bool = False, weights: str = "log",
                 ring_window: int = 2):
        if n_global % n_local:
            raise ValueError(f"N={n_global} is not a multiple of L="
                             f"{n_local}")
        self.name = name
        self.axis = axis
        self.n_global = n_global
        self.n_local = n_local
        self.with_stats = with_stats
        self.exp_in = weights == "exp"
        self.fused_local = name in ("systematic", "stratified",
                                    "multinomial")
        if self.fused_local:
            self._draws = sharded_sorted_positions_fn(name, axis, n_global,
                                                      n_local)
        else:
            self._draws = make_sorted_sharded_ancestor_fn(
                name, axis, n_global, n_local, weights=weights)
        self.num_shards = n_global // n_local
        self.K = max(int(ring_window), 1)
        self.span_bounded = self.num_shards > 2 * self.K + 1
        P = self.num_shards
        # Rank s+1 sends to s: after r forward rounds, rank p holds block
        # (p + r) % P.
        self.perm_fwd = [((s + 1) % P, s) for s in range(P)]
        self.perm_bwd = [((s - 1) % P, s) for s in range(P)]

    def draw(self, streams, w):
        return self._draws.draw(streams, w)

    def _ret(self, out, w_out, a, mined):
        return (out, w_out, a, mined) if self.with_stats else (out, w_out, a)

    def __call__(self, X: torch.Tensor, w: torch.Tensor, draws,
                 pred: Optional[bool] = None):
        L, P = self.n_local, self.num_shards
        if pred is not None and not bool(pred):
            return self._ret(X, w, global_slots(L, self.axis, w.device), 0)
        w_g = all_gather(w, self.axis)
        p = axis_index(self.axis)
        base0 = p * L
        if self.fused_local:
            cdf, _ = blocked_cumsum(w_g if self.exp_in else _to_exp(w_g))
            pos = self._draws(draws) * cdf[-1]
            vals0, a = inverse_cdf_apply(cdf, pos, X, local_base=base0)
        else:
            a = self._draws(w_g, draws)
        w_out = _fill(L, self.exp_in, w, self.n_global)
        if P == 1:  # every ancestor lies in the own block
            out = vals0 if self.fused_local else take_columns(X, a)
            return self._ret(out, w_out, a, 1)

        table = all_gather(torch.stack([torch.min(a), torch.max(a)]),
                           self.axis, tiled=False).tolist()
        a_min, a_max = table[p]

        def need(base):
            return a_max >= base and a_min < base + L

        def mine(out, blk, base):
            vals = take_columns(blk, torch.clamp(a - base, 0, L - 1))
            mask = (a >= base) & (a < base + L)
            return torch.where(mask[None, :], vals, out)

        def base_of(r):
            """Block held after r forward rounds, as a column base."""
            return ((p + r) % P) * L

        out, mined = X, 0
        if self.fused_local:
            mask = (a >= base0) & (a < base0 + L)
            out = torch.where(mask[None, :], vals0, X)
            mined += int(need(base0))
        elif need(base0):
            out, mined = mine(out, X, base0), mined + 1

        def round_(out, mined, blk, base):
            if need(base):
                return mine(out, blk, base), mined + 1
            return out, mined

        if not self.span_bounded:
            blk = X
            for r in range(1, P):
                blk = ppermute(blk, self.axis, self.perm_fwd)
                out, mined = round_(out, mined, blk, base_of(r))
        else:
            fwd = bwd = X
            for s in range(1, self.K + 1):
                fwd = ppermute(fwd, self.axis, self.perm_fwd)
                out, mined = round_(out, mined, fwd, base_of(s))
                bwd = ppermute(bwd, self.axis, self.perm_bwd)
                out, mined = round_(out, mined, bwd, base_of(P - s))
            # F: the largest forward distance in the uncovered gap
            # [K+1, P-K-1] that any rank's block range needs.
            bmin = [t[0] // L for t in table]
            bmax = [t[1] // L for t in table]
            far = [t for t in range(self.K + 1, P - self.K)
                   if any(lo <= (q + t) % P <= hi
                          for q, (lo, hi) in enumerate(zip(bmin, bmax)))]
            F = max(far, default=self.K)
            blk, r = fwd, self.K
            while r < F:
                blk = ppermute(blk, self.axis, self.perm_fwd)
                r += 1
                out, mined = round_(out, mined, blk, base_of(r))
        return self._ret(out, w_out, a, mined)


def ring_cdf_resample_op(name: str, axis, n_global: int, n_local: int,
                         with_stats: bool = False, weights: str = "log",
                         ring_window: int = 2) -> RingCdfResampleOp:
    """The ring exchange op for a CDF resampler or residual."""
    return RingCdfResampleOp(name, axis, n_global, n_local, with_stats,
                             weights, ring_window)


class RollMetropolisShardedOp:
    """Gather-free sharded Metropolis in packed [d, L] layout
    (``roll_metropolis_sharded_op``).

    - ``exchange="global"``: sweep b takes the block of rank (p + q_b) % P
      by one ``ppermute`` and rolls it by s_b (q_b, s_b common), so slot
      i's candidate is uniform over all N particles.
    - ``"binary"``: the same candidates moved by a doubling chain of
      ceil(log2 P) ``ppermute``s over the stacked [B, d+1, L] blocks;
      bitwise equal to "global".
    - ``"windowed"``: one rotated two-block window per step, B roll
      sweeps inside it (the roll kernel); biased when one weight
      dominates.
    - One rank with "global" or "binary": the single-device roll sweeps
      (the roll kernel) on the rank stream, ``num_steps="auto"`` allowed.

    Log weights (``weights="log"``) accept by ``log u < lw_cand - lw_cur``
    in the global exchanges and are max-normalised to exp space for the
    roll kernel."""

    def __init__(self, axis, n_global: int, n_local: int, num_steps=10,
                 exchange: str = "global", weights: str = "log",
                 base_steps: int = 10):
        if exchange not in ("global", "binary", "windowed"):
            raise KeyError(f"unknown exchange {exchange!r} "
                           f"(global, binary, windowed)")
        if num_steps == "auto" and (n_global != n_local
                                    or exchange == "windowed"):
            raise ValueError(
                "num_steps='auto' needs one shard with exchange='global'/"
                "'binary'; pass an integer sweep count otherwise")
        if n_global % n_local:
            raise ValueError(f"N={n_global} is not a multiple of L="
                             f"{n_local}")
        self.axis = axis
        self.n_global = n_global
        self.n_local = n_local
        self.num_steps = num_steps
        self.base_steps = base_steps
        self.exchange = exchange
        self.exp_in = weights == "exp"
        self.num_shards = n_global // n_local
        self.single = self.num_shards == 1 and exchange != "windowed"

    def _wexp(self, w):
        return w if self.exp_in else _to_exp(w)

    def draw(self, streams, w):
        L, B, dev = self.n_local, self.num_steps, w.device
        if self.single:
            b = (auto_num_steps(self._wexp(w), self.base_steps)
                 if B == "auto" else B)
            return roll_metropolis_draws(streams.rank, L, b, dev)
        P = self.num_shards
        if self.exchange == "windowed":
            q = torch.randint(0, P, (), generator=streams.common, device=dev)
            r = torch.randint(0, L, (), generator=streams.common, device=dev)
            return q, r, roll_metropolis_draws(streams.rank, L, B, dev)
        qs = torch.randint(0, P, (B,), generator=streams.common, device=dev)
        ss = torch.randint(0, L, (B,), generator=streams.common, device=dev)
        u = torch.rand((B, L), generator=streams.rank, device=dev)
        return qs, ss, u

    def _perm(self, shift: int):
        P = self.num_shards
        return [((s + shift) % P, s) for s in range(P)]

    def __call__(self, X: torch.Tensor, w: torch.Tensor, draws,
                 pred: Optional[bool] = None):
        L, N, P = self.n_local, self.n_global, self.num_shards
        dev = w.device
        slots = global_slots(L, self.axis, dev)
        if pred is not None and not bool(pred):
            return X, w, slots
        w_out = _fill(L, self.exp_in, w, N)
        if self.single:
            shifts, u = draws
            x_anc, a = roll_metropolis_sweeps_expspace(self._wexp(w), shifts,
                                                       u, X)
            return x_anc, w_out, a
        p = axis_index(self.axis)
        d = X.shape[0]
        both = _pack(X, w)  # [d+1, L] (a bfloat16 state: [d+2, L])
        iota = torch.arange(L, device=dev)
        if self.exchange == "windowed":
            q, r, (shifts, u) = draws
            qh = int(q)  # host read: the common peer
            window = torch.cat([ppermute(both, self.axis, self._perm(qh)),
                                ppermute(both, self.axis,
                                         self._perm((qh + 1) % P))], 1)
            x_rot, w_rot = _unpack(window[:, r.long() + iota], d)
            x_anc, a_loc = roll_metropolis_sweeps_expspace(
                self._wexp(w_rot.contiguous()), shifts, u,
                x_rot.contiguous())
            a = torch.remainder((p + qh) * L + a_loc.long() + r.long(), N)
            return x_anc, w_out, a.to(torch.int32)

        qs, ss, u = draws
        q_host = qs.tolist()  # host read: the common peers
        if self.exchange == "binary":
            stack = both[None].expand((len(q_host),) + both.shape)
            for kbit in range(max((P - 1).bit_length(), 1)):
                rotated = ppermute(stack.contiguous(), self.axis,
                                   self._perm((1 << kbit) % P))
                bit = ((qs >> kbit) & 1) == 1
                stack = torch.where(bit[:, None, None], rotated, stack)
        x_cur, w_cur, a_cur = X, w, slots
        for b, q in enumerate(q_host):
            cand = (stack[b] if self.exchange == "binary"
                    else ppermute(both, self.axis, self._perm(q)))
            idx = torch.remainder(iota + ss[b].long(), L)
            x_c, w_c = _unpack(cand[:, idx], d)  # slot i <- (i + s) % L
            if self.exp_in:
                acc = u[b] * w_cur < w_c
            else:
                acc = torch.log(u[b]) < w_c - w_cur
            w_cur = torch.where(acc, w_c, w_cur)
            x_cur = torch.where(acc[None, :], x_c, x_cur)
            j_new = (((p + q) % P) * L + idx).to(torch.int32)
            a_cur = torch.where(acc, j_new, a_cur)
        return x_cur, w_out, a_cur


def roll_metropolis_sharded_op(axis, n_global: int, n_local: int,
                               num_steps=10, exchange: str = "global",
                               weights: str = "log", base_steps: int = 10
                               ) -> RollMetropolisShardedOp:
    """The sharded Metropolis op (see ``RollMetropolisShardedOp``)."""
    return RollMetropolisShardedOp(axis, n_global, n_local, num_steps,
                                   exchange, weights, base_steps)


class AllGatherResampleOp:
    """Resample by all-gathered weights AND states (``allgather_resample_op``,
    batch [L, d] layout): O(N d) memory per rank, the ring's oracle in the
    tests. Resamplers with a sorted sharded law (systematic, stratified,
    multinomial, residual) use it, with the ring's draws, so the two ops
    differ only in how the states move; metropolis uses the indexed
    sweeps of ``make_sharded_ancestor_fn``."""

    def __init__(self, name: str, axis, n_global: int, n_local: int,
                 weights: str = "log", num_steps: int = 10):
        self.axis = axis
        self.n_global = n_global
        self.n_local = n_local
        self.exp_in = weights == "exp"
        if name == "metropolis":
            self._fn = make_sharded_ancestor_fn(name, axis, n_global,
                                                n_local, num_steps, weights)
        else:
            self._fn = make_sorted_sharded_ancestor_fn(
                name, axis, n_global, n_local, weights=weights)

    def draw(self, streams, w):
        return self._fn.draw(streams, w)

    def __call__(self, x: torch.Tensor, w: torch.Tensor, draws):
        a = self._fn(all_gather(w, self.axis), draws)
        x_g = all_gather(x, self.axis)  # [N, d]
        return (x_g.index_select(0, a.long()),
                _fill(self.n_local, self.exp_in, w, self.n_global), a)


def allgather_resample_op(name: str, axis, n_global: int, n_local: int,
                          weights: str = "log",
                          num_steps: int = 10) -> AllGatherResampleOp:
    """The all-gather op (see ``AllGatherResampleOp``)."""
    return AllGatherResampleOp(name, axis, n_global, n_local, weights,
                               num_steps)
