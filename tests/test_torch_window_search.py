"""PyTorch port, the block-window inverse-CDF search of ``csrc/common.cuh``
(``warp_upper_bound``, ``CdfWindow``, ``block_cdf_window``), which the
search-only kernel, the search-and-apply kernel and the fused inverse-CDF
step run on the card.

The kernels cannot run here, so this file emulates their search in torch,
step for step: a block's queries (128 or 256 of them) give ``pmin`` and
``pmax`` (the block's min and max, or its first and last query where the
positions rise with the slot, as in the fused step); two 32-ary warp
searches give ``lo`` and ``hi``; a stretch ``cdf[lo, hi)`` of at most W
floats is copied and searched by the branch-free ``upper_bound_k``, a
wider one is searched by it in place within ``[lo, hi)``, and a query
outside ``[pmin, pmax]`` searches the whole cdf.
The emulation is held exactly to ``torch.searchsorted(right=True)`` clipped
to N-1 and, for sorted queries, to the JAX package's
``inverse_cdf_search`` (interpret mode), on uniform, concentrated and
zero-run cdfs, float32 ties, last positions at or past ``cdf[-1]`` and
unsorted queries. The search-and-apply kernel's blocks (``apply_kernel``:
the search, padded past a ragged end, then the clipped local gather) are
held to ``inverse_cdf_apply_plain`` and, on sorted queries, to the JAX
``inverse_cdf_apply`` in both its modes. The card-side tests
(tests/test_torch_cuda.py) hold the kernels to the plain versions on the
same kinds of input.
"""

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_inputs import search_inputs

from cusmc_tpu.ops import monotone_gather as jmg
from cusmc_tpu_torch.ops import fused_cdf_step as fc
from cusmc_tpu_torch.ops import fused_step as fs
from cusmc_tpu_torch.ops.kernels import CDF_BLOCK, CDF_WINDOW, \
    SEARCH_BLOCK, SEARCH_WINDOW
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply_plain, \
    inverse_cdf_search, window_fit_share
from cusmc_tpu_torch.ops.philox import philox_bits


def upper_bound(cdf, lo, hi, p):
    """One thread's binary search per query (``cusmc::upper_bound``):
    ``lo + #{j in [lo, hi) : cdf[j] <= p}`` for int64 ``lo``, ``hi``."""
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        act = lo < hi
        mid = (lo + hi) >> 1
        le = cdf[mid.clamp(max=cdf.numel() - 1)] <= p
        lo = torch.where(act & le, mid + 1, lo)
        hi = torch.where(act & ~le, mid, hi)
    return lo


def upper_bound_k(cdf, lo, hi, p):
    """``cusmc::upper_bound_k``: the branch-free search of a thread's
    queries over one range, ``lo + #{j in [lo, hi) : cdf[j] <= p}`` for int
    ``lo``, ``hi``; every step's offset is a function of ``hi - lo`` only."""
    c = torch.full(p.shape, lo, dtype=torch.int64)
    if hi <= lo:
        return c
    length = hi - lo
    while length > 1:
        half = length >> 1
        c += torch.where(cdf[c + half] <= p, half, 0)
        length -= half
    return c + (cdf[c] <= p).long()


def warp_upper_bound(cdf, lo, hi, p):
    """``cusmc::warp_upper_bound``: the 32-ary search one warp runs, each
    round's ballot a prefix of the lanes."""
    lanes = torch.arange(32)
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        j = lo + (lanes + 1) * step - 1
        ballot = (j < hi) & (cdf[j.clamp(max=cdf.numel() - 1)] <= p)
        c = int(ballot.sum())
        assert bool(ballot[:c].all()), "the ballot is not a prefix"
        above = lo + (c + 1) * step - 1
        lo += c * step
        hi = min(hi, above)
    j = lo + lanes
    return lo + int(((j < hi) & (cdf[j.clamp(max=cdf.numel() - 1)]
                                 <= p)).sum())


def block_search(cdf, q, window, ends=False, block=None):
    """One block's window search (``block_cdf_window`` and
    ``CdfWindow::search``) of its queries ``q``: ``(ancestors int64, whether
    its stretch fit)``. ``ends``: the block's bounds are its first and last
    query. ``block``: the kernel's queries a block; a ragged block's
    missing queries then take its smallest, as a thread past the end does,
    and are searched too (the ancestors of all ``block`` slots come back)."""
    n = cdf.numel()
    if ends:
        pmin, pmax = float(q[0]), float(q[-1])
    else:  # fminf / fmaxf: a NaN is skipped
        ok = ~torch.isnan(q)
        pmin = float(q[ok].min()) if bool(ok.any()) else np.inf
        pmax = float(q[ok].max()) if bool(ok.any()) else -np.inf
    if block is not None:
        q = torch.cat([q, torch.full((block - q.numel(),), pmin,
                                     dtype=q.dtype)])
    lo, hi = (warp_upper_bound(cdf, 0, n, np.float32(v))
              for v in (pmin, pmax))
    fit = hi - lo <= window
    inside = (q >= pmin) & (q <= pmax)
    zeros = torch.zeros_like(q, dtype=torch.int64)
    if fit:
        win = cdf[lo:max(hi, lo)].clone()  # the shared-memory copy
        c = lo + upper_bound_k(win, 0, hi - lo, q)
    else:
        c = upper_bound_k(cdf, lo, hi, q)
    whole = upper_bound(cdf, zeros, zeros + n, q)
    return torch.where(inside, c, whole).clamp(max=n - 1), fit


def window_search(cdf, pos, block, window, ends=False):
    """The block-window search of a kernel whose blocks take ``block``
    consecutive queries: ``(ancestors int64, blocks whose stretch fit)``.
    ``ends``: the block's bounds are its first and last query."""
    out = torch.empty(pos.numel(), dtype=torch.int64)
    fits = []
    for b0 in range(0, pos.numel(), block):
        out[b0:b0 + block], fit = block_search(cdf, pos[b0:b0 + block],
                                               window, ends)
        fits.append(fit)
    return out, fits


def apply_kernel(cdf, pos, X, base=0):
    """``inverse_cdf_apply_kernel`` (csrc/monotone_gather.cu) block by
    block: the window search of each block's SEARCH_BLOCK queries, padded
    past the end with the block's smallest; then every slot's ancestor
    relative to the local block, clipped to [0, nloc - 1], and the d
    values it loads (a padded slot's load too, which must stay inside X);
    the stores of the slots before the end. Returns ``(out [d, nq],
    ancestors int64 [nq], blocks whose stretch fit)``."""
    d, nloc = X.shape
    nq = pos.numel()
    out = torch.full((d, nq), np.nan, dtype=X.dtype)
    anc = torch.full((nq,), -1, dtype=torch.int64)
    fits = []
    for b0 in range(0, nq, SEARCH_BLOCK):
        q = pos[b0:b0 + SEARCH_BLOCK]
        c, fit = block_search(cdf, q, SEARCH_WINDOW, block=SEARCH_BLOCK)
        fits.append(fit)
        rel = (c - base).clamp(0, nloc - 1)
        vals = X[:, rel]
        m = q.numel()
        anc[b0:b0 + m] = c[:m]
        out[:, b0:b0 + m] = vals[:, :m]
    return out, anc, fits


def reference(cdf, pos):
    return torch.searchsorted(cdf, pos, right=True).clamp(
        max=cdf.numel() - 1)


@pytest.mark.parametrize("case", ["uniform", "concentrated", "zero-runs"])
def test_window_search_matches_searchsorted_and_jax(case):
    cdf, pos, _ = search_inputs(np.random.default_rng(31), case, 4096, 1)
    a_jax = np.asarray(jmg.inverse_cdf_search(
        jnp.asarray(cdf), jnp.asarray(pos), interpret=True))
    cdf_t, pos_t = torch.from_numpy(cdf), torch.from_numpy(pos)
    ref = reference(cdf_t, pos_t)
    np.testing.assert_array_equal(ref.numpy(), a_jax)
    np.testing.assert_array_equal(inverse_cdf_search(cdf_t, pos_t).numpy(),
                                  a_jax)
    for block, window, ends in ((CDF_BLOCK, CDF_WINDOW, True),
                                (256, CDF_WINDOW, False),
                                (SEARCH_BLOCK, SEARCH_WINDOW, False)):
        a, fits = window_search(cdf_t, pos_t, block, window, ends)
        np.testing.assert_array_equal(a.numpy(), a_jax)
        assert all(fits)
        assert window_fit_share(cdf_t, pos_t, block, window, ends) == 1.0


def _zero_run_cdf(n, rng):
    """Mostly zero weights in runs longer than the windows."""
    w = np.zeros(n, dtype=np.float32)
    w[rng.choice(n, n // 5000 + 2, replace=False)] = rng.uniform(
        0.5, 2.0, n // 5000 + 2)
    return np.cumsum(w, dtype=np.float32)


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("kind", ["shuffled", "strided", "short", "ragged",
                                  "zero-runs", "nan"])
def test_window_search_any_query_order(block, kind):
    rng = np.random.default_rng(block)
    n = 1 << 14
    cdf, pos, _ = search_inputs(rng, "uniform", n, 1)
    if kind == "shuffled":
        pos = rng.permutation(pos)
    elif kind == "strided":    # a block spans 16 blocks' worth of the cdf
        pos = np.ascontiguousarray(pos[::16])
    elif kind == "short":
        pos = pos[:block // 2 + 7]
    elif kind == "ragged":
        pos = pos[:5 * block + 77]
    elif kind == "zero-runs":
        cdf = _zero_run_cdf(n, rng)
        pos = np.sort(rng.uniform(0, cdf[-1], n // 4)).astype(np.float32)
    else:
        pos = pos.copy()
        pos[rng.choice(n, 9, replace=False)] = np.nan
    cdf_t, pos_t = torch.from_numpy(cdf), torch.from_numpy(pos)
    a, fits = window_search(cdf_t, pos_t, block, CDF_WINDOW)
    ref = reference(cdf_t, pos_t)
    num = ~torch.isnan(pos_t)
    np.testing.assert_array_equal(a[num].numpy(), ref[num].numpy())
    # A NaN query gets the whole-cdf binary search's count, 0,
    # and leaves the other queries of its block exact.
    assert not bool(a[~num].any())
    if kind in ("shuffled", "strided", "zero-runs"):
        assert not all(fits), "the wide-block branch was not taken"
    if kind != "nan":  # the reported share counts the emulated branches
        assert window_fit_share(cdf_t, pos_t, block, CDF_WINDOW) == \
            pytest.approx(np.mean(fits), abs=1e-6)


def test_window_search_ties_and_the_last_position():
    # Equal consecutive cdf values (zero weights), positions exactly on cdf
    # values and between neighbouring floats, at and past cdf[-1].
    w = np.array([0.0, 1.0, 0.0, 0.0, 1.0, 2.0 ** -23, 1.0, 0.0] * 64,
                 dtype=np.float32)
    cdf = np.cumsum(w, dtype=np.float32)
    on = np.sort(np.concatenate([cdf, np.nextafter(cdf, np.inf),
                                 np.nextafter(cdf, -np.inf)]))
    last = np.array([cdf[-1], np.nextafter(cdf[-1], np.inf),
                     2 * cdf[-1], np.inf], dtype=np.float32)
    pos = np.concatenate([on, last]).astype(np.float32)
    cdf_t, pos_t = torch.from_numpy(cdf), torch.from_numpy(pos)
    ref = reference(cdf_t, pos_t)
    assert int(ref[-1]) == cdf.size - 1
    for block in (128, 256):
        for ends in (False, True):
            a, _ = window_search(cdf_t, pos_t, block, CDF_WINDOW, ends)
            np.testing.assert_array_equal(a.numpy(), ref.numpy())


@pytest.mark.parametrize("seed", range(24))
def test_warp_upper_bound_is_the_count(seed):
    # Lengths across the 32-ary rounds' edges (1, 32, 33, 1024, 1025, ...)
    # and random ones; positions below, inside and past the cdf.
    rng = np.random.default_rng(seed)
    n = [1, 31, 32, 33, 1023, 1024, 1025, 4097][seed % 8] if seed < 16 \
        else int(rng.integers(2, 5000))
    frac = rng.uniform(-0.1, 1.1)
    w = rng.uniform(0, 1, n) * (rng.uniform(size=n) < 0.7)
    cdf = torch.from_numpy(np.cumsum(w.astype(np.float32), dtype=np.float32))
    p = np.float32(frac * float(cdf[-1]))
    lo = int(rng.integers(0, n + 1))
    hi = int(rng.integers(lo, n + 1))
    # Within [lo, hi) when the count lies there, as the kernel calls it.
    lo = min(lo, int((cdf <= p).sum()))
    hi = max(hi, int((cdf <= p).sum()))
    assert warp_upper_bound(cdf, lo, hi, p) == int((cdf <= p).sum())
    assert warp_upper_bound(cdf, 0, n, p) == int((cdf <= p).sum())


@pytest.mark.parametrize("seed", range(16))
def test_upper_bound_k_is_the_count(seed):
    # Range lengths across the halving steps' edges and random ones; ties,
    # positions below, inside and past the range, and a NaN (count 0).
    rng = np.random.default_rng(100 + seed)
    n = [1, 2, 3, 4, 5, 8, 9, 4095, 4096, 4097][seed] if seed < 10 \
        else int(rng.integers(2, 6000))
    w = rng.uniform(0, 1, n) * (rng.uniform(size=n) < 0.6)
    cdf = torch.from_numpy(np.cumsum(w.astype(np.float32), dtype=np.float32))
    lo = int(rng.integers(0, n + 1))
    hi = int(rng.integers(lo, n + 1))
    top = float(cdf[-1])
    p = torch.from_numpy(np.concatenate([
        rng.uniform(-0.1, 1.1, 61) * top, cdf[lo:hi][:3].numpy(),
        [np.nan]]).astype(np.float32))
    c = upper_bound_k(cdf, lo, hi, p)
    want = lo + (cdf[lo:hi][None, :] <= p[:, None]).sum(1)
    np.testing.assert_array_equal(c.numpy(), want.numpy())


@pytest.mark.parametrize("case", ["uniform", "concentrated", "zero-runs"])
def test_apply_kernel_matches_plain_and_jax(case):
    # Global mode on sorted systematic queries, and the local-block mode at
    # the shard shapes of a 4-way split (the global cdf, each shard's
    # queries, its [d, N/4] block at base p N/4).
    n = 4096
    cdf, pos, X = search_inputs(np.random.default_rng(41), case, n, 3)
    cdf_t, pos_t, X_t = (torch.from_numpy(v) for v in (cdf, pos, X))
    y_jax, a_jax = jmg.inverse_cdf_apply(jnp.asarray(cdf), jnp.asarray(pos),
                                         jnp.asarray(X), interpret=True)
    y, a, fits = apply_kernel(cdf_t, pos_t, X_t)
    y_p, a_p = inverse_cdf_apply_plain(cdf_t, pos_t, X_t)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_jax))
    np.testing.assert_array_equal(a.numpy(), a_p.numpy())
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_jax))
    np.testing.assert_array_equal(y.numpy(), y_p.numpy())
    assert window_fit_share(cdf_t, pos_t) == pytest.approx(np.mean(fits))
    L = n // 4
    for p in range(4):
        base = p * L
        q, blk = pos[base:base + L], np.ascontiguousarray(X[:, base:base + L])
        y_jax, a_jax = jmg.inverse_cdf_apply(
            jnp.asarray(cdf), jnp.asarray(q), jnp.asarray(blk), tile=512,
            interpret=True, local_base=base)
        q_t, blk_t = torch.from_numpy(q), torch.from_numpy(blk)
        y, a, _ = apply_kernel(cdf_t, q_t, blk_t, base)
        y_p, a_p = inverse_cdf_apply_plain(cdf_t, q_t, blk_t, base)
        a_jax = np.asarray(a_jax)
        np.testing.assert_array_equal(a.numpy(), a_jax)
        np.testing.assert_array_equal(y.numpy(), y_p.numpy())
        # The JAX kernel leaves the values of out-of-block ancestors unset.
        hit = (a_jax >= base) & (a_jax < base + L)
        np.testing.assert_array_equal(y.numpy()[:, hit],
                                      np.asarray(y_jax)[:, hit])


@pytest.mark.parametrize("kind", ["ragged", "wide", "nan", "shuffled",
                                  "base-clip"])
def test_apply_kernel_any_query_order(kind):
    # A ragged last block; blocks whose stretch exceeds the window (zero
    # runs longer than it); NaN queries; shuffled queries; a local block
    # whose queries land below and above it, so that both clips act.
    rng = np.random.default_rng(len(kind))
    n, d = 1 << 14, 2
    cdf, pos, X = search_inputs(rng, "uniform", n, d)
    base = 0
    if kind == "ragged":
        pos = pos[:5 * SEARCH_BLOCK + 77]
    elif kind == "wide":
        cdf = _zero_run_cdf(n, rng)
        pos = np.sort(rng.uniform(0, cdf[-1], n // 4)).astype(np.float32)
    elif kind == "nan":
        pos = pos.copy()
        pos[rng.choice(n, 9, replace=False)] = np.nan
    elif kind == "shuffled":
        pos = rng.permutation(pos)
    else:
        base = n // 4
        pos = pos[base - 700:2 * base + 900]
        X = np.ascontiguousarray(X[:, base:2 * base])
    cdf_t, pos_t, X_t = (torch.from_numpy(v) for v in (cdf, pos, X))
    y, a, fits = apply_kernel(cdf_t, pos_t, X_t, base)
    y_p, a_p = inverse_cdf_apply_plain(cdf_t, pos_t, X_t,
                                       base if kind == "base-clip" else None)
    num = ~torch.isnan(pos_t)
    np.testing.assert_array_equal(a[num].numpy(), a_p[num].numpy())
    np.testing.assert_array_equal(y[:, num].numpy(), y_p[:, num].numpy())
    # A NaN query takes the whole-cdf binary search's count, 0.
    assert not bool(a[~num].any())
    assert torch.equal(y[:, ~num], X_t[:, :1].expand(d, int((~num).sum())))
    if kind in ("wide", "shuffled"):
        assert not all(fits), "the wide-block branch was not taken"
    if kind == "base-clip":
        assert bool((a < base).any()) and bool((a >= 2 * base).any())


@pytest.mark.parametrize("mode", ["systematic", "stratified"])
def test_fused_step_positions_give_the_plain_ancestors(mode):
    # The fused step's positions rise with the slot, so a block's first and
    # last slot bound it; its ancestors are the plain version's.
    rng = np.random.default_rng(5)
    n, tile = 8192, 1024
    cdf = torch.from_numpy(np.cumsum(
        rng.exponential(size=n).astype(np.float32) * (rng.uniform(size=n)
                                                      < 0.3),
        dtype=np.float32))
    u = torch.tensor(0.37, dtype=torch.float32)
    seed = torch.tensor([11, -3], dtype=torch.int32)
    pscale = cdf[-1] / torch.tensor(float(n))
    if mode == "stratified":
        ug = fs.to_uniform(philox_bits(seed, torch.arange(n // tile), 0, 1,
                                       torch.arange(tile)).reshape(n))
    else:
        ug = u
    pos = (torch.arange(n, dtype=torch.float32) + ug) * pscale
    assert bool((pos[1:] >= pos[:-1]).all())
    a, fits = window_search(cdf, pos, CDF_BLOCK, CDF_WINDOW, ends=True)
    assert all(fits)
    assert window_fit_share(cdf, pos, CDF_BLOCK, CDF_WINDOW, ends=True) == 1.0
    d = 2
    X = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32))
    eye = torch.eye(d)
    _, _, a_plain = fc.fused_cdf_filter_step_plain(
        cdf, X, torch.zeros(d), eye, eye, eye, eye, None, 0.0, (u, seed),
        mode=mode, tile=tile)
    np.testing.assert_array_equal(a.numpy(), a_plain.numpy())


@pytest.mark.parametrize("d,k", [(2, 2), (5, 5), (16, 16), (32, 32),
                                 (16, 8), (32, 16), (64, 64), (2, 64)])
def test_fused_cdf_step_takes_its_design_from_step_path(monkeypatch, d, k):
    # The wrapper hands the kernel fused_step.step_path's choice and its
    # compiled widths; a stand-in library records them (the CPU has no
    # kernel to launch).
    calls = []

    class Library:
        def cusmc_fused_cdf_step(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fc, "is_cuda", lambda t, name: True)
    monkeypatch.setattr(fc.kernels, "library", Library)
    monkeypatch.setattr(fc.kernels, "stream_of", lambda t: 0)
    n = 4096
    F = torch.zeros(k, d)
    before = fc.fused_cdf_filter_step.launches
    fc.fused_cdf_filter_step(
        torch.ones(n), torch.zeros(d, n), torch.zeros(k), torch.eye(d),
        torch.eye(d), F, torch.eye(k), None, 0.0,
        fc.fused_cdf_filter_step_draws(None), tile=1024)
    assert fc.fused_cdf_filter_step.launches == before + 1
    assert fc.step_path is fs.step_path
    tiled, dm, km = calls[0][-4:-1]
    assert tiled == int(fs.step_path(d, k) == "tile")
    assert tiled == int(d == k == 16 or max(d, k) > 16)
    # The design's compiled widths, fused_step.step_widths's.
    assert (dm, km) == fs.step_widths(d, k)
