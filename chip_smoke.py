#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cusmc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. The card's name and power limit, from nvidia-smi.
2. Build: nvcc compiles the port's kernels (cusmc_tpu_torch/csrc/*.cu),
   one process per source, all started together.
3. Kernels: each kernel against its plain PyTorch version on the same
   tensors, with the tolerance stated beside each check. The prefix sum,
   the search and the roll walk at N = 2^20 and a ragged N, d = 2; the
   fused Metropolis step at N = 2^20, d = 2 and 32, MVN and MVT df=5; the
   fused inverse-CDF step, systematic and stratified, at N = 2^20 and
   N = 1_000_448, d = 2 and 32. Ancestors must be equal; a mismatch is
   allowed only at an exact accept or cdf tie, and each one is shown to
   be one. Then each kernel's and its plain version's time per call (CUDA
   events, median; launch cost included), device time per call
   (torch.profiler), one PyTorch library call of the same function where
   there is one, and the least time the card could take (bound).
3b. Statistics of the fused kernels (benchmarks/validate_fused_tpu.py
   checks 1-5d with their thresholds): zero-noise consistency, offspring
   against the indexed Metropolis resampler, noise moments, the inverse-CDF
   sandwich with an exact gather, stratified offspring, and log-evidence
   against the Kalman filter and the composed path.
4. The main path, through the entry points a user calls, with every
   launch count set to 0 first: ``run()`` at the README quick start (MVT
   df=5, metropolis, N=10000, the 1001-step bundled trace); MVN systematic
   and MVN metropolis on the same trace, with log-evidence held against the
   Kalman filter at 2% of |loglik|; the headline (MVT df=5, N=2^20, T=200,
   d=2, no history) for metropolis B=10 and for systematic, one warm-up and
   the best of 3, as particle-steps/s = N (T-1) / s and ESS/s. Every run
   must have launched each of its kernels at least T-1 times.
4b. The fused path, ``engine="pallas"``, with every launch count set to 0
   first: ``run(engine="pallas")`` on the bundled trace for systematic,
   stratified and metropolis (MVN, log-evidence against Kalman at 2%, 2%
   and 8%); then the headline and the full-width row (d = 32), MVT df=5,
   N=2^20, T=200, metropolis B=10 and systematic, each beside the composed
   path (``engine="xla"``) in turns, one warm-up and the best of 3, with
   the device's busy share from torch.profiler. Every fused run launches
   its kernel T-1 times and none of the composed path's kernels.
4c. The sharded path, with every launch count set to 0 first, on a
   one-rank NCCL group (``parallel.multihost.initialize_distributed`` with
   a ``file://`` rendezvous in a temporary directory; one card, so one
   rank): ``sharded_bootstrap_filter`` on the bundled trace (MVN, N=2^17)
   for systematic, residual and metropolis, and ``run(resampler=
   "residual")``, log-evidence against Kalman at 2% of |loglik|; then the
   headline (MVT df=5, N=2^20, T=200, d=2) for the same four, one warm-up
   and the best of 3, with the busy share. Launches per run: systematic
   the local-block search >= T-1; residual the search-only kernel >=
   2(T-1) and take-columns >= T-1; metropolis the roll kernel >= T-1.
   The kernel phase (3) holds the search-only, take-columns and
   local-block kernels to their plain versions at N = 2^20 and d = 2, 32,
   at the shard shapes of a 4-way split (L = N/4 queries, base p N/4).

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card the
script prints no result and exits with code 2.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

N_BIG = 1 << 20
N_RAGGED = 1_000_003
N_RAGGED_CDF = 1_000_448  # 977 * 1024: the fused CDF step needs N % 1024
D = 2
D_WIDE = 32
TIMING_REPS = 20
PLAIN_FUSED_REPS = 5      # the plain fused steps take tens of ms a call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published (700 W part)
FP32_FLOPS = 67e12         # H100 SXM, float32 outside the tensor cores
ACCEPT_TIE = 2.0 ** -22    # two float32 ulps, relative


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median over ``reps`` launches of ``fn``, each timed with CUDA events
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time per call of ``fn``: the kernels' own time summed by
    torch.profiler over ``reps`` calls, without the host's launch cost
    that the event timing of a short call also holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert total_us > 0, "the profiler saw no device time"
    return total_us / reps / 1e3


def busy_share(fn) -> float:
    """Device busy share of one call of ``fn``: kernel time summed by
    torch.profiler over the call's wall time (host and device traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e6 / wall


def bound(nbytes: float, flops: float):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the float32 operations over the float32
    rate, both the published H100 SXM peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(name, kern, plain, library, label, nbytes, flops,
                plain_reps=TIMING_REPS) -> dict:
    """Times a kernel, its plain version (alternating plain, kernel,
    kernel, plain) and the library call; returns the record fields."""
    p1 = median_ms(plain, plain_reps)
    k1 = median_ms(kern)
    k2 = median_ms(kern)
    p2 = median_ms(plain, plain_reps)
    lib = None if library is None else median_ms(library)
    dk = device_ms(kern)
    dp = device_ms(plain, plain_reps)
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"  time {name} {label}: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms per call (CUDA events, median); device "
          f"time per call: kernel {dk:.4f} ms, plain {dp:.4f} ms "
          f"(torch.profiler); library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}; bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP)")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib}


def build_kernels() -> float:
    from cusmc_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.library()
    seconds = time.perf_counter() - t0
    info = kernels.build_info
    print(f"build: {seconds:.2f} s (nvcc {info.get('seconds', 0.0):.2f} s) "
          f"-> {info.get('path')}")
    entry = ""
    for line in info.get("log", "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1][:90]
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {entry}: {line.strip()}")
    return seconds


def _cumsum_case(w, name):
    """Kernel vs plain (torch.cumsum) vs float64: monotone, and within a
    worst-case f32 bound. The kernel's rounding steps per element are at
    most 16 (in-thread) + 8 (shuffle and warp scans) + 1 (tile offset) +
    one per earlier tile, each an error of at most eps * total."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import FOLD, blocked_cumsum, \
        blocked_cumsum_plain

    n = w.shape[0]
    cdf, cdf128 = blocked_cumsum(w)
    plain, _ = blocked_cumsum_plain(w)
    ref = torch.cumsum(w.double(), 0)
    total = float(ref[-1])
    tiles = -(-n // 4096)
    bound_ = (25 + tiles) * torch.finfo(torch.float32).eps * total
    err64 = float((cdf.double() - ref).abs().max())
    err_plain = float((cdf - plain).abs().max())
    assert bool(torch.all(cdf[1:] >= cdf[:-1])), f"{name}: cdf not monotone"
    assert err64 <= bound_, f"{name}: |cdf - f64| = {err64} > {bound_}"
    assert torch.equal(cdf128, cdf[FOLD - 1::FOLD])
    print(f"  cumsum {name}: N={n} max|kernel-f64|={err64:.3e} "
          f"max|kernel-plain|={err_plain:.3e} bound={bound_:.3e} monotone")
    return err_plain


def _search_case(cdf, X, name):
    """Kernel vs plain (searchsorted + gather) on the same monotone cdf and
    systematic positions: ancestors and values exactly equal."""
    import torch

    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_apply_plain

    n = cdf.shape[0]
    u = torch.rand((), device=cdf.device)
    pos = (torch.arange(n, device=cdf.device, dtype=torch.float32) + u) / n
    pos = pos * cdf[-1]
    y, a = inverse_cdf_apply(cdf, pos, X)
    y_p, a_p = inverse_cdf_apply_plain(cdf, pos, X)
    assert torch.equal(a, a_p), f"{name}: ancestors differ " \
        f"({int((a != a_p).sum())} of {n})"
    assert torch.equal(y, y_p), f"{name}: values differ"
    assert int(a.min()) >= 0 and int(a.max()) <= n - 1
    print(f"  search {name}: N={n} ancestors and values equal "
          f"({int(torch.unique(a).numel())} distinct ancestors)")
    return float((y - y_p).abs().max())


def _rolls_case(w, X, gen, name):
    """Kernel vs plain (the walk, apply and ancestors of rolls.py) on the
    same shifts and uniforms: exactly equal."""
    import torch

    from cusmc_tpu_torch.resampling.rolls import roll_metropolis_draws, \
        roll_metropolis_sweeps_expspace, \
        roll_metropolis_sweeps_expspace_plain

    n = w.shape[0]
    shifts, u = roll_metropolis_draws(gen, n, 10, w.device)
    y, a = roll_metropolis_sweeps_expspace(w, shifts, u, X)
    y_p, a_p = roll_metropolis_sweeps_expspace_plain(w, shifts, u, X)
    assert torch.equal(a, a_p), f"{name}: ancestors differ " \
        f"({int((a != a_p).sum())} of {n})"
    assert torch.equal(y, y_p), f"{name}: values differ"
    moved = float((a != torch.arange(n, device=w.device)).float().mean())
    print(f"  rolls {name}: N={n} B=10 ancestors and values equal "
          f"(moved share {moved:.3f})")
    return shifts, u, float((y - y_p).abs().max())


def check_kernels() -> dict:
    """Phase 3 for the prefix sum, the search and the roll walk. Returns
    per-kernel records at N = 2^20, d = 2, B = 10."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum, \
        blocked_cumsum_plain
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_apply_plain
    from cusmc_tpu_torch.resampling.rolls import \
        roll_metropolis_sweeps_expspace, \
        roll_metropolis_sweeps_expspace_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rec = {}
    for n in (N_BIG, N_RAGGED):
        tag = "2^20" if n == N_BIG else "ragged"
        X = torch.randn((D, n), generator=gen, device=dev)
        # Exp-space weights as the filter carries them: max-normalised.
        ll = -0.5 * torch.randn(n, generator=gen, device=dev) ** 2 * 50.0
        w_exp = torch.exp(ll - ll.max())
        w_unif = torch.rand(n, generator=gen, device=dev)
        # Concentrated: one particle holds ~all the mass.
        w_conc = torch.full((n,), 1e-12, device=dev)
        w_conc[n // 3] = 1.0
        # Long zero runs: floor counts of sharp weights.
        sharp = torch.softmax(3.0 * torch.randn(n, generator=gen,
                                                device=dev), 0)
        w_zero = torch.floor(n * sharp)

        errs = [_cumsum_case(w, f"{tag}/{name}") for name, w in
                (("uniform", w_unif), ("exp", w_exp),
                 ("concentrated", w_conc), ("zero-runs", w_zero))]
        serrs = []
        for name, w in (("exp", w_exp), ("uniform", w_unif),
                        ("concentrated", w_conc), ("zero-runs", w_zero)):
            cdf, _ = blocked_cumsum(w)
            serrs.append(_search_case(cdf, X, f"{tag}/{name}"))
        rerrs = []
        for name, w in (("exp", w_exp), ("uniform", w_unif),
                        ("concentrated", w_conc)):
            shifts, u, e = _rolls_case(w, X, gen, f"{tag}/{name}")
            rerrs.append(e)
        if n != N_BIG:
            continue

        cdf, _ = blocked_cumsum(w_exp)
        pos = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) / n \
            * cdf[-1]
        label = f"N=2^20 d={D}"
        b = 10
        rec["blocked_cumsum"] = dict(max_abs_err=max(errs), **time_kernel(
            "blocked_cumsum", lambda: blocked_cumsum(w_exp),
            lambda: blocked_cumsum_plain(w_exp),
            lambda: torch.cumsum(w_exp, 0), label, 8 * n, n))
        rec["inverse_cdf_apply"] = dict(max_abs_err=max(serrs), **time_kernel(
            "inverse_cdf_apply", lambda: inverse_cdf_apply(cdf, pos, X),
            lambda: inverse_cdf_apply_plain(cdf, pos, X),
            lambda: X.index_select(1, torch.searchsorted(cdf, pos,
                                                         right=True)),
            label + " (library: searchsorted + index_select)",
            (12 + 8 * D) * n, 0))
        rec["roll_metropolis_sweeps_expspace"] = dict(
            max_abs_err=max(rerrs), **time_kernel(
                "roll_metropolis_sweeps_expspace",
                lambda: roll_metropolis_sweeps_expspace(w_exp, shifts, u, X),
                lambda: roll_metropolis_sweeps_expspace_plain(
                    w_exp, shifts, u, X),
                None, label + f" B={b}", (8 + 4 * b + 8 * D) * n, b * n))
    torch.cuda.synchronize()
    return rec


def _ancestors_equal(name, a, a_p, cdf, pos) -> int:
    """Kernel and plain ancestors equal; a mismatch passes only where it
    is shown to be a cdf tie. Returns the number of ties."""
    bad = (a != a_p).nonzero().flatten()
    assert bad.numel() <= 1000, f"{name}: {bad.numel()} ancestors differ"
    for g in bad.tolist():
        lo, hi = sorted((int(a[g]), int(a_p[g])))
        assert _cdf_tie(cdf, pos[g], lo, hi), f"{name}: slot {g} is no tie"
    return bad.numel()


def check_shard_kernels() -> dict:
    """Phase 3 for the search-only kernel, take-columns and the local-block
    search-and-apply at N = 2^20, d = 2 and 32: ancestors equal (ties
    shown), values exactly equal, at the shapes of a 4-way split (L = N/4
    queries; blocks at base p N/4). Records at the one-rank sharded path's
    shapes (N queries, d = 2, base 0); the shard shape's times are printed
    beside them."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_apply_plain, inverse_cdf_search, \
        inverse_cdf_search_plain, take_columns, take_columns_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    n, L = N_BIG, N_BIG // 4
    ll = -25.0 * torch.randn(n, generator=gen, device=dev) ** 2
    weights = {"exp": torch.exp(ll - ll.max()),
               "uniform": torch.rand(n, generator=gen, device=dev),
               "concentrated": torch.full((n,), 1e-12, device=dev),
               "zero-runs": torch.floor(n * torch.softmax(
                   3.0 * torch.randn(n, generator=gen, device=dev), 0))}
    weights["concentrated"][n // 3] = 1.0
    u = torch.rand((), generator=gen, device=dev)
    unit = (torch.arange(n, device=dev, dtype=torch.float32) + u) \
        / torch.tensor(float(n), device=dev)
    serr = lerr = terr = 0.0
    ties = 0
    for wname, w in weights.items():
        cdf, _ = blocked_cumsum(w)
        pos = unit * cdf[-1]
        for label, q in (("L=N", pos), ("L=N/4 strided", pos[::4]),
                         ("L=N/4 shard 1", pos[L:2 * L])):
            q = q.contiguous()
            a = inverse_cdf_search(cdf, q)
            a_p = inverse_cdf_search_plain(cdf, q)
            ties += _ancestors_equal(f"search {wname} {label}", a, a_p, cdf,
                                     q)
            serr = max(serr, float((a - a_p).abs().max()))
        for d in (D, D_WIDE):
            X = torch.randn((d, n), generator=gen, device=dev)
            for p in range(4):
                base = p * L
                q = pos[base:base + L].contiguous()
                blk = X[:, base:base + L].contiguous()
                y, a = inverse_cdf_apply(cdf, q, blk, local_base=base)
                y_p, a_p = inverse_cdf_apply_plain(cdf, q, blk,
                                                   local_base=base)
                tag = f"local {wname} d={d} base={p}N/4"
                ties += _ancestors_equal(tag, a, a_p, cdf, q)
                keep = a == a_p
                assert torch.equal(y[:, keep], y_p[:, keep]), \
                    f"{tag}: values differ"
                hit = keep & (a >= base) & (a < base + L)
                assert torch.equal(y[:, hit], X[:, a[hit].long()]), tag
                lerr = max(lerr, float((y[:, keep] - y_p[:, keep]).abs()
                                       .max()))
    for d in (D, D_WIDE):
        X = torch.randn((d, n), generator=gen, device=dev)
        rand = torch.randint(0, n, (n,), generator=gen, device=dev)
        for kind, a in (("sorted", torch.sort(rand).values),
                        ("concentrated", torch.sort(rand % 7).values * 4099),
                        ("shuffled", rand)):
            a = a.to(torch.int32)
            out, out_p = take_columns(X, a), take_columns_plain(X, a)
            assert torch.equal(out, out_p), f"take_columns {kind} d={d}"
            terr = max(terr, float((out - out_p).abs().max()))
    print(f"  inverse_cdf_search (L=N, N/4 strided, N/4 of shard 1), "
          f"inverse_cdf_apply local-block (L=N/4 at base p N/4, p=0..3, "
          f"d=2 and 32) on 4 weight kinds, take_columns (sorted, "
          f"concentrated, shuffled; d=2 and 32), N=2^20: ancestors equal "
          f"({ties} shown cdf ties), values equal")

    rec = {}
    cdf, _ = blocked_cumsum(weights["exp"])
    pos = (unit * cdf[-1]).contiguous()
    X = torch.randn((D, n), generator=gen, device=dev)
    a = inverse_cdf_search(cdf, pos)
    label = f"N=2^20 d={D}"
    rec["inverse_cdf_search"] = dict(max_abs_err=serr, **time_kernel(
        "inverse_cdf_search", lambda: inverse_cdf_search(cdf, pos),
        lambda: inverse_cdf_search_plain(cdf, pos),
        lambda: torch.searchsorted(cdf, pos, right=True),
        "N=2^20 L=N (library: searchsorted)", 12 * n, 0))
    rec["take_columns"] = dict(max_abs_err=terr, **time_kernel(
        "take_columns", lambda: take_columns(X, a),
        lambda: take_columns_plain(X, a), lambda: X.index_select(1, a),
        label + " sorted (library: index_select)", (4 + 8 * D) * n, 0))
    rec["inverse_cdf_apply[local_base]"] = dict(
        max_abs_err=lerr, **time_kernel(
            "inverse_cdf_apply[local_base]",
            lambda: inverse_cdf_apply(cdf, pos, X, local_base=0),
            lambda: inverse_cdf_apply_plain(cdf, pos, X, local_base=0),
            lambda: X.index_select(1, torch.searchsorted(cdf, pos,
                                                         right=True)),
            label + " base 0 L=N (library: searchsorted + index_select)",
            (12 + 8 * D) * n, 0))
    q, blk = pos[L:2 * L].contiguous(), X[:, L:2 * L].contiguous()
    time_kernel("inverse_cdf_apply[local_base]",
                lambda: inverse_cdf_apply(cdf, q, blk, local_base=L),
                lambda: inverse_cdf_apply_plain(cdf, q, blk, local_base=L),
                None, f"4-way shard shape: base N/4, L=N/4, d={D}",
                (8 + 8 * D) * L + 4 * n, 0)
    torch.cuda.synchronize()
    return rec


# -- the fused steps ------------------------------------------------------

def _fused_model(d, noise, dev):
    """The demo DLM of width d on the card, and its kernel arguments."""
    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM

    m = DLM.create(noise=noise, df=5.0 if noise == "mvt" else None,
                   device=dev, **demo_model_params(d))
    mats = tuple(t.contiguous() for t in (m.G, m.W_sqrt, m.F, m.V_chol_inv))
    return m, mats


def _state(gen, d, n, dev):
    """A particle cloud near the demo trace and max-normalised log
    weights with the spread of a filter step."""
    import torch

    X = 0.1 * torch.randn((d, n), generator=gen, device=dev)
    ll = -25.0 * torch.randn(n, generator=gen, device=dev) ** 2
    y = torch.full((d,), 0.05, device=dev)
    return X, ll - ll.max(), y


def _metropolis_margin(X, logw, draws, tile, wt, num_sweeps, p):
    """The smallest relative accept margin |u w_cur - w_cand| / w_cand
    along particle p's walk, recomputed as the plain version walks it."""
    import torch

    from cusmc_tpu_torch.ops.fused_step import to_uniform
    from cusmc_tpu_torch.ops.philox import philox_bits

    dev = X.device
    n = X.shape[1]
    nb = n // tile
    wlen = wt * tile
    s, seed = draws
    i, lane = divmod(p, tile)
    blk = torch.tensor([i], device=dev)
    sc = philox_bits(seed, blk, 1, 2,
                     torch.arange(max(num_sweeps, 1), device=dev))
    r = int(sc[0, 0, 0]) & 127
    n_off = (wt - 1) * tile // 128 + 1
    u = to_uniform(philox_bits(seed, blk, 0, num_sweeps,
                               torch.tensor([lane], device=dev)))[:, 0, 0]
    ws = ((i + int(s[0])) % nb) * tile
    ws2 = ((i + int(s[1])) % nb) * tile

    def weight(q):
        q = q - wlen if q >= wlen else q
        g = (ws + q) % n if q < 2 * tile else ws2 + q - 2 * tile
        return torch.exp(logw[g])

    w_cur = weight(lane + r)
    margin = math.inf
    for sw in range(num_sweeps):
        db = 128 * ((int(sc[1, 0, sw]) & 0x7FFFFFFF) % n_off)
        w_cand = weight(lane + r + db)
        prod = u[sw] * w_cur
        margin = min(margin, abs(float(prod) - float(w_cand))
                     / max(float(w_cand), 1e-38))
        if bool(prod < w_cand):
            w_cur = w_cand
    return margin


def _cdf_tie(cdf, pos, lo, hi) -> bool:
    """Every cdf boundary between two ancestors lies within an ulp of the
    position."""
    import torch

    ulp = float(torch.finfo(torch.float32).eps) * max(abs(float(pos)), 1e-30)
    return bool(((cdf[lo:hi] - pos).abs() <= ulp).all())


def _compare(name, a, a_p, outs, plains, ties):
    """Ancestors equal except at ties (``ties(idx)`` checks them), states
    and log-likelihoods at rtol 1e-4, atol 1e-4 on the other slots."""
    import torch

    bad = (a != a_p).nonzero().flatten()
    if bad.numel():
        print(f"  {name}: {bad.numel()} ancestors differ")
        assert bad.numel() <= 1000, f"{name}: too many mismatches"
        ties(bad)
    keep = a == a_p
    err = 0.0
    for o, p in zip(outs, plains):
        o, p = o[..., keep], p[..., keep]
        torch.testing.assert_close(o, p, rtol=1e-4, atol=1e-4)
        err = max(err, float((o - p).abs().max()))
    return err, bad.numel()


def _fused_step_case(n, d, noise, gen, dev):
    import torch

    from cusmc_tpu_torch.ops.fused_step import auto_tile, \
        fused_filter_step, fused_filter_step_draws, fused_filter_step_plain

    m, (G, Q, F, Li) = _fused_model(d, noise, dev)
    X, logw, y = _state(gen, d, n, dev)
    tile = auto_tile(n, d)
    draws = fused_filter_step_draws(gen, n, tile, dev)
    df = m.df_value if noise == "mvt" else None
    args = (X, logw, y, G, Q, F, Li, df, float(m.log_norm), draws)
    kw = dict(noise=noise, num_sweeps=10, tile=tile, df_int=m.df_int,
              num_window_tiles=2)
    x, ll, a = fused_filter_step(*args, **kw)
    x_p, ll_p, a_p = fused_filter_step_plain(*args, **kw)

    def ties(bad):
        for p in bad[:1000].tolist():
            margin = _metropolis_margin(X, logw, draws, tile, 2, 10, p)
            assert margin <= ACCEPT_TIE, f"slot {p}: margin {margin}"

    label = f"fused_step N={n} d={d} {noise} tile={tile}"
    err, nbad = _compare(label, a, a_p, (x, ll), (x_p, ll_p), ties)
    moved = float((a != torch.arange(n, device=dev)).float().mean())
    print(f"  {label}: ancestors {'equal' if not nbad else 'equal but ties'}"
          f", max|kernel-plain| {err:.3e} (states, ll), moved share "
          f"{moved:.3f}")
    return err, args, kw


def _fused_cdf_case(n, d, mode, gen, dev):
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_cdf_step import cdf_auto_tile, \
        fused_cdf_filter_step, fused_cdf_filter_step_draws, \
        fused_cdf_filter_step_plain
    from cusmc_tpu_torch.ops.fused_step import to_uniform
    from cusmc_tpu_torch.ops.philox import philox_bits

    m, (G, Q, F, Li) = _fused_model(d, "mvt", dev)
    X, logw, y = _state(gen, d, n, dev)
    cdf, _ = blocked_cumsum(torch.exp(logw))
    tile = cdf_auto_tile(n, d)
    draws = fused_cdf_filter_step_draws(gen, dev)
    args = (cdf, X, y, G, Q, F, Li, m.df_value, float(m.log_norm), draws)
    kw = dict(noise="mvt", mode=mode, tile=tile, df_int=m.df_int)
    x, ll, a = fused_cdf_filter_step(*args, **kw)
    x_p, ll_p, a_p = fused_cdf_filter_step_plain(*args, **kw)

    def ties(bad):
        u, seed = draws
        if mode == "stratified":
            u = to_uniform(philox_bits(
                seed, torch.arange(n // tile, device=dev), 0, 1,
                torch.arange(tile, device=dev))).reshape(n)[bad]
        pscale = cdf[-1] / torch.tensor(float(n), device=dev)
        pos = (bad.float() + u) * pscale
        for g, p in zip(bad.tolist(), pos):
            lo, hi = sorted((int(a[g]), int(a_p[g])))
            assert _cdf_tie(cdf, p, lo, hi), f"slot {g} is no cdf tie"

    label = f"fused_cdf {mode} N={n} d={d} tile={tile}"
    err, nbad = _compare(label, a, a_p, (x, ll), (x_p, ll_p), ties)
    print(f"  {label}: ancestors {'equal' if not nbad else 'equal but ties'}"
          f", max|kernel-plain| {err:.3e} (states, ll), distinct ancestors "
          f"{int(torch.unique(a).numel())}")
    return err, args, kw


def check_fused_kernels() -> dict:
    """Phase 3 for the two fused steps. Records at the headline shape:
    N = 2^20, d = 2, MVT df=5 (metropolis B=10; systematic)."""
    import torch

    from cusmc_tpu_torch.ops.fused_cdf_step import fused_cdf_filter_step, \
        fused_cdf_filter_step_plain
    from cusmc_tpu_torch.ops.fused_step import fused_filter_step, \
        fused_filter_step_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    rec = {}
    step_errs, step_cases = [], {}
    for d in (D, D_WIDE):
        for noise in ("mvn", "mvt"):
            err, args, kw = _fused_step_case(N_BIG, d, noise, gen, dev)
            step_errs.append(err)
            if noise == "mvt":
                step_cases[d] = (args, kw)
    cdf_errs, cdf_cases = [], {}
    for n in (N_BIG, N_RAGGED_CDF):
        for d in (D, D_WIDE):
            for mode in ("systematic", "stratified"):
                err, args, kw = _fused_cdf_case(n, d, mode, gen, dev)
                cdf_errs.append(err)
                if n == N_BIG and mode == "systematic":
                    cdf_cases[d] = (args, kw)
    for d in (D_WIDE, D):  # d = 2 last: its numbers go into the record
        flops = 2.0 * 4 * d * d * N_BIG   # G, Q, F, Li at k = d
        nbytes = (8 * d + 12) * N_BIG
        args, kw = step_cases[d]
        rec["fused_filter_step"] = dict(max_abs_err=max(step_errs),
                                        **time_kernel(
            "fused_filter_step", lambda: fused_filter_step(*args, **kw),
            lambda: fused_filter_step_plain(*args, **kw), None,
            f"N=2^20 d={d} MVT df=5 B=10 tile={kw['tile']}", nbytes, flops,
            PLAIN_FUSED_REPS))
        cargs, ckw = cdf_cases[d]
        rec["fused_cdf_filter_step"] = dict(max_abs_err=max(cdf_errs),
                                            **time_kernel(
            "fused_cdf_filter_step",
            lambda: fused_cdf_filter_step(*cargs, **ckw),
            lambda: fused_cdf_filter_step_plain(*cargs, **ckw), None,
            f"N=2^20 d={d} MVT df=5 systematic tile={ckw['tile']}", nbytes,
            flops, PLAIN_FUSED_REPS))
    torch.cuda.synchronize()
    return rec


def check_statistics() -> None:
    """Phase 3b: benchmarks/validate_fused_tpu.py checks 1-5d, on the
    kernels, with their thresholds."""
    import numpy as np
    import torch

    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_cdf_step import fused_cdf_filter_step, \
        fused_cdf_filter_step_draws
    from cusmc_tpu_torch.ops.fused_step import fused_filter_step, \
        fused_filter_step_draws
    from cusmc_tpu_torch.resampling.metropolis import metropolis_ancestors
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d, n = 2, 8192
    X = torch.randn((d, n), generator=gen, device=dev)
    logw = 2.0 * torch.randn(n, generator=gen, device=dev)
    eye = torch.eye(d, device=dev)
    y0 = torch.zeros(d, device=dev)

    def step(X_, lw, q, g, noise="mvn", df=None, df_int=None, tile=2048):
        draws = fused_filter_step_draws(gen, X_.shape[1], tile, dev)
        return fused_filter_step(X_, lw, y0, g * eye, q * eye, eye, eye, df,
                                 0.0, draws, noise=noise, tile=tile,
                                 df_int=df_int)

    def cdf_step(cdf, X_, q, g, mode="systematic", noise="mvn", df=None,
                 df_int=None, tile=None):
        draws = fused_cdf_filter_step_draws(gen, dev)
        out = fused_cdf_filter_step(cdf, X_, y0, g * eye, q * eye, eye, eye,
                                    df, 0.0, draws, noise=noise, mode=mode,
                                    tile=tile, df_int=df_int)
        return out, draws

    def check(name, ok, detail):
        print(f"  {'PASS' if ok else 'FAIL'}: {name} {detail}")
        assert ok, name

    # 1. zero-noise consistency
    Xn, ll, a = step(X, logw, 0.0, 1.0)
    diff = float((Xn - X[:, a.long()]).abs().max())
    ll_diff = float((ll + 0.5 * (Xn ** 2).sum(0)).abs().max())
    check("zero-noise consistency", diff == 0.0 and ll_diff < 1e-5,
          f"(state diff {diff}, ll diff {ll_diff:.2e})")

    # 2. offspring against the indexed Metropolis resampler
    w = torch.softmax(logw.double(), 0).cpu().numpy()

    def offspring(fn, reps=30):
        tot = np.zeros(n)
        for _ in range(reps):
            tot += np.bincount(fn().cpu().numpy(), minlength=n)
        return tot / (reps * n)

    emp_f = offspring(lambda: step(X, logw, 0.0, 1.0)[2])
    emp_i = offspring(lambda: metropolis_ancestors(gen, logw, 10))
    err_f = np.abs(emp_f - w).mean() / w.mean()
    err_i = np.abs(emp_i - w).mean() / w.mean()
    check("offspring ~ weights (vs indexed metropolis)",
          err_f < 1.3 * err_i + 0.05,
          f"(fused rel err {err_f:.3f}, indexed {err_i:.3f})")

    # 3. noise moments
    m = 1 << 17
    X0 = torch.zeros((d, m), device=dev)
    lw0 = torch.zeros(m, device=dev)
    xs = step(X0, lw0, 0.5, 0.0)[0].double()
    check("mvn noise moments", abs(float(xs.mean())) < 0.01
          and abs(float(xs.std()) - 0.5) < 0.02,
          f"(mean {float(xs.mean()):.4f}, std {float(xs.std()):.4f})")
    vt = float(step(X0, lw0, 0.5, 0.0, "mvt", 8.0)[0].double().var())
    check("mvt scale-mixture variance", abs(vt - 8.0 / 6.0 * 0.25) < 0.03,
          f"(var {vt:.4f})")

    # 4. and 5c. log-evidence against Kalman and the composed path
    p = demo_model_params()
    model = DLM.create(noise="mvn", device=dev, **p)
    ys = load_y_sim()[:101]
    _, _, zk = kalman_filter(ys, **{k: p[k] for k in
                                    ("F", "G", "V", "W", "m0", "C0")})

    def logz(resampler, engine):
        return float(bootstrap_filter(0, model, ys, 8192,
                                      resampler=resampler, engine=engine,
                                      return_history=False).log_evidence)

    zp, zx = logz("metropolis", "pallas"), logz("metropolis", "xla")
    check("filter log-evidence (pallas vs xla vs kalman)",
          abs(zp - zk) < 0.08 * abs(zk) and abs(zp - zx) < 0.04 * abs(zk),
          f"(pallas {zp:.3f}, xla {zx:.3f}, kalman {zk:.3f})")

    # 5a. inverse-CDF sandwich and exact gather
    w32 = 0.01 + 0.99 * torch.rand(n, generator=gen, device=dev)
    cdf, _ = blocked_cumsum(w32)
    (Xc, _, ac), (u, _) = cdf_step(cdf, X, 0.0, 1.0, tile=1024)
    c = cdf.double()
    pos = (torch.arange(n, device=dev).double() + float(u)) * (c[-1] / n)
    al = ac.long()
    lo = torch.where(al > 0, c[(al - 1).clamp(min=0)],
                     torch.full_like(c, -math.inf))
    hi = c[(al + 1).clamp(max=n - 1)]
    sandwich = bool(((lo <= pos + 1e-5 * pos.abs())
                     & (pos <= hi + 1e-5 * hi.abs())).all())
    gather = bool(torch.equal(Xc, X[:, al]))
    check("fused-cdf ancestors obey inverse-CDF law (zero noise)",
          sandwich and gather, f"(sandwich {sandwich}, gather {gather})")

    # 5b. noise moments through the fused-cdf propagate stage
    cdf0, _ = blocked_cumsum(torch.ones(m, device=dev))
    xs = cdf_step(cdf0, X0, 0.5, 0.0)[0][0].double()
    check("fused-cdf mvn noise moments", abs(float(xs.mean())) < 0.01
          and abs(float(xs.std()) - 0.5) < 0.02,
          f"(mean {float(xs.mean()):.4f}, std {float(xs.std()):.4f})")
    vt = float(cdf_step(cdf0, X0, 0.5, 0.0, noise="mvt", df=5.0,
                        df_int=5)[0][0].double().var())
    check("fused-cdf mvt scale-mixture variance (df_int=5)",
          abs(vt - 5.0 / 3.0 * 0.25) < 0.05, f"(var {vt:.4f})")

    zc, zcx = logz("systematic", "pallas"), logz("systematic", "xla")
    check("fused-cdf systematic log-evidence (vs xla vs kalman)",
          abs(zc - zk) < 0.02 * abs(zk) and abs(zc - zcx) < 0.02 * abs(zk),
          f"(fused {zc:.3f}, xla {zcx:.3f}, kalman {zk:.3f})")

    # 5d. stratified positions: offspring ~ weights
    wst = torch.softmax(logw.double(), 0)
    cst, _ = blocked_cumsum((wst * n).float())
    tot = np.zeros(n)
    for _ in range(30):
        a = cdf_step(cst, X, 0.0, 1.0, mode="stratified", tile=1024)[0][2]
        tot += np.bincount(a.cpu().numpy(), minlength=n)
    wn = wst.cpu().numpy()
    err_st = np.abs(tot / (30 * n) - wn).mean() / wn.mean()
    check("fused-cdf stratified offspring ~ weights", err_st < 0.2,
          f"(rel err {err_st:.3f})")
    torch.cuda.synchronize()


# -- the main paths -------------------------------------------------------

GATHER_CU = "cusmc_tpu_torch/csrc/monotone_gather.cu"
KERNELS = (
    ("blocked_cumsum", "cusmc_tpu_torch/csrc/cumsum.cu",
     "cusmc_tpu/ops/cumsum.py:45", "main"),
    ("inverse_cdf_apply", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:277", "main"),
    ("roll_metropolis_sweeps_expspace", "cusmc_tpu_torch/csrc/rolls.cu",
     "cusmc_tpu/resampling/rolls.py:109", "main"),
    ("fused_filter_step", "cusmc_tpu_torch/csrc/fused_step.cu",
     "cusmc_tpu/ops/fused_step.py:127", "pallas"),
    ("fused_cdf_filter_step", "cusmc_tpu_torch/csrc/fused_cdf_step.cu",
     "cusmc_tpu/ops/fused_cdf_step.py:104", "pallas"),
    ("inverse_cdf_search", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:422", "sharded"),
    ("take_columns", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:204", "sharded"),
    ("inverse_cdf_apply[local_base]", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:401", "sharded"),
)


def _wrappers():
    """name -> (wrapper, the attribute that counts its launches)."""
    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_cdf_step import fused_cdf_filter_step
    from cusmc_tpu_torch.ops.fused_step import fused_filter_step
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_search, take_columns
    from cusmc_tpu_torch.resampling.rolls import \
        roll_metropolis_sweeps_expspace

    return {"blocked_cumsum": (blocked_cumsum, "launches"),
            "inverse_cdf_apply": (inverse_cdf_apply, "launches"),
            "roll_metropolis_sweeps_expspace":
                (roll_metropolis_sweeps_expspace, "launches"),
            "fused_filter_step": (fused_filter_step, "launches"),
            "fused_cdf_filter_step": (fused_cdf_filter_step, "launches"),
            "inverse_cdf_search": (inverse_cdf_search, "launches"),
            "take_columns": (take_columns, "launches"),
            "inverse_cdf_apply[local_base]": (inverse_cdf_apply,
                                              "local_launches")}


def _counts():
    return {k: getattr(f, attr) for k, (f, attr) in _wrappers().items()}


def _zero_counts():
    for f, attr in _wrappers().values():
        setattr(f, attr, 0)


def _expect_launches(before, after, used, steps, label, unused=()):
    for name in used:
        grown = after[name] - before[name]
        assert grown >= steps, f"{label}: {name} launched {grown} times, " \
            f"expected >= {steps}"
    for name in unused:
        grown = after[name] - before[name]
        assert grown == 0, f"{label}: {name} launched {grown} times"
    print(f"  {label}: launches " + ", ".join(
        f"{k}+{after[k] - before[k]}" for k in after))


CDF_KERNELS = ("blocked_cumsum", "inverse_cdf_apply")
ROLL_KERNELS = ("roll_metropolis_sweeps_expspace",)
FUSED_KERNELS = ("fused_filter_step", "fused_cdf_filter_step")
COMPOSED_KERNELS = CDF_KERNELS + ROLL_KERNELS
SHARD_KERNELS = ("inverse_cdf_search", "take_columns",
                 "inverse_cdf_apply[local_base]")


def main_path(card: str) -> None:
    """Phase 4: the port's main path, through run() and bootstrap_filter."""
    import numpy as np
    import torch

    import cusmc_tpu_torch
    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    p = demo_model_params()
    ys = load_y_sim()
    T = ys.shape[0]

    # README quick start.
    before = _counts()
    t0 = time.perf_counter()
    out = cusmc_tpu_torch.run(
        N=10_000, d=2, timeSteps=T, Y=ys, m0=p["m0"], C0=p["C0"], F=p["F"],
        G=p["G"], V=p["V"], W=p["W"], df=5.0, resampler="metropolis",
        distribution="mvt", key=0, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert tuple(out["posterior_x"].shape) == (T, 10_000, 2)
    assert tuple(out["weights"].shape) == (T, 10_000)
    for k, v in out.items():
        assert v.is_cuda and bool(torch.isfinite(v).all()), k
    post = out["posterior_x"].double()
    wts = torch.softmax(torch.log(out["weights"].double()), dim=1)
    pm = (wts[:, :, None] * post).sum(1).cpu().numpy()
    rmse = float(np.sqrt(((pm[10:] - ys[10:]) ** 2).mean()))
    assert rmse < 0.2, f"quick start: posterior mean RMSE {rmse}"
    print(f"  quick start (MVT df=5, metropolis, N=10000, T={T}): "
          f"{secs:.2f} s incl. first use, logZ "
          f"{float(out['log_evidence']):.3f}, mean ESS "
          f"{float(out['ess'].mean()):.1f}, posterior-mean RMSE to y "
          f"{rmse:.4f}")
    _expect_launches(before, _counts(), ROLL_KERNELS, T - 1, "quick start",
                     FUSED_KERNELS)

    # Kalman checks, MVN.
    _, _, loglik = kalman_filter(ys, **{k: p[k] for k in
                                        ("F", "G", "V", "W", "m0", "C0")})
    for resampler, used in (("systematic", CDF_KERNELS),
                            ("metropolis", ROLL_KERNELS)):
        before = _counts()
        out = cusmc_tpu_torch.run(
            N=1 << 17, d=2, timeSteps=T, Y=ys, m0=p["m0"], C0=p["C0"],
            F=p["F"], G=p["G"], V=p["V"], W=p["W"], resampler=resampler,
            distribution="mvn", key=1, device="cuda")
        lz = float(out["log_evidence"])
        gap = abs(lz - loglik)
        print(f"  kalman MVN {resampler} N=2^17 T={T}: logZ {lz:.3f} vs "
              f"Kalman {loglik:.3f} (|gap| {gap:.3f}, limit "
              f"{0.02 * abs(loglik):.3f})")
        assert gap < 0.02 * abs(loglik), f"{resampler}: logZ off"
        _expect_launches(before, _counts(), used, T - 1,
                         f"kalman {resampler}", FUSED_KERNELS)

    # Headline: MVT df=5, N=2^20, T=200, d=2, no history.
    n, steps = N_BIG, 200
    model = DLM.create(noise="mvt", df=5.0, dtype=torch.float32,
                       device="cuda", **p)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _, ys_h = model.simulate(gen, steps)
    for resampler, kwargs, used in (
            ("metropolis", {"num_steps": 10}, ROLL_KERNELS),
            ("systematic", None, CDF_KERNELS)):
        before = _counts()
        res = bootstrap_filter(0, model, ys_h, n, resampler=resampler,
                               resampler_kwargs=kwargs,
                               return_history=False)
        torch.cuda.synchronize()
        best = math.inf
        for rep in range(3):
            t0 = time.perf_counter()
            res = bootstrap_filter(rep + 1, model, ys_h, n,
                                   resampler=resampler,
                                   resampler_kwargs=kwargs,
                                   return_history=False)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        assert bool(torch.isfinite(res.final_particles).all())
        assert math.isfinite(float(res.log_evidence))
        rate = n * (steps - 1) / best
        ess_rate = float(res.ess.double().sum()) / best
        print(f"  headline MVT df=5 {resampler} N=2^20 T={steps} d=2: "
              f"{rate:.6g} particle-steps/s, {ess_rate:.6g} ESS/s, "
              f"best {best:.4f} s of 3, logZ "
              f"{float(res.log_evidence):.3f} [{card}]")
        _expect_launches(before, _counts(), used, 4 * (steps - 1),
                         f"headline {resampler}", FUSED_KERNELS)


def pallas_path(card: str) -> None:
    """Phase 4b: engine="pallas" through run() and bootstrap_filter, beside
    the composed path."""
    import torch

    import cusmc_tpu_torch
    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    p = demo_model_params()
    ys = load_y_sim()
    T = ys.shape[0]
    _, _, loglik = kalman_filter(ys, **{k: p[k] for k in
                                        ("F", "G", "V", "W", "m0", "C0")})
    for resampler, fused, limit in (
            ("systematic", "fused_cdf_filter_step", 0.02),
            ("stratified", "fused_cdf_filter_step", 0.02),
            ("metropolis", "fused_filter_step", 0.08)):
        before = _counts()
        out = cusmc_tpu_torch.run(
            N=1 << 17, d=2, timeSteps=T, Y=ys, m0=p["m0"], C0=p["C0"],
            F=p["F"], G=p["G"], V=p["V"], W=p["W"], resampler=resampler,
            distribution="mvn", key=1, engine="pallas", device="cuda")
        assert tuple(out["posterior_x"].shape) == (T, 1 << 17, 2)
        for k, v in out.items():
            assert v.is_cuda and bool(torch.isfinite(v).all()), k
        lz = float(out["log_evidence"])
        gap = abs(lz - loglik)
        print(f"  run(engine='pallas') kalman MVN {resampler} N=2^17 T={T}: "
              f"logZ {lz:.3f} vs Kalman {loglik:.3f} (|gap| {gap:.3f}, "
              f"limit {limit * abs(loglik):.3f})")
        assert gap < limit * abs(loglik), f"pallas {resampler}: logZ off"
        _expect_launches(before, _counts(), (fused,), T - 1,
                         f"pallas {resampler}",
                         ROLL_KERNELS + ("inverse_cdf_apply",))

    n, steps = N_BIG, 200
    for d in (D, D_WIDE):
        model = DLM.create(noise="mvt", df=5.0, device="cuda",
                           **demo_model_params(d))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        _, ys_h = model.simulate(gen, steps)
        for resampler, kwargs, fused in (
                ("metropolis", {"num_steps": 10}, "fused_filter_step"),
                ("systematic", None, "fused_cdf_filter_step")):
            # (kernels launched T-1 times per run, kernels not launched)
            used = {"pallas": (fused,) if resampler == "metropolis"
                    else (fused, "blocked_cumsum"),
                    "xla": ROLL_KERNELS if resampler == "metropolis"
                    else CDF_KERNELS}
            spec = {e: (u, tuple(k for k in COMPOSED_KERNELS + FUSED_KERNELS
                                 if k not in u)) for e, u in used.items()}

            def one(engine, seed):
                before = _counts()
                t0 = time.perf_counter()
                res = bootstrap_filter(seed, model, ys_h, n,
                                       resampler=resampler,
                                       resampler_kwargs=kwargs,
                                       engine=engine, return_history=False)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                used, unused = spec[engine]
                after = _counts()
                for name in used:
                    assert after[name] - before[name] == steps - 1, \
                        f"{engine} {resampler}: {name} launched " \
                        f"{after[name] - before[name]} times"
                for name in unused:
                    assert after[name] == before[name], \
                        f"{engine} {resampler}: {name} launched"
                assert bool(torch.isfinite(res.final_particles).all())
                assert math.isfinite(float(res.log_evidence))
                return secs, res

            for engine in ("pallas", "xla"):
                one(engine, 0)  # warm-up
            best = {"pallas": math.inf, "xla": math.inf}
            last = {}
            for rep, engine in enumerate(("pallas", "xla", "xla", "pallas",
                                          "pallas", "xla")):
                secs, last[engine] = one(engine, rep + 1)
                best[engine] = min(best[engine], secs)
            for engine in ("pallas", "xla"):
                res = last[engine]
                rate = n * (steps - 1) / best[engine]
                ess_rate = float(res.ess.double().sum()) / best[engine]
                busy = busy_share(lambda: bootstrap_filter(
                    7, model, ys_h, n, resampler=resampler,
                    resampler_kwargs=kwargs, engine=engine,
                    return_history=False))
                print(f"  {'headline' if d == D else 'full width'} MVT df=5 "
                      f"{resampler} engine={engine} N=2^20 T={steps} d={d}: "
                      f"{rate:.6g} particle-steps/s, {ess_rate:.6g} ESS/s, "
                      f"best {best[engine]:.4f} s of 3, logZ "
                      f"{float(res.log_evidence):.3f}, device busy "
                      f"{busy:.3f} [{card}]")
            print(f"  pallas / xla rate, {resampler} d={d}: "
                  f"{best['xla'] / best['pallas']:.3f}")


def sharded_path(card: str) -> None:
    """Phase 4c: the sharded filter on a one-rank NCCL group, beside the
    single-device residual."""
    import tempfile

    import torch
    import torch.distributed as dist

    import cusmc_tpu_torch
    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.parallel import ParticleAxis, \
        initialize_distributed, process_info, sharded_bootstrap_filter
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    p = demo_model_params()
    ys = load_y_sim()
    T = ys.shape[0]
    _, _, loglik = kalman_filter(ys, **{k: p[k] for k in
                                        ("F", "G", "V", "W", "m0", "C0")})
    # label -> ((kernel, launches per step at least), ...), kernels unused
    expect = {
        "systematic": ((("inverse_cdf_apply[local_base]", 1),
                        ("blocked_cumsum", 1)),
                       ("inverse_cdf_apply", "inverse_cdf_search",
                        "take_columns")),
        "residual": ((("inverse_cdf_search", 2), ("take_columns", 1),
                      ("blocked_cumsum", 2)),
                     ("inverse_cdf_apply", "inverse_cdf_apply[local_base]")),
        "metropolis": ((("roll_metropolis_sweeps_expspace", 1),),
                       CDF_KERNELS + SHARD_KERNELS),
        "single residual": ((("inverse_cdf_apply", 2),
                             ("blocked_cumsum", 2)), SHARD_KERNELS)}

    def launched(label, before, steps):
        after = _counts()
        used, unused = expect[label]
        for name, per_step in used:
            grown = after[name] - before[name]
            assert grown >= per_step * (steps - 1), \
                f"sharded {label}: {name} launched {grown} times"
        for name in unused + FUSED_KERNELS:
            assert after[name] == before[name], \
                f"sharded {label}: {name} launched"
        return ", ".join(f"{k}+{after[k] - before[k]}" for k, _ in used)

    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            axis = ParticleAxis()
            print(f"  process group: {process_info()}, {axis}")
            mvn = DLM.create(noise="mvn", device="cuda", **p)

            def one(label, seed, model, y, n):
                if label == "single residual":
                    return bootstrap_filter(seed, model, y, n,
                                            resampler="residual",
                                            return_history=False)
                return sharded_bootstrap_filter(seed, model, y, n, axis,
                                                resampler=label)

            for label in expect:
                before = _counts()
                if label == "single residual":
                    out = cusmc_tpu_torch.run(
                        N=1 << 17, d=2, timeSteps=T, Y=ys, m0=p["m0"],
                        C0=p["C0"], F=p["F"], G=p["G"], V=p["V"], W=p["W"],
                        resampler="residual", distribution="mvn", key=1,
                        device="cuda")
                    assert tuple(out["posterior_x"].shape) == (T, 1 << 17, 2)
                    for k, v in out.items():
                        assert v.is_cuda and bool(torch.isfinite(v).all()), k
                    lz = float(out["log_evidence"])
                else:
                    res = one(label, 1, mvn, ys, 1 << 17)
                    assert res.final_particles.is_cuda
                    assert tuple(res.final_particles.shape) == (1 << 17, 2)
                    assert bool(torch.isfinite(res.final_particles).all())
                    lz = float(res.log_evidence)
                gap = abs(lz - loglik)
                print(f"  kalman MVN {label} N=2^17 T={T}: logZ {lz:.3f} vs "
                      f"Kalman {loglik:.3f} (|gap| {gap:.3f}, limit "
                      f"{0.02 * abs(loglik):.3f}); launches "
                      f"{launched(label, before, T)}")
                assert gap < 0.02 * abs(loglik), f"sharded {label}: logZ off"

            n, steps = N_BIG, 200
            mvt = DLM.create(noise="mvt", df=5.0, device="cuda", **p)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            _, ys_h = mvt.simulate(gen, steps)
            for label in expect:
                one(label, 0, mvt, ys_h, n)  # warm-up
                torch.cuda.synchronize()
                best = math.inf
                for rep in range(3):
                    before = _counts()
                    t0 = time.perf_counter()
                    res = one(label, rep + 1, mvt, ys_h, n)
                    torch.cuda.synchronize()
                    best = min(best, time.perf_counter() - t0)
                    counts = launched(label, before, steps)
                assert bool(torch.isfinite(res.final_particles).all())
                assert math.isfinite(float(res.log_evidence))
                busy = busy_share(lambda: one(label, 7, mvt, ys_h, n))
                rate = n * (steps - 1) / best
                ess_rate = float(res.ess.double().sum()) / best
                print(f"  headline MVT df=5 {label} N=2^20 T={steps} d=2: "
                      f"{rate:.6g} particle-steps/s, {ess_rate:.6g} ESS/s, "
                      f"best {best:.4f} s of 3, logZ "
                      f"{float(res.log_evidence):.3f}, device busy "
                      f"{busy:.3f}; launches {counts} [{card}]")
        finally:
            dist.destroy_process_group()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cusmc_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_kernels()
    print("kernels against their plain versions:")
    rec = check_kernels()
    rec.update(check_shard_kernels())
    rec.update(check_fused_kernels())
    print("statistics of the fused kernels:")
    check_statistics()

    print("main path:")
    _zero_counts()
    main_path(card)
    launches = {"main": _counts()}
    print("fused path (engine='pallas'):")
    _zero_counts()
    pallas_path(card)
    launches["pallas"] = _counts()
    print("sharded path (one-rank NCCL group):")
    _zero_counts()
    sharded_path(card)
    launches["sharded"] = _counts()

    records = []
    for name, source, replaces, path in KERNELS:
        count = launches[path][name]
        assert count > 0, f"{name} never launched on the {path} path"
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": count,
                        **rec[name]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
