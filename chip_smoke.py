#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cusmc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. The card's name and power limit, from nvidia-smi.
2. Build: nvcc compiles the port's kernels (cusmc_tpu_torch/csrc/*.cu),
   one process per source, all started together.
3. Kernels: each kernel against its plain PyTorch version on the same
   tensors, with the tolerance stated beside each check. The prefix sum,
   the search and the roll walk at N = 2^20 and a ragged N, d = 2 (the
   search-and-apply also at d = 32, timed there too, and on shuffled
   queries; the prefix sum also at a few-element N, on weights that stress
   its tile boundaries, with one kernel a call counted by the profiler and
   the same result on a second call); the fused Metropolis step at
   N = 2^20, d = 2, 16 and 32, MVN and MVT df=5, with the design each d
   takes ("thread" or "tile"); the fused inverse-CDF step, systematic and
   stratified, at N = 2^20 and N = 1_000_448, d = 2, 16 and 32, with its
   design. The search-only kernel, the search-and-apply and the fused
   inverse-CDF step search the cdf through
   a block window; the share of blocks whose stretch fits the window is
   printed for each weight kind. Ancestors must be equal; a
   mismatch is allowed only at an exact accept or cdf tie, and each one is
   shown to be one. Then each kernel's and its plain version's time per
   call (CUDA events, median; launch cost included), device time per call
   (torch.profiler), one PyTorch library call of the same function where
   there is one (event and device time), and the least time the card
   could take (bound). Then the kernels on a bfloat16 state (mixed
   precision): the fused Metropolis step at N = 2^20, d = 2, 16 and 32,
   MVN and MVT df=5, ancestors equal to its plain version's and to the
   float32 kernel's on the same draws, states bitwise but for a 1-ulp
   mismatch shown to sit at a rounding boundary (the plain float32 value
   within BF16_BOUNDARY_RTOL of it), ll at 1e-4 on the particles whose
   states agree; the roll walk and the search-and-apply (both modes) at
   d = 2 and 32, ancestors equal to the float32 run's and values exactly
   the plain version's; take-columns on a bfloat16 state at d = 2 and 32,
   on sorted and on shuffled ancestors, bitwise the plain version's; each
   timed beside its bound at 2-byte states. Then the kernels at the other
   models' widths (phase 4g): the search-and-apply and the roll walk at
   d = 1 and d = 13 (N = 2^20, exp-space and concentrated weights), and
   both fused kernels on the monthly structural DLM, d = 13, k = 1, which
   takes their runtime-width "thread" template (``launch<0, 0>``): the
   Metropolis step MVN and MVT df=5, the CDF step systematic and
   stratified in both; each held to its plain version as above and timed
   beside its bound. Then the cumsum over zero weights at N = 2^20, on
   three families (the stochastic volatility lookahead, a Gaussian
   likelihood of observation variance 0.001, uniform weights half zero;
   ``zero_weight_families``): its steps up over a zero weight and the
   systematic ancestors on zero-weight particles over 32 draws, through
   ``blocked_cumsum`` + ``inverse_cdf_apply`` and through the fused CDF
   step on that cdf, all 0; with ``--against``, the same counts with each
   other tree's cumsum beside them. Every cumsum case of the phase is
   also held bitwise flat over its zero weights.
3b. Statistics of the fused kernels (benchmarks/validate_fused_tpu.py
   checks 1-5d with their thresholds): zero-noise consistency, offspring
   against the indexed Metropolis resampler, noise moments, the inverse-CDF
   sandwich with an exact gather, stratified offspring, and log-evidence
   against the Kalman filter and the composed path.
3c. The "tile" design's oracle, for both fused kernels at d = 16 and 32
   (systematic for the CDF step), the design printed beside each case:
   (1) a dense G with Q = 0 gives G x of the kernel's own ancestors within
   1e-5 of |G| |x| entrywise; (2) X = 0, G = 0 and a dense lower-triangular
   Q give noise whose mean and second moment stay within 5 standard errors
   of 0 and c Q Q' (MVN; MVT df=8 on the Metropolis step, df=5 with
   df_int=5 on the CDF step), m = 2^20; (3) that noise, whitened, is
   uncorrelated between particles i and i+1, i+32 and i+tile and between
   two calls (5 standard errors); (4) the log-evidence of a conditioned
   model (V = 0.1 I, W = C0 = 0.001 I), N = 2^20, T = 101, 4 seeds, both
   engines and both resamplers, within bands of the Kalman value, and the
   fused systematic path within its spread of the composed one. Checks
   1-3 also run on the fused Metropolis kernel's bfloat16 state (check 1
   within half a bfloat16 ulp more), and check 4 on a bfloat16 state for
   its three paths (systematic xla, metropolis on both engines) within
   ORACLE_BANDS_BF16, sized on the CPU before any card run read them.
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
   at the shard shapes of a 4-way split (L = N/4 queries, base p N/4), the
   search-only kernel also on shuffled queries, and times the search-only
   kernel at L = N, L = N/4 strided, the shard-1 shape and shuffled. Then
   one row of a model without packed methods (the demo DLM as a
   ``CustomSSM``: the batch layout and the all-gather op), systematic,
   T=50, which launches the cumsum and the search-only kernel T-1 times
   each and no other kernel.
4d. Mixed precision, with every launch count set to 0 first: a bfloat16
   state (``DLM.create(state_dtype=torch.bfloat16)``) through
   ``bootstrap_filter``, MVT df=5, N=2^20: at d = 2 (T=200) metropolis
   xla, systematic xla and metropolis pallas; at d = 16 and 32 (T=100)
   metropolis on both engines and systematic xla; each beside the float32
   run of the same row in turns, one warm-up and the best of 2,
   particle-steps/s, ESS/s, and from one profiled run of 50 steps the busy
   share and the device kernels a step. A bfloat16 run
   launches its kernels (the fused step's, the roll walk's or the cumsum
   and the search-and-apply's bfloat16 launches) T-1 times each and no
   other.
4e. The generic path (the log-space step), with every launch count set
   to 0 first: the headline model (MVT df=5, N=2^20, T=200, d=2, B=10)
   through ``bootstrap_filter`` with ``debug_checks=True`` for metropolis
   (the roll kernel), systematic (the cumsum and the search-and-apply) and
   residual (the cumsum three times a step, the search-and-apply twice),
   with a custom registry key (the indexed
   Metropolis resampler, then take-columns), in the batch layout and as a
   ``CustomSSM`` (no kernel), and a bfloat16 model at d=32 (T=100) with
   the custom key (take-columns' bfloat16 gather); each one warm-up and
   the best of 2, particle-steps/s, and kernels a step and the busy share
   from a profiled run of 20 steps; each run launches exactly its kernels,
   T-1 times (more for residual). Then the share of ancestors equal
   between the fast and the generic metropolis runs on one seed, and the
   Kalman logZ (MVN, N=2^17, the 1001-step trace, 2% of |loglik|) of six
   generic runs.
4f. The headless runner and the streaming filter, with every launch
   count set to 0 first (the host runtime, ``make -C native``, is built
   first when the checkout has none; the phase fails if its native store
   or writer did not load): the chunk copy to the host and the host
   append (native and numpy) of a 64-step chunk of the headline's
   history, in GB/s; the headline (MVT df=5, N=2^20, T=200, d=2, chunk
   64) for metropolis B=10 and systematic, streamed into the native arena,
   its final particles, log weights, log-evidence, ESS and whole stored
   history bitwise those of ``bootstrap_filter(return_history=True)``,
   then one-shot without and with device history and streaming without
   and with the store, one warm-up and the best of 2 in turns; a disk
   spill (T=50) reopened equal to the arena's history; the d=32 row
   (T=100) streamed without a store, bitwise the one-shot run; halt at a
   NaN in step 50 (MVN, N=2^17, 81 steps, chunk 20: last good step 40, a
   step_40 snapshot) and a resume bitwise the uninterrupted run; the
   streamed log-evidence on the 1001-step trace within 2% of Kalman;
   sharded streaming on a one-rank NCCL group, bitwise the sharded
   one-shot run; and ``python -m cusmc_tpu_torch`` as subprocesses
   (``demo``; ``run`` of an MVN config on the bundled trace plain with
   ``--output-dir``, with ``--stream 64 --checkpoint``, then
   ``--resume``), their log-evidence within 2% of Kalman and equal to
   each other. Each streaming run launches its kernels T-1 times.
4g. The other models and the auxiliary family, with every launch count
   set to 0 first; each row one warm-up and the best of 2, its rate, and
   exact launches (T-1 of each of its kernels, none of any other; the
   kernels' wrappers are watched for the state width they are given):
   the stochastic volatility model (mu=-1, phi=0.95, sigma=0.3, beta=1;
   N=2^20, T=200, d=1) through ``bootstrap_filter``, metropolis B=10 (the
   roll walk) and systematic (the cumsum and the search-and-apply), each
   log-evidence within SV_APF_BAND of ``auxiliary_filter``'s on the same
   trace (and the fault of a float32 registry cdf shown: its zero-weight
   ancestors, and the APF's evidence with it); UNGM (q=10, r=1; N=2^20,
   T=100, systematic, with history), its
   filtered means against the dense-grid filter (median error < 0.5,
   mean < 1.5, tests/test_ungm.py); the monthly structural DLM
   (``local_linear_trend`` + ``seasonal(12)``, prior variance 0.01, MVN,
   d=13, k=1; N=2^20, T=200), metropolis and systematic on engine "xla"
   (the roll walk; the cumsum and the search-and-apply) and "pallas" (the
   two fused kernels), log-evidence within 2% of Kalman (8% for the
   windowed fused metropolis, as phase 4b); then the aux table at
   benchmarks/bench_subsystems.py's sizes, T=200, none of which launches
   a kernel: the RBPF on the offset CLGSSM (N=16384; the shared
   covariance and the general bank), the EnKF (d=16 at N=16384
   and 65536, d=64 at 65536; means against Kalman within 5% of scale),
   the fully adapted APF (N=65536, 2% of Kalman), Liu-West (N=32768),
   FFBS (M=256 over a systematic run's N=8192 history, draw-steps/s, the
   device time of its transition matrix, categorical draw and gather, and
   the smoothed means against RTS as tests/test_ffbs.py holds them),
   particle Gibbs (N=512, 20 sweeps, seconds a sweep) and ``forecast``
   (h=20 from the APF's cloud, predictive means against Kalman's).
4h. The rest of the sharded family and MCMC part 1, with every launch
   count set to 0 first. On a one-rank NCCL group: the sharded filter on
   a bfloat16 state (MVT df=5, N=2^20; the headline, d=2, T=200, and the
   full width, d=32, T=100) for systematic, residual and metropolis, each
   bitwise the run of the same ops and streams without collectives (and,
   for metropolis, the single-device run), its exact bfloat16 launches
   (the local-block search-and-apply, take-columns, the roll apply), and
   its rate beside the float32 sharded row's in turns; the
   ensemble-sharded EnKF (d=64, N=65536, T=200) bitwise the
   single-device EnKF and within 5% of Kalman; replicated filters on a
   (1, 1) grid (R=4, N=2^20, the 101-step trace, MVN, metropolis and
   systematic), each replicate within 8% of Kalman's logZ, all distinct.
   Then MCMC at benchmarks/bench_mh.py's configuration (1024 chains,
   d=128, MVT df=8): MH and adaptive MH (2000 sweeps, bfloat16 noise,
   ``chol_every=50``), MALA (2000), HMC (200 of L=10), chain-steps/s and
   gradient evaluations/s; and kept runs whose marginal variance, split
   R-hat and acceptance must sit in bands sized on the CPU
   (``mcmc_rows``), then the drift of MH's bfloat16 noise, shown.
5. The block-window kernels on the main paths' own inputs, kept at steps
   0, 99 and 198 of the warm-up runs of phases 4 (the search-and-apply of
   the composed systematic headline, d = 2), 4b (the fused CDF step of the
   systematic pallas runs, d = 2 and 32; the search-and-apply of the
   composed systematic run at d = 32) and 4c (the search-only kernel's two
   calls a step of the sharded residual run; the search-and-apply's two
   calls a step of the single-device residual run and its local-block
   mode in the sharded systematic run): the spans of the cdf that their
   blocks search, the share of blocks that fits the window (and would fit
   one a quarter, half or twice as large), each kernel against its plain
   version, and its device time; the same for the search-only kernel's
   shuffled queries of phase 3.
   ``--against DIR [DIR ...]`` times the same kernels of other checkouts
   of the repo (the parent commit unpacked with ``git archive``, say)
   beside this tree's on those inputs.

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card the
script prints no result and exits with code 2.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
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
D_MID = 16   # the narrower width of the fused steps' "tile" design
D_WIDE = 32
TIMING_REPS = 20
PLAIN_FUSED_REPS = 5      # the plain fused steps take tens of ms a call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published (700 W part)
FP32_FLOPS = 67e12         # H100 SXM, float32 outside the tensor cores
TF32_FLOPS = 495e12        # H100 SXM, TF32 on the tensor cores, dense
BF16_FLOPS = 989e12        # H100 SXM, bf16 on the tensor cores, dense
ACCEPT_TIE = 2.0 ** -22    # two float32 ulps, relative


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(title: str):
    """Print a phase's title before it and its wall time after it."""
    print(f"{title}:")
    t0 = time.perf_counter()
    yield
    print(f"  (phase: {time.perf_counter() - t0:.1f} s)")


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


def _profile_kernels(fn, reps: int, attempts: int = 3) -> dict:
    """kernel name -> (launches, device microseconds) that torch.profiler
    recorded over ``reps`` calls of ``fn``. torch.profiler has returned
    no kernel record at all for a whole profiling session, in a process
    that followed another profiling process: such a session is run
    again, up to ``attempts`` times (an empty result then fails the
    caller's check)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = {e.key: (e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
        if kernels:
            return kernels
        print("  (torch.profiler recorded no kernel; profiling again)")
    return {}


def device_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time per call of ``fn``: each kernel's mean duration over
    ``reps`` calls (torch.profiler) times its launches a call, summed;
    without the host's launch cost that the event timing of a short call
    also holds. The profiler can drop kernel records, so a kernel's
    launches a call are its recorded launches over ``reps``, rounded, and
    its mean is taken over the records it kept."""
    fn()
    total_us = 0.0
    for name, (count, us) in _profile_kernels(fn, reps).items():
        per_call = max(1, round(count / reps))
        if count != per_call * reps:
            print(f"  (torch.profiler kept {count} of {per_call * reps} "
                  f"launches of {name[:60]})")
        total_us += us / count * per_call
    assert total_us > 0, "the profiler saw no device time"
    return total_us / 1e3


def device_busy(fn) -> tuple:
    """(busy share, kernel launches) of one call of ``fn``: kernel time
    summed by torch.profiler over the call's wall time (host and device
    traced), and the kernel records it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    return busy_us / 1e6 / wall, sum(e.count for e in kernels)


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over ``peak``, the rate of
    their type (float32 outside the tensor cores unless given), both the
    published H100 SXM peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernel(name, kern, plain, library, label, nbytes, flops,
                plain_reps=TIMING_REPS, peak=FP32_FLOPS) -> dict:
    """Times a kernel, its plain version (alternating plain, kernel,
    kernel, plain) and the library call, each by CUDA events and by device
    time; returns the record fields. ``flops`` are operations at the
    ``peak`` rate."""
    p1 = median_ms(plain, plain_reps)
    k1 = median_ms(kern)
    k2 = median_ms(kern)
    p2 = median_ms(plain, plain_reps)
    lib = None if library is None else median_ms(library)
    dk = device_ms(kern)
    dp = device_ms(plain, plain_reps)
    dl = None if library is None else device_ms(library)
    bound_ms, bound_by = bound(nbytes, flops, peak)
    print(f"  time {name} {label}: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms per call (CUDA events, median); device "
          f"time per call: kernel {dk:.4f} ms, plain {dp:.4f} ms "
          f"(torch.profiler); library "
          f"{'none' if lib is None else f'{lib:.4f} ms, device {dl:.4f} ms'}"
          f"; bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s)")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib,
            "device_ms": dk, "library_device_ms": dl}


def kernels_per_call(fn, reps: int = TIMING_REPS) -> int:
    """The number of device kernels one call of ``fn`` launches: the
    launches torch.profiler recorded over ``reps`` calls, over ``reps``,
    rounded."""
    fn()
    kernels = _profile_kernels(fn, reps)
    return round(sum(count for count, _ in kernels.values()) / reps)


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
    """Kernel vs plain (torch.cumsum) vs float64: monotone, and within the
    worst-case f32 bound of csrc/cumsum.cu: at most 26 + tiles roundings
    per element (15 in-thread, 5 shuffle and 4 warp-offset levels, the two
    additions applying them, one per earlier tile, the final one), so
    |cdf - exact| <= gamma(26 + tiles) total, gamma(k) = k u / (1 - k u),
    u = 2^-24."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import FOLD, TILE, blocked_cumsum, \
        blocked_cumsum_plain

    n = w.shape[0]
    cdf, cdf128 = blocked_cumsum(w)
    plain, _ = blocked_cumsum_plain(w)
    ref = torch.cumsum(w.double(), 0)
    total = float(ref[-1])
    k = 26 + -(-n // TILE)
    u = 2.0 ** -24
    bound_ = k * u / (1.0 - k * u) * total
    err64 = float((cdf.double() - ref).abs().max())
    err_plain = float((cdf - plain).abs().max())
    assert bool(torch.all(cdf[1:] >= cdf[:-1])), f"{name}: cdf not monotone"
    steps = zero_steps(w, cdf)
    assert steps == 0, f"{name}: the cdf steps up over {steps} zero weights"
    assert err64 <= bound_, f"{name}: |cdf - f64| = {err64} > {bound_}"
    assert torch.equal(cdf128, cdf[FOLD - 1::FOLD])
    again, _ = blocked_cumsum(w)
    assert torch.equal(again, cdf), f"{name}: a second call differs"
    print(f"  cumsum {name}: N={n} max|kernel-f64|={err64:.3e} "
          f"max|kernel-plain|={err_plain:.3e} bound={bound_:.3e} monotone, "
          f"flat over zero weights, the same on a second call")
    return err_plain


# -- the cumsum over zero weights ------------------------------------------

# Systematic offsets each weight family is resampled with when ancestors on
# zero-weight particles are counted.
ZERO_FAMILY_DRAWS = 32


def zero_weight_families(n, dev, seed=0) -> dict:
    """name -> exp-space weights [n] (max-normalised, as the filter carries
    them) with many zeros, the three families of the cumsum's flatness
    check: the stochastic volatility lookahead at y = 3 (x ~ N(-1, 1),
    log w = -(x + 9 exp(-x)) / 2; phase 4g's registry_cdf_fault), a
    Gaussian likelihood with observation variance 0.001 (x ~ N(0, 1),
    y = 0.7), and uniform weights of which a random half are zero."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = -1.0 + torch.randn(n, generator=gen, device=dev)
    lw_sv = -0.5 * (x + 9.0 * torch.exp(-x))
    z = torch.randn(n, generator=gen, device=dev)
    lw_gauss = -0.5 * (z - 0.7) ** 2 / 0.001
    unif = torch.rand(n, generator=gen, device=dev)
    unif[torch.rand(n, generator=gen, device=dev) < 0.5] = 0.0
    return {"sv-lookahead": torch.exp(lw_sv - lw_sv.max()),
            "gaussian-0.001": torch.exp(lw_gauss - lw_gauss.max()),
            "uniform-half-zero": unif}


def zero_steps(w, cdf) -> int:
    """The places where ``cdf`` moves over a zero weight: cdf[j] !=
    cdf[j-1] where w[j] = 0, and cdf[0] != 0 where w[0] = 0."""
    zero = w == 0
    steps = int(((cdf[1:] != cdf[:-1]) & zero[1:]).sum())
    return steps + int(bool(zero[0]) and float(cdf[0]) != 0.0)


def zero_ancestors(w, cdf, u, a) -> tuple:
    """(ancestors on zero-weight particles, positions at or above the
    total) of a systematic draw with offset ``u`` through ``cdf``:
    positions (i + u) / N * cdf[N-1], as the filter makes them. A position
    at the total (u near 1) is clipped to N - 1, the reference's own law,
    whatever that particle's weight: it is counted apart."""
    import torch

    from cusmc_tpu_torch.resampling.classic import systematic_from_uniforms

    pos = systematic_from_uniforms(u, cdf.numel()) * cdf[-1]
    inside = pos < cdf[-1]
    on_zero = (w[a.long()] == 0) & inside
    return int(on_zero.sum()), int((~inside).sum())


def check_zero_steps(others) -> int:
    """Phase 3: the kernel path's cdf over zero weights, on the three
    families of ``zero_weight_families`` at N = 2^20: the cumsum's steps
    over zeros, and the systematic ancestors on zero-weight particles
    through ``blocked_cumsum`` + ``inverse_cdf_apply`` and through the
    fused CDF step (d = 2, MVT df=5) on that cdf, over ZERO_FAMILY_DRAWS
    offsets; beside them the same counts with the cumsum (and searches)
    of each tree in ``others`` (``other_tree``). This tree's counts must
    be 0. Returns this tree's steps over zeros (0)."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_cdf_step import cdf_auto_tile, \
        fused_cdf_filter_step, fused_cdf_filter_step_draws
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply
    from cusmc_tpu_torch.resampling.classic import systematic_from_uniforms

    dev = torch.device("cuda")
    n = N_BIG
    gen = torch.Generator(device=dev).manual_seed(77)
    m, (G, Q, F, Li) = _fused_model(D, "mvt", dev)
    X, _, y = _state(gen, D, n, dev)
    draws = [fused_cdf_filter_step_draws(gen, dev)
             for _ in range(ZERO_FAMILY_DRAWS)]
    kw = dict(noise="mvt", mode="systematic", tile=cdf_auto_tile(n, D),
              df_int=m.df_int)

    def rest(cdf, u, seed):
        return (cdf, X, y, G, Q, F, Li, m.df_value, float(m.log_norm),
                (u, seed))

    def counts(w, cdf, apply, fused):
        c = [0, 0, 0]
        for u, seed in draws:
            pos = systematic_from_uniforms(u, n) * cdf[-1]
            on_a, clip = zero_ancestors(w, cdf, u, apply(cdf, pos))
            on_f, _ = zero_ancestors(w, cdf, u, fused(rest(cdf, u, seed)))
            c[0] += on_a
            c[1] += on_f
            c[2] += clip
        return zero_steps(w, cdf), c

    total = 0
    for name, w in zero_weight_families(n, dev).items():
        cdf, _ = blocked_cumsum(w)
        steps, (on_a, on_f, clip) = counts(
            w, cdf, lambda c, p: inverse_cdf_apply(c, p, X)[1],
            lambda args: fused_cdf_filter_step(*args, **kw)[2])
        line = (f"  cumsum over zeros, {name} (N=2^20, {int((w == 0).sum())}"
                f" zero weights, {ZERO_FAMILY_DRAWS} systematic draws): this "
                f"tree: steps up over a zero {steps}, ancestors on zero "
                f"weights {on_a} (cumsum + search-and-apply), {on_f} (fused "
                f"CDF step); positions at the total {clip}")
        for root, fns in others:
            cdf_o = fns["blocked_cumsum"](w)
            steps_o, (oa, of, _) = counts(
                w, cdf_o,
                lambda c, p: fns["inverse_cdf_apply"]((c, p, X), {}),
                lambda args: fns["fused_cdf_filter_step"](args, kw))
            line += (f"; {root}: steps {steps_o}, ancestors on zero weights "
                     f"{oa} / {of}")
        print(line)
        assert steps == 0 and on_a == 0 and on_f == 0, \
            f"{name}: the kernel path gives zero weights mass"
        total += steps
    torch.cuda.synchronize()
    return total


def _adversarial_weights(gen, n, dev):
    """Weights that stress the tile boundaries: magnitudes over 2^40
    (2^-40 .. 1), zero runs of 9000 elements (longer than a tile) every
    12288, so that whole tiles and tile edges carry no mass, and a heavy
    head so the total dwarfs the small tails."""
    import torch

    e = torch.randint(-40, 1, (n,), generator=gen, device=dev)
    w = torch.exp2(e.float()) * torch.rand(n, generator=gen, device=dev)
    i = torch.arange(n, device=dev)
    w[(i % 12288) >= 3288] = 0.0
    w[:min(n, 3)] = 1.0
    return w


def _search_case(cdf, X, name, order=None):
    """Kernel vs plain (searchsorted + gather) on the same monotone cdf and
    systematic positions (taken in ``order``, a permutation, when given):
    ancestors and values exactly equal."""
    import torch

    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_apply_plain

    n = cdf.shape[0]
    u = torch.rand((), device=cdf.device)
    pos = (torch.arange(n, device=cdf.device, dtype=torch.float32) + u) / n
    pos = pos * cdf[-1]
    if order is not None:
        pos = pos[order]
    y, a = inverse_cdf_apply(cdf, pos, X)
    y_p, a_p = inverse_cdf_apply_plain(cdf, pos, X)
    assert torch.equal(a, a_p), f"{name}: ancestors differ " \
        f"({int((a != a_p).sum())} of {n})"
    assert torch.equal(y, y_p), f"{name}: values differ"
    assert int(a.min()) >= 0 and int(a.max()) <= n - 1
    print(f"  search {name}: N={n} d={X.shape[0]} ancestors and values "
          f"equal ({int(torch.unique(a).numel())} distinct ancestors)")
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
                 ("concentrated", w_conc), ("zero-runs", w_zero),
                 ("adversarial", _adversarial_weights(gen, n, dev)))]
        serrs = []
        X32 = torch.randn((D_WIDE, n), generator=gen, device=dev)
        shuffle = torch.randperm(n, generator=gen, device=dev)
        for name, w in (("exp", w_exp), ("uniform", w_unif),
                        ("concentrated", w_conc), ("zero-runs", w_zero)):
            cdf, _ = blocked_cumsum(w)
            serrs.append(_search_case(cdf, X, f"{tag}/{name}"))
            serrs.append(_search_case(cdf, X32, f"{tag}/{name}"))
            serrs.append(_search_case(cdf, X, f"{tag}/{name} shuffled",
                                      shuffle))
        rerrs = []
        for name, w in (("exp", w_exp), ("uniform", w_unif),
                        ("concentrated", w_conc)):
            shifts, u, e = _rolls_case(w, X, gen, f"{tag}/{name}")
            rerrs.append(e)
        if n != N_BIG:
            continue

        for m in (1, 2, 5, 8191, 8193, 3 * 8192 + 7):
            for name, w in (("uniform", w_unif[:m].contiguous()),
                            ("adversarial", _adversarial_weights(gen, m,
                                                                 dev))):
                errs.append(_cumsum_case(w, f"few/{name}"))
        count = kernels_per_call(lambda: blocked_cumsum(w_exp))
        assert count == 1, f"blocked_cumsum ran {count} kernels a call"
        print(f"  cumsum N=2^20: {count} kernel a call (torch.profiler)")
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
        # The composed systematic step at full width gathers 32 rows.
        time_kernel("inverse_cdf_apply", lambda: inverse_cdf_apply(cdf, pos,
                                                                   X32),
                    lambda: inverse_cdf_apply_plain(cdf, pos, X32),
                    lambda: X32.index_select(1, torch.searchsorted(
                        cdf, pos, right=True)),
                    f"N=2^20 d={D_WIDE} (library: searchsorted + "
                    f"index_select)", (12 + 8 * D_WIDE) * n, 0)
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
    from cusmc_tpu_torch.ops.kernels import CDF_BLOCK, CDF_WINDOW
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_apply_plain, inverse_cdf_search, \
        inverse_cdf_search_plain, take_columns, take_columns_plain, \
        window_fit_share

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
    shuffle = torch.randperm(n, generator=gen, device=dev)
    for wname, w in weights.items():
        cdf, _ = blocked_cumsum(w)
        pos = unit * cdf[-1]
        shares = []
        for label, q in (("L=N", pos), ("L=N/4 strided", pos[::4]),
                         ("L=N/4 shard 1", pos[L:2 * L]),
                         ("L=N shuffled", pos[shuffle])):
            q = q.contiguous()
            a = inverse_cdf_search(cdf, q)
            a_p = inverse_cdf_search_plain(cdf, q)
            ties += _ancestors_equal(f"search {wname} {label}", a, a_p, cdf,
                                     q)
            serr = max(serr, float((a - a_p).abs().max()))
            fit = window_fit_share(cdf, q)
            shares.append(f"search-only {label} {fit:.3f}")
        fit = window_fit_share(cdf, pos, CDF_BLOCK, CDF_WINDOW, ends=True)
        shares.append(f"fused CDF step (systematic positions) {fit:.3f}")
        print(f"  window-path share of blocks, {wname} weights: "
              + ", ".join(shares))
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
    print(f"  inverse_cdf_search (L=N, N/4 strided, N/4 of shard 1, L=N "
          f"shuffled), "
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
    # Shuffled queries: the kernel's contract, on no main path (every block
    # spans the whole cdf and searches it in place).
    for shape, q in (("L=N/4 strided", pos[::4]),
                     ("4-way shard shape: shard 1, L=N/4", pos[L:2 * L]),
                     ("L=N shuffled", pos[shuffle])):
        q = q.contiguous()
        # Bytes: 8 per query and 4 per cdf entry between its extremes.
        span = torch.searchsorted(cdf, torch.stack([q.min(), q.max()]),
                                  right=True)
        nbytes = 8 * q.numel() + 4 * (int(span[1] - span[0]) + 1)
        time_kernel("inverse_cdf_search",
                    lambda q=q: inverse_cdf_search(cdf, q),
                    lambda q=q: inverse_cdf_search_plain(cdf, q),
                    lambda q=q: torch.searchsorted(cdf, q, right=True),
                    f"N=2^20 {shape} (library: searchsorted)", nbytes, 0)
    # Phase 5 times the shuffled queries beside other trees too.
    TRAFFIC["inverse_cdf_search", "search-only kernel, L=N shuffled queries "
            "(exp weights; on no main path)"] = [
        (None, (cdf, pos[shuffle].contiguous()), {})]
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

def _fused_model(d, noise, dev, state_dtype=None):
    """The demo DLM of width d on the card (``state_dtype``: its state's
    type, None for float32), and its kernel arguments."""
    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM

    m = DLM.create(noise=noise, df=5.0 if noise == "mvt" else None,
                   device=dev, state_dtype=state_dtype,
                   **demo_model_params(d))
    mats = tuple(t.contiguous() for t in (m.G, m.W_sqrt, m.F, m.V_chol_inv))
    return m, mats


def _state(gen, d, n, dev, k=None):
    """A particle cloud near the demo trace, max-normalised log weights
    with the spread of a filter step, and an observation of k (None: d)
    rows."""
    import torch

    X = 0.1 * torch.randn((d, n), generator=gen, device=dev)
    ll = -25.0 * torch.randn(n, generator=gen, device=dev) ** 2
    y = torch.full((d if k is None else k,), 0.05, device=dev)
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


def _model_mats(m):
    """A DLM and its fused kernels' arguments (G, Q, F, Li), contiguous."""
    return m, tuple(t.contiguous() for t in (m.G, m.W_sqrt, m.F,
                                             m.V_chol_inv))


def _fused_step_case(n, d, noise, gen, dev, model=None):
    """The fused Metropolis step against its plain version on the demo DLM
    of width d, or on ``model`` (a DLM of width d with its own k)."""
    import torch

    from cusmc_tpu_torch.ops.fused_step import auto_tile, \
        fused_filter_step, fused_filter_step_draws, fused_filter_step_plain, \
        step_path

    m, (G, Q, F, Li) = (_fused_model(d, noise, dev) if model is None
                        else _model_mats(model))
    k = m.obs_dim
    X, logw, y = _state(gen, d, n, dev, k)
    tile = auto_tile(n, max(d, k))
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

    label = (f"fused_step N={n} d={d} k={k} {noise} tile={tile} "
             f"path={step_path(d, k)}")
    err, nbad = _compare(label, a, a_p, (x, ll), (x_p, ll_p), ties)
    moved = float((a != torch.arange(n, device=dev)).float().mean())
    print(f"  {label}: ancestors {'equal' if not nbad else 'equal but ties'}"
          f", max|kernel-plain| {err:.3e} (states, ll), moved share "
          f"{moved:.3f}")
    return err, args, kw


def _fused_cdf_case(n, d, mode, gen, dev, model=None):
    """The fused CDF step against its plain version on the demo DLM of
    width d (MVT df=5), or on ``model``."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_cdf_step import cdf_auto_tile, \
        fused_cdf_filter_step, fused_cdf_filter_step_draws, \
        fused_cdf_filter_step_plain
    from cusmc_tpu_torch.ops.fused_step import step_path, to_uniform
    from cusmc_tpu_torch.ops.philox import philox_bits

    m, (G, Q, F, Li) = (_fused_model(d, "mvt", dev) if model is None
                        else _model_mats(model))
    k = m.obs_dim
    X, logw, y = _state(gen, d, n, dev, k)
    cdf, _ = blocked_cumsum(torch.exp(logw))
    tile = cdf_auto_tile(n, max(d, k))
    draws = fused_cdf_filter_step_draws(gen, dev)
    df = m.df_value if m.noise == "mvt" else None
    args = (cdf, X, y, G, Q, F, Li, df, float(m.log_norm), draws)
    kw = dict(noise=m.noise, mode=mode, tile=tile, df_int=m.df_int)
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

    label = f"fused_cdf {mode} N={n} d={d} k={k} {m.noise} tile={tile} " \
        f"path={step_path(d, k)}"
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
        fused_filter_step_plain, step_path

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    rec = {}
    step_errs, step_cases = [], {}
    for d in (D, D_MID, D_WIDE):
        for noise in ("mvn", "mvt"):
            err, args, kw = _fused_step_case(N_BIG, d, noise, gen, dev)
            step_errs.append(err)
            if noise == "mvt":
                step_cases[d] = (args, kw)
    cdf_errs, cdf_cases = [], {}
    for n in (N_BIG, N_RAGGED_CDF):
        for d in (D, D_MID, D_WIDE):
            for mode in ("systematic", "stratified"):
                err, args, kw = _fused_cdf_case(n, d, mode, gen, dev)
                cdf_errs.append(err)
                if n == N_BIG and mode == "systematic":
                    cdf_cases[d] = (args, kw)
    for d in (D_WIDE, D_MID, D):  # d = 2 last: its numbers are recorded
        flops = 2.0 * 4 * d * d * N_BIG   # G, Q, F, Li at k = d
        peak = FP32_FLOPS
        if step_path(d, d) == "tile":
            # Each product as three TF32 tensor-core products (3xTF32).
            flops, peak = 3 * flops, TF32_FLOPS
        nbytes = (8 * d + 12) * N_BIG
        args, kw = step_cases[d]
        rec["fused_filter_step"] = dict(max_abs_err=max(step_errs),
                                        **time_kernel(
            "fused_filter_step", lambda: fused_filter_step(*args, **kw),
            lambda: fused_filter_step_plain(*args, **kw), None,
            f"N=2^20 d={d} MVT df=5 B=10 tile={kw['tile']} "
            f"path={step_path(d, d)}", nbytes, flops, PLAIN_FUSED_REPS, peak))
        cargs, ckw = cdf_cases[d]
        rec["fused_cdf_filter_step"] = dict(max_abs_err=max(cdf_errs),
                                            **time_kernel(
            "fused_cdf_filter_step",
            lambda: fused_cdf_filter_step(*cargs, **ckw),
            lambda: fused_cdf_filter_step_plain(*cargs, **ckw), None,
            f"N=2^20 d={d} MVT df=5 systematic tile={ckw['tile']} "
            f"path={step_path(d, d)}", nbytes, flops, PLAIN_FUSED_REPS, peak))
    torch.cuda.synchronize()
    return rec


# -- the kernels at the widths of the other models (phase 4g) -------------

# The stochastic volatility model and UNGM run the packed fast step on a
# state of one row; the monthly structural DLM (a local linear trend and a
# 12-period seasonal) is d = 13 with k = 1, which takes both fused kernels'
# runtime-width "thread" template (launch<0, 0>).
D_ONE = 1
D_MONTHLY = 13


def monthly_components():
    """The monthly structural DLM's components. The builders' default
    prior C0 = I on all 13 states is far wider than a year of data pins
    down, and a bootstrap filter's evidence then falls far below Kalman's
    (the impoverishment tests/test_structural.py:62-67 warns of); a prior
    of variance 0.01 keeps the default noise variances and passes."""
    from cusmc_tpu_torch.models import structural

    return [structural.local_linear_trend(init_var=0.01),
            structural.seasonal(12, init_var=0.01)]


def monthly_model(dev, noise="mvn"):
    from cusmc_tpu_torch.models.structural import combine

    return combine(monthly_components(), noise=noise,
                   df=5.0 if noise == "mvt" else None, device=dev)


def fused_bound(d, k, n):
    """(bytes, flops) of one fused step: X read and written, the log
    weights read, ll and the ancestors written; the G, Q, F and Li
    products."""
    return (8 * d + 12) * n, 2.0 * (2 * d * d + k * d + k * k) * n


def check_model_kernels() -> None:
    """Phase 3 at the widths phase 4g gives the existing kernels: the
    search-and-apply and the roll walk at d = 1 and d = 13 (N = 2^20, on
    exp-space and concentrated weights), and both fused kernels on the
    monthly structural DLM (d = 13, k = 1; the Metropolis step MVN and MVT
    df=5, the CDF step systematic and stratified, MVN and MVT df=5), each
    against its plain version as the rest of phase 3 holds them, then
    timed beside its bound."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_cdf_step import fused_cdf_filter_step, \
        fused_cdf_filter_step_plain
    from cusmc_tpu_torch.ops.fused_step import fused_filter_step, \
        fused_filter_step_plain, step_path
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_apply_plain
    from cusmc_tpu_torch.resampling.rolls import \
        roll_metropolis_sweeps_expspace, \
        roll_metropolis_sweeps_expspace_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    n, b = N_BIG, 10
    ll = -0.5 * torch.randn(n, generator=gen, device=dev) ** 2 * 50.0
    w_exp = torch.exp(ll - ll.max())
    w_conc = torch.full((n,), 1e-12, device=dev)
    w_conc[n // 3] = 1.0
    cdf, _ = blocked_cumsum(w_exp)
    pos = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) / n \
        * cdf[-1]
    for d in (D_ONE, D_MONTHLY):
        X = torch.randn((d, n), generator=gen, device=dev)
        for name, w in (("exp", w_exp), ("concentrated", w_conc)):
            _search_case(blocked_cumsum(w)[0], X, f"2^20/{name}")
            shifts, u, _ = _rolls_case(w, X, gen, f"2^20/{name} d={d}")
        time_kernel("inverse_cdf_apply",
                    lambda: inverse_cdf_apply(cdf, pos, X),
                    lambda: inverse_cdf_apply_plain(cdf, pos, X),
                    lambda: X.index_select(1, torch.searchsorted(
                        cdf, pos, right=True)),
                    f"N=2^20 d={d} (library: searchsorted + index_select)",
                    (12 + 8 * d) * n, 0)
        time_kernel("roll_metropolis_sweeps_expspace",
                    lambda: roll_metropolis_sweeps_expspace(w_exp, shifts, u,
                                                            X),
                    lambda: roll_metropolis_sweeps_expspace_plain(
                        w_exp, shifts, u, X),
                    None, f"N=2^20 d={d} B={b}", (8 + 4 * b + 8 * d) * n,
                    b * n)
    d, k = D_MONTHLY, 1
    cases = {}
    for noise in ("mvn", "mvt"):
        model = monthly_model(dev, noise)
        _, args, kw = _fused_step_case(n, d, noise, gen, dev, model=model)
        cases["step", noise] = (args, kw)
        for mode in ("systematic", "stratified"):
            _, args, kw = _fused_cdf_case(n, d, mode, gen, dev, model=model)
            cases["cdf", noise, mode] = (args, kw)
    assert step_path(d, k) == "thread"
    nbytes, flops = fused_bound(d, k, n)
    for noise in ("mvn", "mvt"):
        args, kw = cases["step", noise]
        time_kernel("fused_filter_step",
                    lambda: fused_filter_step(*args, **kw),
                    lambda: fused_filter_step_plain(*args, **kw), None,
                    f"N=2^20 d={d} k={k} {noise} B=10 tile={kw['tile']} "
                    f"path=thread (launch<0, 0>)", nbytes, flops,
                    PLAIN_FUSED_REPS)
        args, kw = cases["cdf", noise, "systematic"]
        time_kernel("fused_cdf_filter_step",
                    lambda: fused_cdf_filter_step(*args, **kw),
                    lambda: fused_cdf_filter_step_plain(*args, **kw), None,
                    f"N=2^20 d={d} k={k} {noise} systematic "
                    f"tile={kw['tile']} path=thread (launch<0, 0>)", nbytes,
                    flops, PLAIN_FUSED_REPS)
    torch.cuda.synchronize()


# -- the bfloat16 (mixed-precision) state ---------------------------------

# A bfloat16 state the fused kernel stores may sit one bfloat16 ulp from
# its plain version's where the two round a float32 sum that lies on the
# boundary between two bfloat16 values: the kernel sums its products in
# FMA chains or, in the "tile" design, on the tensor cores, whose float32
# accumulation may differ from a sequential sum by a few ulps. Such a
# mismatch passes when the plain version's float32 value before rounding
# lies within this relative distance of that boundary.
BF16_BOUNDARY_RTOL = 1e-5


def bf16_state_mismatches(x, x_plain, x_pre, rtol=BF16_BOUNDARY_RTOL):
    """The mask of bfloat16 states that differ from the plain version's;
    each must be one ulp off with the plain float32 value before rounding
    (``x_pre``) within ``rtol`` of the boundary between the two. Returns
    ``(mask, largest relative distance to the boundary)``."""
    import torch

    diff = x != x_plain
    if not bool(diff.any()):
        return diff, 0.0
    ulps = (x.view(torch.int16).int() - x_plain.view(torch.int16).int())
    assert int(ulps.abs()[diff].max()) == 1, "a state is > 1 ulp off"
    mid = (x.float()[diff] + x_plain.float()[diff]) / 2
    dist = float(((x_pre[diff] - mid).abs() / mid.abs()).max())
    assert dist <= rtol, f"a 1-ulp mismatch {dist:.3e} off its boundary"
    return diff, dist


def _fused_step_case_bf16(n, d, noise, gen, dev):
    """The fused Metropolis step on a bfloat16 state against its plain
    version: ancestors equal (ties shown) and equal to the float32
    kernel's on the same draws and weights; states bitwise but for shown
    boundary mismatches; ll at rtol 1e-4, atol 1e-4 on the particles whose
    states agree."""
    import torch

    from cusmc_tpu_torch.ops.fused_step import auto_tile, \
        fused_filter_step, fused_filter_step_draws, fused_filter_step_plain, \
        step_path

    m, (G, Q, F, Li) = _fused_model(d, noise, dev, torch.bfloat16)
    X32, logw, y = _state(gen, d, n, dev)
    X = X32.to(torch.bfloat16)
    tile = auto_tile(n, d, 2)
    draws = fused_filter_step_draws(gen, n, tile, dev)
    df = m.df_value if noise == "mvt" else None
    args = (X, logw, y, G, Q, F, Li, df, float(m.log_norm), draws)
    kw = dict(noise=noise, num_sweeps=10, tile=tile, df_int=m.df_int,
              num_window_tiles=2)
    x, ll, a = fused_filter_step(*args, **kw)
    x_p, ll_p, a_p, x_pre = fused_filter_step_plain(*args, **kw,
                                                    pre_rounding=True)
    _, (G32, Q32, F32, Li32) = _fused_model(d, noise, dev)
    _, _, a32 = fused_filter_step(X32, logw, y, G32, Q32, F32, Li32,
                                  *args[7:], **kw)
    assert torch.equal(a, a32), "bf16 and f32 ancestors differ"

    def ties(bad):
        for p in bad[:1000].tolist():
            margin = _metropolis_margin(X32, logw, draws, tile, 2, 10, p)
            assert margin <= ACCEPT_TIE, f"slot {p}: margin {margin}"

    label = (f"fused_step[bf16] N={n} d={d} {noise} tile={tile} "
             f"path={step_path(d, d)}")
    bad = (a != a_p).nonzero().flatten()
    assert bad.numel() <= 1000, f"{label}: {bad.numel()} ancestors differ"
    ties(bad)
    keep = a == a_p
    diff, dist = bf16_state_mismatches(x[:, keep], x_p[:, keep],
                                       x_pre[:, keep])
    same = diff.logical_not().all(0)
    torch.testing.assert_close(ll[keep][same], ll_p[keep][same], rtol=1e-4,
                               atol=1e-4)
    err = float((ll[keep][same] - ll_p[keep][same]).abs().max())
    print(f"  {label}: ancestors equal{' but ties' if bad.numel() else ''}"
          f" and the float32 kernel's; states bitwise but "
          f"{int(diff.sum())} of {x[:, keep].numel()} one ulp off at a "
          f"boundary (largest distance {dist:.2e}, limit "
          f"{BF16_BOUNDARY_RTOL}); max|ll kernel-plain| {err:.3e}")
    return err, args, kw


def check_bf16_kernels() -> dict:
    """Phase 3 for the bfloat16 state: the fused Metropolis step at
    N = 2^20, d = 2, 16 and 32, MVN and MVT df=5 (``_fused_step_case_bf16``);
    the roll walk and the search-and-apply (both modes) at d = 2 and 32,
    ancestors equal to the float32 run's and values exactly the plain
    version's; take-columns at d = 2 and 32 on sorted and shuffled
    ancestors, bitwise. Records at N = 2^20, d = 2 (take-columns: d = 32,
    shuffled, the generic path's bfloat16 row); the others printed."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_step import fused_filter_step, \
        fused_filter_step_plain, step_path
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_apply_plain, take_columns, take_columns_plain
    from cusmc_tpu_torch.resampling.rolls import roll_metropolis_draws, \
        roll_metropolis_sweeps_expspace, \
        roll_metropolis_sweeps_expspace_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(777)
    n, b = N_BIG, 10
    rec = {}
    ll = -0.5 * torch.randn(n, generator=gen, device=dev) ** 2 * 50.0
    w = torch.exp(ll - ll.max())
    cdf, _ = blocked_cumsum(w)
    u0 = torch.rand((), generator=gen, device=dev)
    pos = (torch.arange(n, device=dev, dtype=torch.float32) + u0) / n \
        * cdf[-1]
    shifts, u = roll_metropolis_draws(gen, n, b, dev)
    cases = {}
    for d in (D, D_WIDE):
        X32 = torch.randn((d, n), generator=gen, device=dev)
        X = X32.to(torch.bfloat16)
        y, a = roll_metropolis_sweeps_expspace(w, shifts, u, X)
        y_p, a_p = roll_metropolis_sweeps_expspace_plain(w, shifts, u, X)
        _, a32 = roll_metropolis_sweeps_expspace(w, shifts, u, X32)
        assert torch.equal(a, a_p) and torch.equal(a, a32), f"rolls d={d}"
        assert y.dtype == torch.bfloat16 and torch.equal(y, y_p)
        y, a = inverse_cdf_apply(cdf, pos, X)
        y_p, a_p = inverse_cdf_apply_plain(cdf, pos, X)
        _, a32 = inverse_cdf_apply(cdf, pos, X32)
        assert torch.equal(a, a_p) and torch.equal(a, a32), f"apply d={d}"
        assert y.dtype == torch.bfloat16 and torch.equal(y, y_p)
        q = pos[n // 4:n // 2].contiguous()
        Xl = X[:, n // 4:n // 2].contiguous()
        y, a = inverse_cdf_apply(cdf, q, Xl, local_base=n // 4)
        y_p, a_p = inverse_cdf_apply_plain(cdf, q, Xl, local_base=n // 4)
        assert torch.equal(a, a_p) and torch.equal(y, y_p), f"local d={d}"
        print(f"  rolls[bf16] and inverse_cdf_apply[bf16] (global; "
              f"local_base L=N/4 at N/4) N=2^20 d={d}: ancestors equal to "
              f"the plain and the float32 runs', values exactly equal")
        cases[d] = X
    # take-columns on a bfloat16 state: the generic path's gather for a
    # registry key outside the fast ops, on sorted and on shuffled
    # ancestors (a custom resampler's come in any order).
    rand = torch.randint(0, n, (n,), generator=gen, device=dev)
    takes = {"sorted": torch.sort(rand).values.to(torch.int32),
             "shuffled": rand.to(torch.int32)}
    for d in (D, D_WIDE):
        for kind, a in takes.items():
            y = take_columns(cases[d], a)
            assert y.dtype == torch.bfloat16 and torch.equal(
                y.view(torch.int16),
                take_columns_plain(cases[d], a).view(torch.int16)), \
                f"take_columns[bf16] {kind} d={d}"
    print("  take_columns[bf16] N=2^20 d=2 and 32, sorted and shuffled "
          "ancestors: values bitwise equal to the plain version's")
    for d in (D, D_WIDE):
        for kind in ("sorted", "shuffled"):  # d = 32 shuffled is recorded
            X, a = cases[d], takes[kind]
            rec["take_columns[bf16]"] = dict(max_abs_err=0.0, **time_kernel(
                "take_columns[bf16]", lambda: take_columns(X, a),
                lambda: take_columns_plain(X, a),
                lambda: X.index_select(1, a),
                f"N=2^20 d={d} bf16 {kind} (library: index_select)",
                (4 + 4 * d) * n, 0))
    steps = {}
    for d in (D, D_MID, D_WIDE):
        for noise in ("mvn", "mvt"):
            err, args, kw = _fused_step_case_bf16(n, d, noise, gen, dev)
            if noise == "mvt":
                steps[d] = (err, args, kw)
    for d in (D_WIDE, D):  # d = 2 last: its numbers are recorded
        X = cases[d]
        rec["roll_metropolis_sweeps_expspace[bf16]"] = dict(
            max_abs_err=0.0, **time_kernel(
                "roll_metropolis_sweeps_expspace[bf16]",
                lambda: roll_metropolis_sweeps_expspace(w, shifts, u, X),
                lambda: roll_metropolis_sweeps_expspace_plain(w, shifts, u,
                                                              X),
                None, f"N=2^20 d={d} B={b} bf16", (8 + 4 * b + 4 * d) * n,
                b * n))
        rec["inverse_cdf_apply[bf16]"] = dict(max_abs_err=0.0, **time_kernel(
            "inverse_cdf_apply[bf16]", lambda: inverse_cdf_apply(cdf, pos, X),
            lambda: inverse_cdf_apply_plain(cdf, pos, X),
            lambda: X.index_select(1, torch.searchsorted(cdf, pos,
                                                         right=True)),
            f"N=2^20 d={d} bf16 (library: searchsorted + index_select)",
            (12 + 4 * d) * n, 0))
    for d in (D_WIDE, D_MID, D):
        err, args, kw = steps[d]
        ops = 2.0 * 4 * d * d * n   # G, Q, F, Li at k = d
        flops, peak = ops, FP32_FLOPS
        if step_path(d, d) == "tile":
            # G, Q and F as one bf16 tensor-core product each, Li as three
            # TF32 ones: in TF32-rate operations.
            flops = 0.75 * ops * TF32_FLOPS / BF16_FLOPS + 0.25 * ops * 3
            peak = TF32_FLOPS
        rec["fused_filter_step[bf16]"] = dict(max_abs_err=err, **time_kernel(
            "fused_filter_step[bf16]", lambda: fused_filter_step(*args, **kw),
            lambda: fused_filter_step_plain(*args, **kw), None,
            f"N=2^20 d={d} MVT df=5 B=10 bf16 tile={kw['tile']} "
            f"path={step_path(d, d)}", (4 * d + 12) * n, flops,
            PLAIN_FUSED_REPS, peak))
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


# -- the "tile" design's statistical oracle -------------------------------
# Both fused kernels run the "tile" design at d = k in {16, 32}, with its own
# Philox layout for the draws. Their plain versions draw the same bits, so
# equality with them cannot catch a layout that correlates draws; these
# checks hold the draws to their law. tests/test_torch_wide_oracle.py runs
# them on the plain versions on the CPU, tests/test_torch_cuda.py and phase
# 3c on the kernels.

ORACLE_SE = 5.0          # standard errors a moment or correlation may stray
ZERO_NOISE_RTOL = 1e-5   # |x - G x_a| <= this |G| |x_a|, entrywise (3xTF32)
# A bfloat16 state: the stored state is G x_a rounded to bfloat16, within
# half an ulp (at most 2^-8 of it: 8 significant bits) of it, on top of the
# float32 tolerance.
ZERO_NOISE_RTOL_BF16 = 2.0 ** -8 + ZERO_NOISE_RTOL
# The MVT noise each step is checked with, as validate_fused_tpu.py checks
# 3 and 5b do at d = 2: (df, df_int).
ORACLE_MVT = {"metropolis": (8.0, None), "cdf": (5.0, 5)}
ORACLE_T = 101           # steps of the log-evidence runs
ORACLE_OBS_SEED = 2024   # their observations: DLM.simulate on the CPU


def oracle_matrices(d):
    """The oracle's dense G (spectral radius 0.9) and dense
    lower-triangular Q with a positive diagonal, float64 numpy, from a
    seed."""
    import numpy as np

    rng = np.random.default_rng(1000 + d)
    G = rng.standard_normal((d, d))
    G *= 0.9 / np.abs(np.linalg.eigvals(G)).max()
    Q = np.tril(rng.standard_normal((d, d))) / math.sqrt(d)
    Q[np.diag_indices(d)] = np.abs(np.diag(Q)) + 0.5
    return G, Q


def oracle_step(kind, X, G, Q, gen, weights=None, noise="mvn"):
    """One fused step of ``X`` [d, m] under ``G`` and ``Q`` (of X's type,
    float32 or, for "metropolis", bfloat16, on X's device) with F = Li =
    I, y = 0: "metropolis" is
    ``fused_filter_step`` (B = 10), "cdf" ``fused_cdf_filter_step``
    (systematic). ``weights`` [m] in exp space (None: flat); MVT noise
    takes ORACLE_MVT[kind]. Returns ``(X_new, ancestors, tile)``, tile
    being the kernel's particle tile (its Philox block)."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_cdf_step import cdf_auto_tile, \
        fused_cdf_filter_step, fused_cdf_filter_step_draws
    from cusmc_tpu_torch.ops.fused_step import auto_tile, \
        fused_filter_step, fused_filter_step_draws

    d, m = X.shape
    dev = X.device
    eye = torch.eye(d, device=dev)
    y = torch.zeros(d, device=dev)
    w = torch.ones(m, device=dev) if weights is None else weights
    df, df_int = ORACLE_MVT[kind] if noise == "mvt" else (None, None)
    if kind == "metropolis":
        tile = auto_tile(m, d, X.element_size())
        draws = fused_filter_step_draws(gen, m, tile, dev)
        x, _, a = fused_filter_step(X, torch.log(w), y, G, Q,
                                    eye.to(X.dtype), eye, df, 0.0, draws,
                                    noise=noise, tile=tile, df_int=df_int)
    else:
        tile = cdf_auto_tile(m, d)
        cdf, _ = blocked_cumsum(w)
        draws = fused_cdf_filter_step_draws(gen, dev)
        x, _, a = fused_cdf_filter_step(cdf, X, y, G, Q, eye, eye, df, 0.0,
                                        draws, noise=noise, tile=tile,
                                        df_int=df_int)
    return x, a, tile


def oracle_zero_noise(kind, d, m, gen, dev, dtype=None) -> float:
    """Check 1: Q = 0 and the dense G. The new state must be G X[:, a] of
    the step's own ancestors; returns the largest entrywise
    |x - G x_a| / (|G| |x_a|), G x_a in float64. ``dtype``: the state's
    and G's type (None: float32)."""
    import torch

    dtype = dtype or torch.float32
    G, _ = oracle_matrices(d)
    G = torch.tensor(G, dtype=torch.float32, device=dev).to(dtype)
    X = torch.randn((d, m), generator=gen, device=dev).to(dtype)
    ll = -2.0 * torch.randn(m, generator=gen, device=dev) ** 2
    x, a, _ = oracle_step(kind, X, G, torch.zeros_like(G), gen,
                          torch.exp(ll - ll.max()))
    xa = X[:, a.long()].double()
    G64 = G.double()
    err = (x.double() - G64 @ xa).abs() / (G64.abs() @ xa.abs())
    return float(err.max())


def oracle_noise(kind, d, m, gen, dev, noise, dtype=None):
    """Checks 2 and 3: X = 0, G = 0 and the dense lower-triangular Q, so a
    step's new state is its noise. Returns ``[(check, standard errors)]``,
    each to stay below ORACLE_SE:

    - each row's mean, and each entry of the second moment E[x x'] against
      c Q Q' (c = 1 for MVN, df / (df - 2) for MVT). MVN: the standard
      error of entry (i, j) is sqrt((S_ii S_jj + S_ij^2) / m); MVT: the
      sample's own, self-normalised (under t5 the product x_i x_j has no
      third moment, so one small chi-square draw can carry an entry past
      5 of the law's analytic standard errors, while it inflates the
      sample's own with it);
    - the whitened noise z = Q^-1 x of particle i against particle i + s,
      s = 1, 32 (a warp's tile) and the kernel's particle tile: the
      direction z / |z| every row against every row (the normals' words),
      and log |z|^2 (the chi-square's words, under MVT); and the same
      against a second call with other seeds. Splitting z so keeps one
      particle's extreme MVT scale out of the d^2 row pairs. A correlation
      is in standard errors as |corr| sqrt(pairs).

    ``dtype``: the state's and Q's type (None: float32); Q is then the
    oracle's matrix rounded to it, and the law is held to that Q."""
    import torch

    dtype = dtype or torch.float32
    _, Q = oracle_matrices(d)
    Q = torch.tensor(Q, dtype=torch.float32, device=dev).to(dtype)
    X0 = torch.zeros((d, m), dtype=dtype, device=dev)
    G0 = torch.zeros((d, d), dtype=dtype, device=dev)
    x, _, tile = oracle_step(kind, X0, G0, Q, gen, noise=noise)
    x2, _, _ = oracle_step(kind, X0, G0, Q, gen, noise=noise)
    xd = x.double()
    Q64 = Q.double()
    df = ORACLE_MVT[kind][0]
    S = (df / (df - 2.0) if noise == "mvt" else 1.0) * (Q64 @ Q64.T)
    mean = xd.mean(1)
    second = xd @ xd.T / m
    if noise == "mvt":
        se_mean = xd.std(1) / math.sqrt(m)
        sq = xd * xd
        se = torch.sqrt((sq @ sq.T / m - second ** 2).clamp_min(0.0) / m)
    else:
        diag = torch.diagonal(S)
        se_mean = torch.sqrt(diag / m)
        se = torch.sqrt((torch.outer(diag, diag) + S ** 2) / m)
    out = [("mean", float((mean.abs() / se_mean).max())),
           ("second moment vs c QQ'", float(((second - S).abs() / se).max()))]

    Qi = torch.linalg.inv(Q64.cpu()).to(dev)

    def split(v):
        """(direction [d, m], log squared norm [m]) of v whitened."""
        z = Qi @ v.double()
        n2 = (z * z).sum(0)
        return z / torch.sqrt(n2), torch.log(n2)

    def corr(a, b):
        """Largest |correlation| of the directions' rows of a with those
        of b (zero mean) and that of their log squared norms, in standard
        errors."""
        (ua, la), (ub, lb) = a, b
        c = (ua @ ub.T) / torch.sqrt(torch.outer((ua * ua).sum(1),
                                                 (ub * ub).sum(1)))
        cl = torch.corrcoef(torch.stack([la, lb]))[0, 1]
        k = math.sqrt(la.shape[0])
        return float(c.abs().max()) * k, float(cl.abs()) * k

    u, ln = split(x)
    for s in (1, 32, tile):
        rows, scale = corr((u[:, :-s], ln[:-s]), (u[:, s:], ln[s:]))
        out += [(f"particle i vs i+{s}, rows", rows),
                (f"particle i vs i+{s}, log|z|^2", scale)]
    rows, scale = corr((u, ln), split(x2))
    out += [("second call, rows", rows), ("second call, log|z|^2", scale)]
    return out


def conditioned_model_params(d):
    """``demo_model_params(d)`` with V = 0.1 I, W = 0.001 I, C0 = 0.001 I:
    a filter that stays alive at d = 32 (the demo model as it is, with
    V = W, collapses there)."""
    import numpy as np

    from cusmc_tpu_torch.io.data import demo_model_params

    p = demo_model_params(d)
    p.update(V=0.1 * np.eye(d), W=0.001 * np.eye(d), C0=0.001 * np.eye(d))
    return p


def conditioned_observations(d, steps=ORACLE_T):
    """The log-evidence runs' observations [steps, d] (float32, CPU; from
    ``DLM.simulate`` on the CPU with seed ORACLE_OBS_SEED, so every device
    filters the same numbers) and their Kalman log-likelihood."""
    import torch

    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc.kalman import kalman_filter

    p = conditioned_model_params(d)
    _, ys = DLM.create(noise="mvn", device="cpu", **p).simulate(
        torch.Generator().manual_seed(ORACLE_OBS_SEED), steps)
    _, _, zk = kalman_filter(ys, **{k: p[k] for k in
                                    ("F", "G", "V", "W", "m0", "C0")})
    return ys, zk


# The paths of the log-evidence runs: (resampler, engine). A bfloat16 state
# runs three of them (the fused CDF step is float32 only).
LOGZ_PATHS = (("systematic", "pallas"), ("systematic", "xla"),
              ("metropolis", "pallas"), ("metropolis", "xla"))
LOGZ_PATHS_BF16 = (("systematic", "xla"), ("metropolis", "pallas"),
                   ("metropolis", "xla"))


def oracle_logz(d, n, seeds, dev, steps=ORACLE_T, state_dtype=None):
    """The log-evidence of the conditioned model, MVN: ``({(resampler,
    engine): [logZ of each seed]}, Kalman logZ)`` for systematic and
    metropolis (B = 10) through both engines (``state_dtype``
    torch.bfloat16: the paths of LOGZ_PATHS_BF16)."""
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    ys, zk = conditioned_observations(d, steps)
    model = DLM.create(noise="mvn", device=dev, state_dtype=state_dtype,
                       **conditioned_model_params(d))
    ys = ys.to(dev)
    out = {}
    for resampler, engine in (LOGZ_PATHS if state_dtype is None
                              else LOGZ_PATHS_BF16):
        out[resampler, engine] = [
            float(bootstrap_filter(s, model, ys, n, resampler=resampler,
                                   engine=engine, return_history=False)
                  .log_evidence) for s in seeds]
    return out, zk


def logz_checks(z, zk, band):
    """Check 4 on ``oracle_logz``'s output: ``[(check, detail, ok)]``.
    ``band = (below, above, floor)`` in nats: each path's mean logZ within
    [zk - below, zk + above]; the fused systematic path's mean, where it
    ran, within 4 sqrt((sd_p^2 + sd_x^2) / R) + floor of the composed
    path's (the same law)."""
    import numpy as np

    below, above, floor = band
    out = []
    for key, vals in z.items():
        mean = float(np.mean(vals))
        out.append((f"{key[0]} {key[1]} vs Kalman",
                    f"mean {mean:.3f} sd {np.std(vals, ddof=1):.3f} over "
                    f"{len(vals)}, Kalman {zk:.3f}, band [{zk - below:.3f}, "
                    f"{zk + above:.3f}]",
                    zk - below <= mean <= zk + above))
    if ("systematic", "pallas") not in z:
        return out
    zp, zx = z["systematic", "pallas"], z["systematic", "xla"]
    gap = abs(float(np.mean(zp)) - float(np.mean(zx)))
    lim = 4.0 * math.sqrt((np.var(zp, ddof=1) + np.var(zx, ddof=1))
                          / len(zp)) + floor
    out.append(("fused vs composed systematic", f"|mean gap| {gap:.3f}, "
                f"limit {lim:.3f} (floor {floor})", gap <= lim))
    return out


# Check 4 on the card: N = 2^20, R = 4 seeds a path, T = ORACLE_T. Its
# bands (below, above, floor) in nats were sized from the plain versions'
# spread on the CPU at N = 2^16 (8 seeds a path, PERF.md section 6), before
# any card run read them: below = the largest bias + 4 sd of the four
# paths there (the filter sits below Kalman by a bias that shrinks with
# N), above = 2 sd (4 sd / sqrt(R)), floor = 1 sd, each sd the largest of
# the four paths', rounded up to 0.1 nat.
ORACLE_BANDS = {D_MID: (10.7, 3.7, 1.9), D_WIDE: (46.1, 12.0, 6.0)}
# The same check on a bfloat16 state (LOGZ_PATHS_BF16), sized the same way
# from oracle_logz(d, 2**16, range(8), "cpu", state_dtype=torch.bfloat16)
# before any card run read them (PERF.md section 6).
ORACLE_BANDS_BF16 = {D_MID: (15.1, 4.6, 2.3), D_WIDE: (47.2, 12.3, 6.2)}
ORACLE_SEEDS = (0, 1, 2, 3)


def check_tile_oracle() -> None:
    """Phase 3c: checks 1-4 of the "tile" design's oracle on both fused
    kernels at d = 16 and 32, each line with the seconds it took; checks
    1-3 also on the fused Metropolis kernel's bfloat16 state, check 1
    within ZERO_NOISE_RTOL_BF16; check 4 also on a bfloat16 state, for its
    three paths, within ORACLE_BANDS_BF16."""
    import torch

    from cusmc_tpu_torch.ops.fused_step import step_path

    t0 = time.perf_counter()

    def check(name, ok, detail):
        nonlocal t0
        torch.cuda.synchronize()
        print(f"  {'PASS' if ok else 'FAIL'}: {name} ({detail}; "
              f"{time.perf_counter() - t0:.2f} s)")
        assert ok, name
        t0 = time.perf_counter()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for d in (D_MID, D_WIDE):
        path = step_path(d, d)
        assert path == "tile", f"d={d} runs the {path} design"
        for kind, name in (("metropolis", "fused_filter_step"),
                           ("cdf", "fused_cdf_filter_step")):
            label = f"{name} d={d} path={path}"
            err = oracle_zero_noise(kind, d, N_BIG, gen, dev)
            check(f"{label}: dense G, Q = 0, x = G x_a",
                  err <= ZERO_NOISE_RTOL,
                  f"max |x - G x_a| / (|G| |x_a|) {err:.3e}, limit "
                  f"{ZERO_NOISE_RTOL}")
            for noise in ("mvn", "mvt"):
                res = oracle_noise(kind, d, N_BIG, gen, dev, noise)
                law = noise if noise == "mvn" else \
                    "mvt df={} df_int={}".format(*ORACLE_MVT[kind])
                check(f"{label} {law}: noise law and independence, m=2^20",
                      max(v for _, v in res) < ORACLE_SE,
                      ", ".join(f"{k} {v:.2f}" for k, v in res)
                      + f"; standard errors, limit {ORACLE_SE}")
        bf = torch.bfloat16
        label = f"fused_filter_step[bf16] d={d} path={path}"
        err = oracle_zero_noise("metropolis", d, N_BIG, gen, dev, bf)
        check(f"{label}: dense G, Q = 0, x = G x_a",
              err <= ZERO_NOISE_RTOL_BF16,
              f"max |x - G x_a| / (|G| |x_a|) {err:.3e}, limit "
              f"{ZERO_NOISE_RTOL_BF16:.3e}")
        for noise in ("mvn", "mvt"):
            res = oracle_noise("metropolis", d, N_BIG, gen, dev, noise, bf)
            law = noise if noise == "mvn" else \
                "mvt df={} df_int={}".format(*ORACLE_MVT["metropolis"])
            check(f"{label} {law}: noise law and independence, m=2^20",
                  max(v for _, v in res) < ORACLE_SE,
                  ", ".join(f"{k} {v:.2f}" for k, v in res)
                  + f"; standard errors, limit {ORACLE_SE}")
        for state_dtype, bands, tag in ((None, ORACLE_BANDS, ""),
                                        (bf, ORACLE_BANDS_BF16, " bf16")):
            z, zk = oracle_logz(d, N_BIG, ORACLE_SEEDS, dev,
                                state_dtype=state_dtype)
            for name, detail, ok in logz_checks(z, zk, bands[d]):
                check(f"d={d} N=2^20 T={ORACLE_T} MVN{tag} log-evidence, "
                      f"{name}", ok, detail)


# -- the main paths -------------------------------------------------------

GATHER_CU = "cusmc_tpu_torch/csrc/monotone_gather.cu"
KERNELS = (
    ("blocked_cumsum", "cusmc_tpu_torch/csrc/cumsum.cu",
     "cusmc_tpu/ops/cumsum.py:45", ("main", "streaming", "models",
                                    "family")),
    ("inverse_cdf_apply", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:277", ("main", "streaming",
                                              "models")),
    ("roll_metropolis_sweeps_expspace", "cusmc_tpu_torch/csrc/rolls.cu",
     "cusmc_tpu/resampling/rolls.py:109", ("main", "streaming", "models",
                                           "family")),
    ("fused_filter_step", "cusmc_tpu_torch/csrc/fused_step.cu",
     "cusmc_tpu/ops/fused_step.py:127", ("pallas", "models")),
    ("fused_cdf_filter_step", "cusmc_tpu_torch/csrc/fused_cdf_step.cu",
     "cusmc_tpu/ops/fused_cdf_step.py:104", ("pallas", "models")),
    ("inverse_cdf_search", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:422", ("sharded", "family")),
    ("take_columns", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:204", ("sharded", "generic",
                                              "family")),
    ("inverse_cdf_apply[local_base]", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:401", ("sharded", "streaming",
                                              "family")),
    ("fused_filter_step[bf16]", "cusmc_tpu_torch/csrc/fused_step.cu",
     "cusmc_tpu/ops/fused_step.py:127", "bf16"),
    ("roll_metropolis_sweeps_expspace[bf16]", "cusmc_tpu_torch/csrc/rolls.cu",
     "cusmc_tpu/resampling/rolls.py:109", ("bf16", "family")),
    ("inverse_cdf_apply[bf16]", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:277", "bf16"),
    ("take_columns[bf16]", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:204", ("generic", "family")),
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
                                              "local_launches"),
            "fused_filter_step[bf16]": (fused_filter_step, "bf16_launches"),
            "roll_metropolis_sweeps_expspace[bf16]":
                (roll_metropolis_sweeps_expspace, "bf16_launches"),
            "inverse_cdf_apply[bf16]": (inverse_cdf_apply, "bf16_launches"),
            "inverse_cdf_apply[bf16 local_base]": (inverse_cdf_apply,
                                                   "bf16_local_launches"),
            "take_columns[bf16]": (take_columns, "bf16_launches")}


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
    from cusmc_tpu_torch.smc import particle_filter
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
        # Warm-up; the systematic run keeps the search-and-apply's inputs.
        with capture(particle_filter, "inverse_cdf_apply", (
                "composed systematic run, d=2 headline",)) \
                if resampler == "systematic" else contextlib.nullcontext():
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
    from cusmc_tpu_torch.smc import particle_filter
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

            # Warm-up; the systematic runs keep the fused CDF step's inputs
            # and, at d = 32, the search-and-apply's (the d = 2 composed run
            # kept them in phase 4).
            with capture(particle_filter, "fused_cdf_filter_step",
                         (f"fused CDF step, d={d} systematic pallas run",)):
                one("pallas", 0)
            with capture(particle_filter, "inverse_cdf_apply", (
                    f"composed systematic run, d={d} (engine xla)",)) \
                    if d == D_WIDE else contextlib.nullcontext():
                one("xla", 0)
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
                busy, _ = device_busy(lambda: bootstrap_filter(
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


# The rows of phase 4d, by width: (resampler, engine), and their steps (the
# headline's T = 200 at d = 2; the wider rows are device-bound, and 100
# steps read their rate as well). Their busy share and kernels a step come
# from a profiled run of the first BF16_PROFILE_STEPS steps: tracing the
# host costs seconds a run and grows with its steps.
BF16_STEPS = {D: 200, D_MID: 100, D_WIDE: 100}
BF16_PROFILE_STEPS = 50
BF16_ROWS = {
    D: (("metropolis", "xla"), ("systematic", "xla"),
        ("metropolis", "pallas")),
    D_MID: (("metropolis", "pallas"), ("metropolis", "xla"),
            ("systematic", "xla")),
    D_WIDE: (("metropolis", "pallas"), ("metropolis", "xla"),
             ("systematic", "xla")),
}
# The kernels a bfloat16 run launches T-1 times, by (resampler, engine).
BF16_USED = {
    ("metropolis", "pallas"): ("fused_filter_step[bf16]",),
    ("metropolis", "xla"): ("roll_metropolis_sweeps_expspace[bf16]",),
    ("systematic", "xla"): ("blocked_cumsum", "inverse_cdf_apply[bf16]"),
}


def bf16_path(card: str) -> None:
    """Phase 4d: mixed precision (a bfloat16 state) through
    bootstrap_filter, each bfloat16 run beside the float32 run of the same
    row in turns (bf16, f32, f32, bf16 after one warm-up each): MVT df=5,
    N=2^20, T of BF16_STEPS, the rows of BF16_ROWS; particle-steps/s and
    ESS/s of the best of 2, then the busy share and the device kernels a
    step from one profiled run of BF16_PROFILE_STEPS steps. A bfloat16 run
    launches the kernels of
    BF16_USED T-1 times each and no other kernel of the port."""
    import torch

    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    n = N_BIG
    for d in (D, D_MID, D_WIDE):
        steps = BF16_STEPS[d]
        models = {dt: DLM.create(noise="mvt", df=5.0, device="cuda",
                                 state_dtype=sdt, **demo_model_params(d))
                  for dt, sdt in (("f32", None), ("bf16", torch.bfloat16))}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        _, ys_h = models["f32"].simulate(gen, steps)
        for resampler, engine in BF16_ROWS[d]:
            kwargs = {"num_steps": 10} if resampler == "metropolis" else None
            used = BF16_USED[resampler, engine]

            def run(dt, seed, ys=ys_h):
                return bootstrap_filter(seed, models[dt], ys, n,
                                        resampler=resampler,
                                        resampler_kwargs=kwargs,
                                        engine=engine, return_history=False)

            def one(dt, seed):
                before = _counts()
                t0 = time.perf_counter()
                res = run(dt, seed)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                after = _counts()
                if dt == "bf16":
                    for name in after:
                        grown = after[name] - before[name]
                        want = steps - 1 if name in used else 0
                        assert grown == want, f"bf16 {resampler} {engine} " \
                            f"d={d}: {name} launched {grown} times"
                    assert res.final_particles.dtype == torch.bfloat16
                    assert res.final_log_weights.dtype == torch.float32
                assert bool(torch.isfinite(res.final_particles).all())
                assert math.isfinite(float(res.log_evidence))
                return secs, res

            one("bf16", 0)
            one("f32", 0)
            best = {"bf16": math.inf, "f32": math.inf}
            last = {}
            for rep, dt in enumerate(("bf16", "f32", "f32", "bf16")):
                secs, last[dt] = one(dt, rep + 1)
                best[dt] = min(best[dt], secs)
            for dt in ("bf16", "f32"):
                res = last[dt]
                rate = n * (steps - 1) / best[dt]
                ess_rate = float(res.ess.double().sum()) / best[dt]
                busy, kernels = device_busy(
                    lambda: run(dt, 7, ys_h[:BF16_PROFILE_STEPS]))
                per_step = kernels / (BF16_PROFILE_STEPS - 1)
                print(f"  {dt} MVT df=5 {resampler} engine={engine} N=2^20 "
                      f"T={steps} d={d}: {rate:.6g} particle-steps/s, "
                      f"{ess_rate:.6g} ESS/s, best {best[dt]:.4f} s of 2, "
                      f"logZ {float(res.log_evidence):.3f}, device busy "
                      f"{busy:.3f}, {per_step:.1f} kernels a step "
                      f"(torch.profiler) [{card}]")
            print(f"  bf16 / f32 rate, {resampler} {engine} d={d}: "
                  f"{best['f32'] / best['bf16']:.3f}; launches of a bf16 "
                  f"run: {', '.join(used)} {steps - 1} each, no other")


# The generic path's rows (phase 4e): label -> (bootstrap_filter keywords,
# {kernel: launches a step}; every other kernel of the port launches 0).
GENERIC_KEY = "metropolis_indexed"  # resampling.metropolis under a new key
GENERIC_ROWS = {
    "debug_checks metropolis": (
        dict(resampler="metropolis", resampler_kwargs={"num_steps": 10},
             debug_checks=True), {"roll_metropolis_sweeps_expspace": 1}),
    "debug_checks systematic": (
        dict(resampler="systematic", debug_checks=True),
        {"blocked_cumsum": 1, "inverse_cdf_apply": 1}),
    "debug_checks residual": (
        dict(resampler="residual", debug_checks=True),
        {"blocked_cumsum": 3, "inverse_cdf_apply": 2}),
    "custom key": (
        dict(resampler=GENERIC_KEY, resampler_kwargs={"num_steps": 10}),
        {"take_columns": 1}),
    "batch systematic": (dict(layout="batch", resampler="systematic"), {}),
    "CustomSSM systematic": (dict(resampler="systematic"), {}),
}
GENERIC_PROFILE_STEPS = 20


def custom_ssm(dlm):
    """A DLM as a ``CustomSSM``: its batch methods only."""
    from cusmc_tpu_torch.models.base import CustomSSM

    return CustomSSM.create(
        dlm.state_dim,
        lambda m, gen, shape: m["dlm"].sample_initial(gen, shape),
        lambda m, gen, x: m["dlm"].propagate(gen, x),
        lambda m, y, x: m["dlm"].observation_logpdf(y, x),
        params={"dlm": dlm})


def generic_path(card: str) -> None:
    """Phase 4e: the generic log-space step through bootstrap_filter, at
    the headline (MVT df=5, N=2^20, T=200, d=2, B=10): the rows of
    GENERIC_ROWS, and the bfloat16 model with the custom key at d=32
    (T=100); each one warm-up and the best of 2, particle-steps/s, and
    kernels a step and the busy share from a profiled run of
    GENERIC_PROFILE_STEPS steps; every run launches each of its kernels
    exactly as GENERIC_ROWS says. Then the share of ancestors equal
    between the fast and the generic metropolis runs on one seed, and the
    Kalman logZ (MVN, N=2^17, the bundled trace, 2%) of the generic
    metropolis, systematic and residual runs, the custom key, the batch
    layout and the CustomSSM."""
    import numpy as np
    import torch

    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.resampling import register_resampler
    from cusmc_tpu_torch.resampling.metropolis import metropolis_ancestors
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    register_resampler(GENERIC_KEY, metropolis_ancestors)
    n = N_BIG
    p = demo_model_params()
    dlm = DLM.create(noise="mvt", df=5.0, device="cuda", **p)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _, ys_h = dlm.simulate(gen, 200)
    bf16 = DLM.create(noise="mvt", df=5.0, device="cuda",
                      state_dtype=torch.bfloat16, **demo_model_params(D_WIDE))
    gen.manual_seed(0)
    _, ys_bf16 = bf16.simulate(gen, 100)
    rows = {label: (custom_ssm(dlm) if label.startswith("CustomSSM")
                    else dlm, ys_h, kw, used)
            for label, (kw, used) in GENERIC_ROWS.items()}
    rows["bf16 d=32 custom key"] = (
        bf16, ys_bf16, GENERIC_ROWS["custom key"][0],
        {"take_columns[bf16]": 1})
    for label, (model, ys, kw, used) in rows.items():
        steps = ys.shape[0]

        def run(seed, ys=ys, model=model, kw=kw):
            return bootstrap_filter(seed, model, ys, n, return_history=False,
                                    device="cuda", **kw)

        def one(seed, label=label, used=used, steps=steps):
            before = _counts()
            t0 = time.perf_counter()
            res = run(seed)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = _counts()
            for name in after:
                grown = after[name] - before[name]
                want = used.get(name, 0) * (steps - 1)
                assert grown == want, f"generic {label}: {name} launched " \
                    f"{grown} times, expected {want}"
            assert bool(torch.isfinite(res.final_particles.float()).all())
            assert math.isfinite(float(res.log_evidence))
            return secs, res

        one(0)
        best = math.inf
        for rep in range(2):
            secs, res = one(rep + 1)
            best = min(best, secs)
        busy, kernels = device_busy(
            lambda: run(7, ys[:GENERIC_PROFILE_STEPS]))
        print(f"  generic {label} MVT df=5 N=2^20 T={steps} "
              f"d={model.state_dim}: {n * (steps - 1) / best:.6g} "
              f"particle-steps/s, best {best:.4f} s of 2, logZ "
              f"{float(res.log_evidence):.3f}, device busy {busy:.3f}, "
              f"{kernels / (GENERIC_PROFILE_STEPS - 1):.1f} kernels a step "
              f"(torch.profiler); launches a step: "
              f"{', '.join(f'{k} {v}' for k, v in used.items()) or 'none'}"
              f" [{card}]")

    # The fast and the generic metropolis steps draw the same numbers; the
    # generic walk runs on exp(logw - max(logw)), which the fast carry
    # meets only to rounding, so a tie may split them (and the runs then
    # part).
    kw = dict(resampler="metropolis", resampler_kwargs={"num_steps": 10})
    fast = bootstrap_filter(3, dlm, ys_h, n, **kw)
    slow = bootstrap_filter(3, dlm, ys_h, n, debug_checks=True, **kw)
    same = (fast.ancestors[1:] == slow.ancestors[1:]).float().mean(dim=1)
    split = torch.nonzero(same < 1.0)
    first = int(split[0]) + 1 if split.numel() else None
    print(f"  fast / generic metropolis, N=2^20 T=200 seed 3: ancestors "
          f"equal in {float(same.mean()):.6f} of slots over all steps, "
          f"{float(same[0]):.6f} at step 1; first step with a split: "
          f"{first}")
    del fast, slow

    ys = load_y_sim()
    T = ys.shape[0]
    _, _, loglik = kalman_filter(ys, **{k: p[k] for k in
                                        ("F", "G", "V", "W", "m0", "C0")})
    mvn = DLM.create(noise="mvn", device="cuda", **p)
    for label, model, kw in (
            ("debug_checks metropolis", mvn,
             GENERIC_ROWS["debug_checks metropolis"][0]),
            ("debug_checks systematic", mvn,
             GENERIC_ROWS["debug_checks systematic"][0]),
            ("debug_checks residual", mvn,
             GENERIC_ROWS["debug_checks residual"][0]),
            ("custom key", mvn, GENERIC_ROWS["custom key"][0]),
            ("batch systematic", mvn, GENERIC_ROWS["batch systematic"][0]),
            ("CustomSSM systematic", custom_ssm(mvn),
             dict(resampler="systematic"))):
        res = bootstrap_filter(1, model, ys, 1 << 17, return_history=False,
                               device="cuda", **kw)
        lz = float(res.log_evidence)
        gap = abs(lz - loglik)
        print(f"  kalman MVN generic {label} N=2^17 T={T}: logZ {lz:.3f} vs "
              f"Kalman {loglik:.3f} (|gap| {gap:.3f}, limit "
              f"{0.02 * abs(loglik):.3f})")
        assert np.isfinite(lz) and gap < 0.02 * abs(loglik), \
            f"generic {label}: logZ off"


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
    from cusmc_tpu_torch.parallel import resampling as sharded_resampling
    from cusmc_tpu_torch.smc import particle_filter
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
                      ("blocked_cumsum", 3)),
                     ("inverse_cdf_apply", "inverse_cdf_apply[local_base]")),
        "metropolis": ((("roll_metropolis_sweeps_expspace", 1),),
                       CDF_KERNELS + SHARD_KERNELS),
        "single residual": ((("inverse_cdf_apply", 2),
                             ("blocked_cumsum", 3)), SHARD_KERNELS)}

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
            # Warm-ups keep the inputs of the search-only kernel (sharded
            # residual: two calls a step) and of the search-and-apply
            # (single-device residual: two calls a step; sharded
            # systematic: the local-block mode).
            keep = {"residual": (sharded_resampling, "inverse_cdf_search", (
                        "sharded residual run: floor-count cdf",
                        "sharded residual run: remainder cdf")),
                    "single residual": (particle_filter, "inverse_cdf_apply", (
                        "single-device residual run: residual floor-count",
                        "single-device residual run: residual remainder")),
                    "systematic": (sharded_resampling, "inverse_cdf_apply", (
                        "sharded systematic run: local-block mode",))}
            for label in expect:
                with capture(*keep[label]) if label in keep \
                        else contextlib.nullcontext():
                    one(label, 0, mvt, ys_h, n)
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
                busy, _ = device_busy(lambda: one(label, 7, mvt, ys_h, n))
                rate = n * (steps - 1) / best
                ess_rate = float(res.ess.double().sum()) / best
                print(f"  headline MVT df=5 {label} N=2^20 T={steps} d=2: "
                      f"{rate:.6g} particle-steps/s, {ess_rate:.6g} ESS/s, "
                      f"best {best:.4f} s of 3, logZ "
                      f"{float(res.log_evidence):.3f}, device busy "
                      f"{busy:.3f}; launches {counts} [{card}]")

            # A model without packed methods: the batch layout and the
            # all-gather op, whose systematic ancestors take the cumsum
            # and the search-only kernel once a step.
            custom = custom_ssm(mvt)
            steps = 50
            best = math.inf
            for rep in range(3):  # one warm-up, the best of 2
                before = _counts()
                t0 = time.perf_counter()
                res = sharded_bootstrap_filter(rep, custom, ys_h[:steps], n,
                                               axis, resampler="systematic",
                                               device="cuda")
                torch.cuda.synchronize()
                if rep:
                    best = min(best, time.perf_counter() - t0)
                after = _counts()
                for name in after:
                    grown = after[name] - before[name]
                    want = steps - 1 if name in (
                        "blocked_cumsum", "inverse_cdf_search") else 0
                    assert grown == want, f"sharded CustomSSM: {name} " \
                        f"launched {grown} times, expected {want}"
            assert bool(torch.isfinite(res.final_particles).all())
            assert math.isfinite(float(res.log_evidence))
            print(f"  CustomSSM (batch layout, all-gather op) systematic "
                  f"MVT df=5 N=2^20 T={steps} d=2: "
                  f"{n * (steps - 1) / best:.6g} particle-steps/s, best "
                  f"{best:.4f} s of 2, logZ {float(res.log_evidence):.3f}; "
                  f"launches blocked_cumsum and inverse_cdf_search "
                  f"{steps - 1} each [{card}]")
        finally:
            dist.destroy_process_group()


# -- the headless runner and the streaming filter -------------------------

STREAM_CHUNK = 64        # steps a chunk, the streaming filter's default
STREAM_SPILL_STEPS = 50  # the disk spill's run: 50 x 8.39 MB to a file
STREAM_WIDE_STEPS = 100  # the full-width rows, d = 32
HALT_STEPS, HALT_CHUNK, HALT_NAN = 81, 20, 50  # halt and resume


def build_native() -> None:
    """Build the host runtime (``native/``, ``make -C native``) when the
    checkout has no build of it: a ``git archive`` has no build directory.
    Phase 4f fails if the streaming filter's native store did not load."""
    from cusmc_tpu_torch.io import native

    if native.lib_path() is None:
        t0 = time.perf_counter()
        root = os.path.dirname(os.path.abspath(__file__))
        out = subprocess.run(["make", "-C", os.path.join(root, "native")],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, f"make -C native failed:\n{out.stdout}" \
            f"\n{out.stderr}"
        print(f"native: built in {time.perf_counter() - t0:.1f} s")
    assert native.get_lib() is not None, "native library did not load"
    print(f"native: {native.lib_path()}")


def _best_of(fns, reps=2) -> dict:
    """label -> best wall seconds (ending in a synchronize) of each
    function, one warm-up round first, the functions in turns."""
    import torch

    best = {k: math.inf for k in fns}
    for rep in range(reps + 1):
        for label, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if rep:
                best[label] = min(best[label], time.perf_counter() - t0)
            del out
    return best


def _same_result(label, a, b) -> None:
    """Final particles, log weights, log-evidence and ESS bitwise."""
    import torch

    for field in ("final_particles", "final_log_weights", "log_evidence",
                  "ess"):
        x, y = getattr(a, field), getattr(b, field)
        assert torch.equal(x, y), f"{label}: {field} differs"


def _cli(args, env):
    return subprocess.Popen([sys.executable, "-m", "cusmc_tpu_torch"] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _cli_line(proc, label, timeout=300) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"{label}: exit {proc.returncode}\n{err}"
    lines = out.strip().splitlines()
    assert len(lines) == 1, f"{label}: stdout is not one line: {out!r}"
    return json.loads(lines[0])


def streaming_path(card: str) -> None:
    """Phase 4f: the streaming filter and the headless runner."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from cusmc_tpu_torch.checkpoint import FilterCheckpoint
    from cusmc_tpu_torch.io.data import Y_SIM_PATH, demo_model_params, \
        load_y_sim
    from cusmc_tpu_torch.io.disk_store import DiskTrajectoryStore
    from cusmc_tpu_torch.io.native_store import TrajectoryStore
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.parallel import ParticleAxis, \
        initialize_distributed, sharded_bootstrap_filter
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter
    from cusmc_tpu_torch.smc.streaming import streaming_bootstrap_filter
    from cusmc_tpu_torch.utils.debug import FilterDivergedError

    p = demo_model_params()
    n, steps = N_BIG, 200
    mvt = DLM.create(noise="mvt", df=5.0, device="cuda", **p)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _, ys_h = mvt.simulate(gen, steps)
    rows = {"metropolis": ({"num_steps": 10}, ROLL_KERNELS),
            "systematic": (None, CDF_KERNELS)}
    step_mb = n * D * 4 / 1e6

    # The chunk's copy to the host and the host store's append, on a
    # chunk of the headline's history.
    block = torch.randn((STREAM_CHUNK, n, D), device="cuda")
    nbytes = block.numel() * 4
    host = block.cpu()
    copy_s = min(_timed(lambda: block.cpu()) for _ in range(3))
    append = {}
    for kind, force in (("native", False), ("numpy", True)):
        secs = []
        for _ in range(3):
            st = TrajectoryStore((n, D), STREAM_CHUNK, np.float32,
                                 force_numpy=force)
            assert st.native == (not force), f"{kind} store"
            secs.append(_timed(lambda: st.append(host.numpy())))
            del st
        append[kind] = min(secs)
    del block, host
    print(f"  chunk copy to the host ({STREAM_CHUNK} x {step_mb:.2f} MB, "
          f"pageable): {nbytes / copy_s / 1e9:.3f} GB/s; host append: "
          f"native {nbytes / append['native'] / 1e9:.3f} GB/s, numpy "
          f"{nbytes / append['numpy'] / 1e9:.3f} GB/s [{card}]")

    # The headline: streamed history bitwise the one-shot history; the
    # four rates; each streaming run launches its kernels T-1 times.
    for resampler, (kwargs, used) in rows.items():
        kw = dict(resampler=resampler, resampler_kwargs=kwargs)
        one = bootstrap_filter(0, mvt, ys_h, n, return_history=True, **kw)
        before = _counts()
        st, store = streaming_bootstrap_filter(0, mvt, ys_h, n,
                                               chunk_steps=STREAM_CHUNK, **kw)
        torch.cuda.synchronize()
        _expect_launches(before, _counts(), used, steps - 1,
                         f"streaming {resampler} with store", FUSED_KERNELS)
        assert store.native, "the streaming store is not the native arena"
        _same_result(f"streaming {resampler}", st, one)
        assert store.size == steps and store.start_step == 0
        assert np.array_equal(store.view(), one.particles.cpu().numpy()), \
            f"streaming {resampler}: stored history differs"
        del one, st, store
        torch.cuda.empty_cache()
        best = _best_of({
            "one-shot, no history": lambda: bootstrap_filter(
                1, mvt, ys_h, n, return_history=False, **kw),
            "one-shot, device history": lambda: bootstrap_filter(
                1, mvt, ys_h, n, return_history=True, **kw),
            "streaming, no store": lambda: streaming_bootstrap_filter(
                1, mvt, ys_h, n, chunk_steps=STREAM_CHUNK,
                store_particles=False, **kw),
            "streaming, native store": lambda: streaming_bootstrap_filter(
                1, mvt, ys_h, n, chunk_steps=STREAM_CHUNK, **kw)})
        print(f"  headline MVT df=5 {resampler} N=2^20 T={steps} d=2, chunk "
              f"{STREAM_CHUNK}: history bitwise the one-shot run's; " +
              "; ".join(f"{k} {n * (steps - 1) / v:.6g} particle-steps/s "
                        f"({v * 1e3 / (steps - 1):.4f} ms a step)"
                        for k, v in best.items()) +
              f"; one warm-up, best of 2, in turns [{card}]")

    with tempfile.TemporaryDirectory() as tmp:
        # Disk spill: the history written by the background thread equals
        # the arena's.
        ys_s = ys_h[:STREAM_SPILL_STEPS]
        spill = os.path.join(tmp, "hist.bin")
        t0 = time.perf_counter()
        res_d, disk = streaming_bootstrap_filter(
            2, mvt, ys_s, n, chunk_steps=STREAM_CHUNK, resampler="systematic",
            spill_path=spill)
        assert disk.native, "the disk store is not the native writer"
        disk.finish()
        secs = time.perf_counter() - t0
        res_a, arena = streaming_bootstrap_filter(
            2, mvt, ys_s, n, chunk_steps=STREAM_CHUNK, resampler="systematic")
        _same_result("disk spill", res_d, res_a)
        reopened = DiskTrajectoryStore.open(spill)
        assert np.array_equal(reopened, arena.view()), "spilled history"
        print(f"  disk spill, systematic T={STREAM_SPILL_STEPS}: "
              f"{os.path.getsize(spill) / 1e6:.1f} MB, run and finish "
              f"{secs:.2f} s, reopened history bitwise the arena's "
              f"[{card}]")
        del reopened, arena, disk

        # Full width, d = 32, no store: bitwise the one-shot run.
        wide = DLM.create(noise="mvt", df=5.0, device="cuda",
                          **demo_model_params(D_WIDE))
        gen.manual_seed(0)
        _, ys_w = wide.simulate(gen, STREAM_WIDE_STEPS)
        for resampler, (kwargs, used) in rows.items():
            kw = dict(resampler=resampler, resampler_kwargs=kwargs)
            one = bootstrap_filter(3, wide, ys_w, n, return_history=False,
                                   **kw)
            before = _counts()
            st, store = streaming_bootstrap_filter(
                3, wide, ys_w, n, chunk_steps=STREAM_CHUNK,
                store_particles=False, **kw)
            torch.cuda.synchronize()
            assert store is None
            _expect_launches(before, _counts(), used, STREAM_WIDE_STEPS - 1,
                             f"streaming d={D_WIDE} {resampler}",
                             FUSED_KERNELS)
            _same_result(f"streaming d={D_WIDE} {resampler}", st, one)
            print(f"  full width d={D_WIDE} {resampler} N=2^20 "
                  f"T={STREAM_WIDE_STEPS}: bitwise the one-shot run, logZ "
                  f"{float(st.log_evidence):.3f} [{card}]")

        # Halt and resume: MVN, N=2^17, the bundled trace cut to 81 steps.
        mvn = DLM.create(noise="mvn", device="cuda", **p)
        ys = load_y_sim()
        clean = ys[:HALT_STEPS]
        bad = np.array(clean, np.float32)
        bad[HALT_NAN, 0] = np.nan
        ckpt = FilterCheckpoint(os.path.join(tmp, "snap"))
        kw = dict(chunk_steps=HALT_CHUNK, resampler="systematic",
                  store_particles=False)
        try:
            streaming_bootstrap_filter(4, mvn, bad, 1 << 17, checkpoint=ckpt,
                                       **kw)
            raise AssertionError("the NaN did not halt the filter")
        except FilterDivergedError as e:
            assert e.last_good_step == HALT_NAN - HALT_NAN % HALT_CHUNK, e
            assert e.snapshot.endswith(f"step_{e.last_good_step}.npz"), e
            halted = e
        resumed, _ = streaming_bootstrap_filter(4, mvn, clean, 1 << 17,
                                                checkpoint=ckpt, resume=True,
                                                **kw)
        full, _ = streaming_bootstrap_filter(4, mvn, clean, 1 << 17, **kw)
        for field in ("final_particles", "final_log_weights",
                      "log_evidence"):
            assert torch.equal(getattr(resumed, field),
                               getattr(full, field)), f"resume: {field}"
        _, _, loglik = kalman_filter(ys, **{k: p[k] for k in
                                            ("F", "G", "V", "W", "m0",
                                             "C0")})
        before = _counts()
        long, _ = streaming_bootstrap_filter(
            5, mvn, ys, 1 << 17, chunk_steps=STREAM_CHUNK,
            resampler="systematic", store_particles=False)
        _expect_launches(before, _counts(), CDF_KERNELS, ys.shape[0] - 1,
                         "streaming kalman", FUSED_KERNELS)
        gap = abs(float(long.log_evidence) - loglik)
        assert gap < 0.02 * abs(loglik), "streaming logZ off"
        print(f"  halt at NaN step {HALT_NAN}: last good step "
              f"{halted.last_good_step}, snapshot "
              f"{os.path.basename(halted.snapshot)}; resume bitwise the "
              f"uninterrupted run; kalman MVN systematic N=2^17 "
              f"T={ys.shape[0]} streamed: logZ "
              f"{float(long.log_evidence):.3f} vs Kalman {loglik:.3f} "
              f"(|gap| {gap:.3f}, limit {0.02 * abs(loglik):.3f}) [{card}]")

        # Sharded streaming on a one-rank NCCL group: the sharded one-shot
        # run, bitwise.
        initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            axis = ParticleAxis()
            one = sharded_bootstrap_filter(0, mvt, ys_h, n, axis,
                                           resampler="systematic")
            before = _counts()
            st, _ = streaming_bootstrap_filter(
                0, mvt, ys_h, n, chunk_steps=STREAM_CHUNK,
                resampler="systematic", store_particles=False, axis=axis)
            torch.cuda.synchronize()
            _expect_launches(before, _counts(),
                             ("inverse_cdf_apply[local_base]",
                              "blocked_cumsum"), steps - 1,
                             "sharded streaming systematic", FUSED_KERNELS)
            _same_result("sharded streaming", st, one)
            best = _best_of({
                "sharded one-shot": lambda: sharded_bootstrap_filter(
                    1, mvt, ys_h, n, axis, resampler="systematic"),
                "sharded streaming": lambda: streaming_bootstrap_filter(
                    1, mvt, ys_h, n, chunk_steps=STREAM_CHUNK,
                    resampler="systematic", store_particles=False,
                    axis=axis)})
            print(f"  sharded streaming systematic (one-rank NCCL group) "
                  f"N=2^20 T={steps}: bitwise the sharded one-shot run; " +
                  "; ".join(f"{k} {n * (steps - 1) / v:.6g} "
                            "particle-steps/s" for k, v in best.items()) +
                  f" [{card}]")
        finally:
            dist.destroy_process_group()

        # The runner, as subprocesses on the card.
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        cfg = os.path.join(tmp, "cfg.json")
        with open(cfg, "w") as f:
            json.dump({"num_particles": 1 << 17,
                       "model": {k: np.asarray(v).tolist()
                                 for k, v in p.items()},
                       "distribution": "mvn", "resampler": "systematic",
                       "seed": 1}, f)
        run = ["run", "--config", cfg, "--data", str(Y_SIM_PATH)]
        ck = os.path.join(tmp, "cli_ck")
        out_dir = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        procs = {"demo": _cli(["demo"], env),
                 "run": _cli(run + ["--output-dir", out_dir], env),
                 "stream": _cli(run + ["--stream", str(STREAM_CHUNK),
                                       "--checkpoint", ck], env)}
        lines = {k: _cli_line(v, k) for k, v in procs.items()}
        lines["resume"] = _cli_line(_cli(
            run + ["--stream", str(STREAM_CHUNK), "--checkpoint", ck,
                   "--resume"], env), "resume")
        cli_s = time.perf_counter() - t0
        assert math.isfinite(lines["demo"]["log_evidence"])
        assert sorted(os.listdir(out_dir)) == ["x_t_N0.csv", "y_t.csv"]
        for k in ("run", "stream", "resume"):
            gap = abs(lines[k]["log_evidence"] - loglik)
            assert gap < 0.02 * abs(loglik), f"cli {k}: logZ off"
        assert lines["resume"]["log_evidence"] == \
            lines["stream"]["log_evidence"] == lines["run"]["log_evidence"]
        print(f"  cli (subprocesses, {cli_s:.1f} s): demo logZ "
              f"{lines['demo']['log_evidence']:.3f}, "
              f"{lines['demo']['particle_steps_per_sec']:.6g} "
              f"particle-steps/s; run / --stream {STREAM_CHUNK} / --resume "
              f"MVN N=2^17 T={ys.shape[0]}: logZ "
              f"{lines['run']['log_evidence']:.3f} (Kalman {loglik:.3f}), "
              f"equal in all three; --output-dir wrote y_t.csv, x_t_N0.csv "
              f"[{card}]")


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# -- the other models and the auxiliary family (phase 4g) -----------------

AUX_T = 200              # steps of every phase-4g row but UNGM's
UNGM_T = 100
# |logZ(bootstrap) - logZ(APF)| on the stochastic volatility trace, in nats:
# sized on the CPU at N = 2^14, where the spread is wider than here
# (tests/test_torch_models.py::test_sv_band_holds_on_the_cpu holds it).
SV_APF_BAND = 0.5
# Kalman bands of the structural rows (phase 4b's: the windowed fused
# Metropolis step's finite-B bias, benchmarks/validate_fused_tpu.py).
STRUCT_BANDS = {("xla", "metropolis"): 0.02, ("xla", "systematic"): 0.02,
                ("pallas", "metropolis"): 0.08,
                ("pallas", "systematic"): 0.02}
# Kernels a step of each composed and fused run, and the widths their
# wrappers must see: (X rows,) or, for the fused kernels, (X rows, F rows).
MODEL_RUNS = {
    ("xla", "metropolis"): {"roll_metropolis_sweeps_expspace": 1},
    ("xla", "systematic"): {"blocked_cumsum": 1, "inverse_cdf_apply": 1},
    ("pallas", "metropolis"): {"fused_filter_step": 1},
    ("pallas", "systematic"): {"fused_cdf_filter_step": 1,
                               "blocked_cumsum": 1}}


def _wrapper_width(name, args):
    if name == "roll_metropolis_sweeps_expspace":
        return (args[3].shape[0],)
    if name == "inverse_cdf_apply":
        return (args[2].shape[0],)
    if name == "fused_filter_step":
        return (args[0].shape[0], args[5].shape[0])
    if name == "fused_cdf_filter_step":
        return (args[1].shape[0], args[5].shape[0])
    return ()


@contextlib.contextmanager
def widths_seen():
    """While open, the kernel wrappers that the filter calls (through the
    names ``smc/particle_filter.py`` imported) record the widths of the
    state they are given: {name: {width, ...}}."""
    from cusmc_tpu_torch.smc import particle_filter

    seen = {}
    names = ("roll_metropolis_sweeps_expspace", "inverse_cdf_apply",
             "fused_filter_step", "fused_cdf_filter_step")
    originals = {name: getattr(particle_filter, name) for name in names}

    def recorder(name, fn):
        def call(*args, **kwargs):
            seen.setdefault(name, set()).add(_wrapper_width(name, args))
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(particle_filter, name, recorder(name, fn))
    try:
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(particle_filter, name, fn)


def _counted_best(label, run, used, steps, width=None, reps=2):
    """One warm-up and the best of ``reps`` runs of ``run(seed)``, each
    launching exactly ``used[kernel]`` launches a step for T-1 steps and no
    other kernel, at the state width ``width`` (None: no kernel). Returns
    (best seconds, last result)."""
    import torch

    best, res = math.inf, None
    for rep in range(reps + 1):
        before = _counts()
        with widths_seen() as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(rep)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        after = _counts()
        for name in after:
            grown = after[name] - before[name]
            want = used.get(name, 0) * (steps - 1)
            assert grown == want, f"{label}: {name} launched {grown} " \
                f"times, expected {want}"
        if width is not None:
            for name, widths in seen.items():
                assert widths == {width}, \
                    f"{label}: {name} saw widths {widths}, not {width}"
        if rep:
            best = min(best, secs)
    return best, res


def grid_filter(q, r, x0_std, ys, lo=-30.0, hi=30.0, ng=1201):
    """The exact UNGM filter on a dense grid (tests/test_ungm.py:16):
    posterior means [T]."""
    import numpy as np

    xs = np.linspace(lo, hi, ng)
    p = np.exp(-0.5 * xs * xs / x0_std ** 2)
    p /= p.sum()
    means = [float((p * xs).sum())]
    for t in range(1, ys.shape[0]):
        f = 0.5 * xs + 25.0 * xs / (1.0 + xs * xs) + 8.0 * np.cos(1.2 * t)
        trans = np.exp(-0.5 * (xs[:, None] - f[None, :]) ** 2 / q)
        trans /= trans.sum(axis=0, keepdims=True)
        p = trans @ p
        p = p * np.exp(-0.5 * (float(ys[t, 0]) - xs * xs / 20.0) ** 2 / r)
        p /= p.sum()
        means.append(float((p * xs).sum()))
    return np.asarray(means)


def bench_clgssm(mats_constant, dev):
    """The offset CLGSSM of benchmarks/bench_subsystems.py:43-66: the demo
    DLM (d = k = 2) for the linear substate, a scalar random walk u whose
    [sin u, cos u] is the observation offset."""
    import torch

    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.clgssm import CLGSSM, params_from_numpy

    pr = params_from_numpy({k: v.astype("float32") for k, v in
                            demo_model_params(2).items()}, dev)
    return CLGSSM.create(
        nl_dim=1, lin_dim=2, obs_dim=2,
        sample_initial_nl=lambda pp, g, n: 0.1 * torch.randn(
            (n, 1), generator=g, device=pp["m0"].device),
        propagate_nl=lambda pp, g, u: u + 0.15 * torch.randn(
            u.shape, generator=g, device=u.device),
        Fmat=lambda pp, u: pp["F"], Gmat=lambda pp, u: pp["G"],
        Vcov=lambda pp, u: pp["V"], Wcov=lambda pp, u: pp["W"],
        c=lambda pp, u: torch.stack([torch.sin(u[0]), torch.cos(u[0])]),
        m0=pr["m0"].cpu().numpy(), C0=pr["C0"].cpu().numpy(), params=pr,
        mats_constant=mats_constant, device=dev)


def bench_liu_west_fns():
    """benchmarks/bench_subsystems.py:92-113's one-parameter model."""
    import torch

    sw, sv = 0.3, 0.2

    def sample_initial(gen, n, theta):
        return torch.randn((n, 1), generator=gen, device=theta.device)

    def propagate(gen, x, theta):
        return theta[:, :1] * x + sw * torch.randn(x.shape, generator=gen,
                                                   device=x.device)

    def propagate_mean(x, theta):
        return theta[:, :1] * x

    def observation_logpdf(y, x, theta):
        r = y[0] - x[:, 0]
        return -0.5 * r * r / (sv * sv)

    def theta_prior(gen, n):
        return 0.5 + 0.2 * torch.randn((n, 1), generator=gen, device="cuda")

    return (sample_initial, propagate, propagate_mean, observation_logpdf,
            theta_prior)


def _aux_row(table, name, config, units, secs, unit, card, extra=""):
    rate = units / secs
    table.append((name, config, rate, unit))
    print(f"  aux {name} ({config}): {rate:.6g} {unit}, best {secs:.4f} s"
          f"{extra} [{card}]")


def registry_cdf_fault(sv, ys, lz_apf) -> None:
    """The fault ``resampling/classic.weight_cdf`` fixes, shown on the
    card: over the stochastic volatility lookahead at y = 3 (N = 2^20),
    the float32 ``torch.cumsum`` dips and steps up over zero weights, and
    systematic positions land on zero-weight particles; the float64 cdf
    gives them none. Then the APF on the SV trace with the float32 cdf in
    place, beside ``lz_apf``, its log-evidence with the float64 one."""
    import torch

    from cusmc_tpu_torch.resampling import classic
    from cusmc_tpu_torch.smc.apf import auxiliary_filter

    n = N_BIG
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = -1.0 + torch.randn(n, generator=gen, device="cuda")
    logw = torch.log_softmax(-0.5 * (x + 9.0 * torch.exp(-x)), 0)
    w = torch.softmax(logw, 0)
    cdf32 = torch.cumsum(w, 0)
    pos = (torch.arange(n, device="cuda", dtype=torch.float32)
           + torch.rand((), generator=gen, device="cuda")) / n
    a32 = torch.searchsorted(cdf32, pos, right=True).clamp_(0, n - 1)
    a64 = classic.systematic_ancestors(gen, logw).long()
    on_zero = int((w[a64] == 0).sum())
    print(f"  registry cdf, SV lookahead at y=3, N=2^20: zero weights "
          f"{int((w == 0).sum())}; float32 torch.cumsum dips "
          f"{int((cdf32[1:] < cdf32[:-1]).sum())} times, steps up over a "
          f"zero weight {int(((cdf32[1:] > cdf32[:-1]) & (w[1:] == 0)).sum())}"
          f" times, systematic ancestors on zero weights "
          f"{int((w[a32] == 0).sum())}; weight_cdf (float64): {on_zero}")
    assert on_zero == 0, "weight_cdf gave zero-weight particles ancestors"
    fixed = classic.weight_cdf
    classic.weight_cdf = lambda v: torch.cumsum(v, dim=0)
    try:
        lz32 = float(auxiliary_filter(1, sv, ys, n,
                                      return_history=False).log_evidence)
    finally:
        classic.weight_cdf = fixed
    print(f"  SV APF N=2^20 T={ys.shape[0]} with the float32 cdf: logZ "
          f"{lz32:.3f}; with weight_cdf: {lz_apf:.3f}")


def models_path(card: str) -> None:
    """Phase 4g: the other model families and the auxiliary filters and
    smoothers (the module docstring, 4g)."""
    import numpy as np
    import torch

    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models import structural
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.models.stochvol import StochasticVolatility
    from cusmc_tpu_torch.models.ungm import UNGM
    from cusmc_tpu_torch.smc import rbpf as rbpf_mod
    from cusmc_tpu_torch.smc.apf import auxiliary_filter
    from cusmc_tpu_torch.smc.csmc import particle_gibbs
    from cusmc_tpu_torch.smc.enkf import ensemble_kalman_filter
    from cusmc_tpu_torch.smc.ffbs import ffbs, transition_logpdf
    from cusmc_tpu_torch.smc.forecast import forecast
    from cusmc_tpu_torch.smc.kalman import kalman_filter, rts_smoother
    from cusmc_tpu_torch.smc.liu_west import liu_west_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter
    from cusmc_tpu_torch.ops.random import categorical

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    n, steps = N_BIG, AUX_T
    oracle_keys = ("F", "G", "V", "W", "m0", "C0")

    # Row 1: stochastic volatility, the packed fast step at d = 1.
    sv = StochasticVolatility.create(device=dev)
    # The trace that tests/test_torch_models.py sizes SV_APF_BAND on: made
    # on the CPU from seed 0.
    _, ys = StochasticVolatility.create(device="cpu").simulate(
        torch.Generator().manual_seed(0), steps)
    ys = ys.to(dev)
    t0 = time.perf_counter()
    apf = auxiliary_filter(1, sv, ys, n, return_history=False)
    torch.cuda.synchronize()
    apf_secs = time.perf_counter() - t0
    lz_apf = float(apf.log_evidence)
    for resampler, kw, used in (
            ("metropolis", {"num_steps": 10}, MODEL_RUNS["xla", "metropolis"]),
            ("systematic", None, MODEL_RUNS["xla", "systematic"])):
        best, res = _counted_best(
            f"SV {resampler}", lambda s: bootstrap_filter(
                s, sv, ys, n, resampler=resampler, resampler_kwargs=kw,
                return_history=False), used, steps, (D_ONE,))
        lz = float(res.log_evidence)
        gap = abs(lz - lz_apf)
        print(f"  SV (mu=-1, phi=0.95, sigma=0.3, beta=1) {resampler} N=2^20 "
              f"T={steps} d=1: {n * (steps - 1) / best:.6g} particle-steps/s,"
              f" best {best:.4f} s of 2, logZ {lz:.3f} vs APF {lz_apf:.3f} "
              f"(|gap| {gap:.3f}, band {SV_APF_BAND}) [{card}]")
        assert gap < SV_APF_BAND, f"SV {resampler}: logZ off the APF's"
    print(f"  SV APF N=2^20 T={steps}: {n * (steps - 1) / apf_secs:.6g} "
          f"particle-steps/s (one run, first use) [{card}]")
    registry_cdf_fault(sv, ys, lz_apf)

    # Row 2: UNGM, the time-hooked fast step at d = 1, against the grid.
    ungm = UNGM.create(device=dev)
    gen.manual_seed(0)
    _, ys = ungm.simulate(gen, UNGM_T)
    best, res = _counted_best(
        "UNGM systematic", lambda s: bootstrap_filter(
            s, ungm, ys, n, resampler="systematic"),
        MODEL_RUNS["xla", "systematic"], UNGM_T, (D_ONE,))
    w = torch.softmax(res.obs_loglik.double(), dim=1)
    pm = (w * res.particles[..., 0].double()).sum(1).cpu().numpy()
    err = np.abs(pm[1:] - grid_filter(10.0, 1.0, 2.0, ys.cpu().numpy())[1:])
    print(f"  UNGM (q=10, r=1) systematic N=2^20 T={UNGM_T} d=1 (history): "
          f"{n * (UNGM_T - 1) / best:.6g} particle-steps/s, best {best:.4f} "
          f"s of 2; filtered means against the grid filter: median |err| "
          f"{np.median(err):.4f} (limit 0.5), mean {err.mean():.4f} (limit "
          f"1.5) [{card}]")
    assert np.median(err) < 0.5 and err.mean() < 1.5, "UNGM off the grid"
    del res, w

    # Row 3: the monthly structural DLM, d = 13, k = 1, both engines.
    model = monthly_model(dev)
    gen.manual_seed(0)
    _, ys = model.simulate(gen, steps)
    mats = structural.combine_matrices(monthly_components())
    _, _, kll = kalman_filter(ys.cpu(), **mats)
    for engine in ("xla", "pallas"):
        for resampler in ("metropolis", "systematic"):
            kw = {"num_steps": 10} if resampler == "metropolis" else None
            width = (D_MONTHLY, 1) if engine == "pallas" else (D_MONTHLY,)
            best, res = _counted_best(
                f"structural {engine} {resampler}",
                lambda s: bootstrap_filter(s, model, ys, n,
                                           resampler=resampler,
                                           resampler_kwargs=kw,
                                           engine=engine,
                                           return_history=False),
                MODEL_RUNS[engine, resampler], steps, width)
            lz = float(res.log_evidence)
            limit = STRUCT_BANDS[engine, resampler] * abs(kll)
            print(f"  structural monthly (trend + seasonal(12)) MVN "
                  f"{resampler} engine={engine} N=2^20 T={steps} d=13 k=1: "
                  f"{n * (steps - 1) / best:.6g} particle-steps/s, best "
                  f"{best:.4f} s of 2, logZ {lz:.3f} vs Kalman {kll:.3f} "
                  f"(|gap| {abs(lz - kll):.3f}, limit {limit:.3f}) [{card}]")
            assert abs(lz - kll) < limit, f"structural {engine} " \
                f"{resampler}: logZ off"

    # Row 4: the auxiliary family at benchmarks/bench_subsystems.py's sizes.
    table = []
    p2 = demo_model_params(2)
    dlm = DLM.create(noise="mvn", device=dev, **p2)
    gen.manual_seed(3)
    _, ys2 = dlm.simulate(gen, steps)
    km2, kc2, kll2 = kalman_filter(ys2.cpu(), **{k: p2[k] for k in
                                                 oracle_keys})
    nothing = {}
    rb_n = 16384
    for label, mats_constant in (("shared covariance", True),
                                 ("general bank", False)):
        rb_model = bench_clgssm(mats_constant, dev)
        best, res = _counted_best(
            f"RBPF {label}", lambda s: rbpf_mod.rao_blackwell_filter(
                s, rb_model, ys2, rb_n), nothing, steps)
        lz = float(res.log_evidence)
        assert math.isfinite(lz), "RBPF: logZ not finite"
        _aux_row(table, "RBPF", f"offset CLGSSM, {label}, N={rb_n}, "
                 f"T={steps}", rb_n * (steps - 1), best, "particle-steps/s",
                 card, f", logZ {lz:.3f} (Kalman of the DLM without the "
                 f"offset: {kll2:.3f})")
    for d, n_e in ((16, 16384), (16, 65536), (64, 65536)):
        pd = demo_model_params(d)
        m_d = DLM.create(noise="mvn", device=dev, **pd)
        gen.manual_seed(3)
        _, ys_d = m_d.simulate(gen, steps)
        km, _, _ = kalman_filter(ys_d.cpu(), **{k: pd[k] for k in
                                                oracle_keys})
        best, res = _counted_best(
            f"EnKF d={d}", lambda s: ensemble_kalman_filter(
                s, m_d, ys_d, n_e), nothing, steps)
        rel = float(np.abs(res.means.cpu().numpy()[5:] - km[5:]).mean()
                    / (np.abs(km[5:]).mean() + 1.0))
        _aux_row(table, "EnKF", f"d={d}, stochastic update, N={n_e}, "
                 f"T={steps}", n_e * (steps - 1), best, "particle-steps/s",
                 card, f", mean error / scale against Kalman {rel:.5f} "
                 f"(limit 0.05)")
        assert rel < 0.05, f"EnKF d={d} N={n_e}: means off Kalman"
    apf_n = 65536
    best, apf = _counted_best("APF", lambda s: auxiliary_filter(
        s, dlm, ys2, apf_n, return_history=False), nothing, steps)
    gap = abs(float(apf.log_evidence) - kll2)
    _aux_row(table, "APF", f"fully adapted, demo DLM d=2, N={apf_n}, "
             f"T={steps}", apf_n * (steps - 1), best, "particle-steps/s",
             card, f", logZ {float(apf.log_evidence):.3f} vs Kalman "
             f"{kll2:.3f} (|gap| {gap:.3f}, limit {0.02 * abs(kll2):.3f})")
    assert gap < 0.02 * abs(kll2), "APF: logZ off Kalman"
    lw_n = 32768
    ys_lw = torch.randn((steps, 1), generator=gen, device=dev)
    best, res = _counted_best("Liu-West", lambda s: liu_west_filter(
        s, *bench_liu_west_fns(), ys_lw, lw_n, device=dev), nothing, steps)
    assert math.isfinite(float(res.log_evidence)), "Liu-West: logZ"
    _aux_row(table, "Liu-West", f"1 parameter, kernel shrinkage, N={lw_n}, "
             f"T={steps}", lw_n * (steps - 1), best, "particle-steps/s",
             card, f", final theta mean {float(res.theta_mean[-1, 0]):.4f}")

    # FFBS over a systematic filter's history, and its breakdown.
    ff_n, ff_m = 8192, 256
    hist = bootstrap_filter(0, dlm, ys2, ff_n, resampler="systematic")
    best, paths = _counted_best("FFBS", lambda s: ffbs(s, dlm, hist, ff_m),
                                nothing, 1)
    sm, sc = rts_smoother(ys2.cpu(), **{k: p2[k] for k in oracle_keys})
    sd = np.sqrt(sc.diagonal(axis1=1, axis2=2))
    err = np.abs(paths.double().mean(1).cpu().numpy()[5:] - sm[5:])
    inside, med = float((err < 5.0 * sd[5:]).mean()), float(
        np.median(err / sd[5:]))
    parts = hist.particles
    x_next = parts[-1][:ff_m]
    logits = hist.obs_loglik[0][None, :] + transition_logpdf(
        dlm, x_next, parts[0])
    idx = categorical(gen, logits)
    shares = {
        "transition matrix": device_ms(lambda: [
            hist.obs_loglik[t][None, :] + transition_logpdf(dlm, x_next,
                                                            parts[t])
            for t in range(steps - 1)], 3),
        "categorical draw": device_ms(lambda: [
            categorical(gen, logits) for _ in range(steps - 1)], 3),
        "gather": device_ms(lambda: [parts[t][idx]
                                     for t in range(steps - 1)], 3)}
    total = sum(shares.values())
    _aux_row(table, "FFBS", f"{ff_m} backward draws, T={steps}, N={ff_n}",
             ff_m * (steps - 1), best, "draw-steps/s", card,
             "; device time of its parts over T-1 steps: " + ", ".join(
                 f"{k} {v:.3f} ms ({v / total:.3f})"
                 for k, v in shares.items())
             + f"; smoothed means against RTS: {inside:.4f} within 5 sd "
             f"(limit 0.99), median |err| / sd {med:.4f} (limit 0.6)")
    assert inside > 0.99 and med < 0.6, "FFBS: smoothed means off RTS"

    pg_n, pg_sweeps = 512, 20
    best, paths = _counted_best("particle Gibbs", lambda s: particle_gibbs(
        s, dlm, ys2, pg_n, pg_sweeps), nothing, 1)
    assert bool(torch.isfinite(paths).all())
    _aux_row(table, "particle Gibbs", f"demo DLM d=2, N={pg_n}, T={steps}, "
             f"{pg_sweeps} sweeps", pg_sweeps, best, "sweeps/s", card,
             f", {best / pg_sweeps:.4f} s a sweep")

    h = 20
    best, (fx, fy) = _counted_best("forecast", lambda s: forecast(
        s, dlm, apf.final_particles, apf.final_log_weights, h), nothing, 1)
    G, W = (np.asarray(p2[k], np.float64) for k in "GW")
    m, P = km2[-1], kc2[-1]
    worst = 0.0
    for t in range(h):
        m, P = G @ m, G @ P @ G.T + W
        se = np.sqrt(np.diag(P) / apf_n)
        z = np.abs(fx[t].double().mean(0).cpu().numpy() - m) / (
            6 * se + 1e-3)
        worst = max(worst, float(z.max()))
    _aux_row(table, "forecast", f"h={h} from the APF's cloud, N={apf_n} "
             f"draws", apf_n * h, best, "draw-steps/s", card,
             f"; predictive means within {worst:.3f} of their bands "
             f"(6 se + 1e-3) of the Kalman predictive")
    assert worst < 1.0, "forecast: predictive means off Kalman"
    print("  aux table [" + card + "]:")
    for name, config, rate, unit in table:
        print(f"    | {name} | {config} | {rate:.6g} {unit} |")


# -- the sharded family and MCMC (phase 4h) --------------------------------

# Rows of the bfloat16 sharded filter: (label, width, steps), MVT df=5,
# N = 2^20 (the headline; the full width at phase 4d's 100 steps).
FAMILY_ROWS = (("headline", D, 200), ("full width", D_WIDE, 100))
# Kernels a step of a sharded run on a one-rank group, by resampler and
# state type: name -> launches a step; every other kernel launches none.
FAMILY_LAUNCHES = {
    ("systematic", "bf16"): {"blocked_cumsum": 1,
                             "inverse_cdf_apply[bf16 local_base]": 1},
    ("residual", "bf16"): {"blocked_cumsum": 3, "inverse_cdf_search": 2,
                           "take_columns[bf16]": 1},
    ("metropolis", "bf16"): {"roll_metropolis_sweeps_expspace[bf16]": 1},
    ("systematic", "f32"): {"blocked_cumsum": 1,
                            "inverse_cdf_apply[local_base]": 1},
    ("residual", "f32"): {"blocked_cumsum": 3, "inverse_cdf_search": 2,
                          "take_columns": 1},
    ("metropolis", "f32"): {"roll_metropolis_sweeps_expspace": 1},
}
ENKF_D, ENKF_N = 64, 65536        # benchmarks/bench_subsystems.py's sizes
REPLICATES, REPLICATE_T = 4, 101  # tests/test_replicated.py's, N = 2^20
# benchmarks/bench_mh.py's configuration: 1024 chains on a d = 128 MVT
# target (df = 8, identity scale), pooled adaptation.
MCMC_CHAINS, MCMC_D, MCMC_DF = 1024, 128, 8.0
MCMC_SWEEPS, HMC_SWEEPS, HMC_LEAPFROG = 2000, 200, 10
# The kept-sample runs: (sweeps, thin). The random walks need about 3 d
# sweeps an autocorrelation time at d = 128, so 2000 sweeps leave their
# chains short of the target (on the CPU: variance 1.17 and 1.06 against
# 4/3, split R-hat 1.46 and 1.47; 20000 sweeps: MH's R-hat 1.0513); they
# keep every 20th of 40000. Their kept runs draw float32 noise: the
# bfloat16 normal law of jax.random.normal (ops/random.bf16_normal_table)
# has mean -0.012, so the proposal is not symmetric and the walk drifts
# (MH on the CPU, 20000 sweeps: coordinate mean -0.253, variance 3.21);
# ``bf16_noise_bias`` shows it on the card.
MCMC_KEEP = {"mh": (40000, 20), "adaptive": (40000, 20),
             "mala": (MCMC_SWEEPS, 1), "hmc": (HMC_SWEEPS, 1)}
# Bands of the kept-sample checks (the second half of each kept run, after
# its adaptation), sized on the CPU with ``mcmc_rows("cpu", timed=False)``
# at these sizes before any card run read them (PERF.md section 6, PR
# 11): the pooled marginal variance within MCMC_VAR_RTOL of df / (df - 2),
# the largest split R-hat over the d coordinates below MCMC_RHAT, and the
# pooled acceptance within each sampler's band around its target.
# One CPU run each (seed 7) read variance 1.3257 / 1.3261 / 1.3530 /
# 1.3354 (MH, adaptive, MALA, HMC; -0.6% to +1.5%), R-hat 1.0246 / 1.0248
# / 1.0205 / 1.0061 and acceptance 0.2358 / 0.2357 / 0.5893 / 0.8880 (HMC
# counts its adaptation from a short step); the bands are about three
# times those distances.
MCMC_VAR_RTOL = 0.05
MCMC_RHAT = 1.05
MCMC_ACCEPT = {"mh": (0.234, 0.20, 0.27), "adaptive": (0.234, 0.20, 0.27),
               "mala": (0.574, 0.50, 0.65), "hmc": (0.8, 0.75, 0.95)}


def mcmc_rows(dev, card="", timed=True) -> dict:
    """MH and adaptive MH (``chol_every=50``) with bfloat16 proposal noise,
    MALA, HMC (L leapfrog steps) at benchmarks/bench_mh.py's configuration
    on ``dev``: with ``timed``, one warm-up and the best of 2 of each
    without samples (chain-steps/s; for MALA and HMC gradient evaluations
    per second, L a trajectory for HMC); then one run of each with
    ``keep_samples`` (MCMC_KEEP; float32 noise) whose second half gives
    the pooled marginal variance (target df / (df - 2)) and the largest
    split R-hat over the coordinates; then MH's kept run with bfloat16
    noise, whose drift is printed. Returns name -> (variance, R-hat,
    acceptance) of the kept runs, each printed beside its band. Runs on
    the CPU too, where the bands were sized (no rate is printed there)."""
    import torch

    from cusmc_tpu_torch.diagnostics.mcmc import split_rhat
    from cusmc_tpu_torch.distributions import make_mvt_logprob
    from cusmc_tpu_torch.mcmc import adaptive_mh_sampler, hmc_sampler, \
        mala_sampler, metropolis_hastings_sampler
    from cusmc_tpu_torch.ops.random import bf16_normal_table

    dev = torch.device(dev)
    c, d, df = MCMC_CHAINS, MCMC_D, MCMC_DF
    logp = make_mvt_logprob(torch.zeros(d, device=dev),
                            torch.eye(d, device=dev), df)
    init = torch.randn((c, d), generator=torch.Generator(dev).manual_seed(1),
                       device=dev)
    bf16 = torch.bfloat16
    samplers = {
        "mh": (lambda s, t, keep, thin: metropolis_hastings_sampler(
            s, logp, init, t, step_size=2.38 / math.sqrt(d),
            adapt_rate=0.05, keep_samples=keep, thin=thin,
            noise_dtype=None if keep else bf16), MCMC_SWEEPS, 0),
        "adaptive": (lambda s, t, keep, thin: adaptive_mh_sampler(
            s, logp, init, t, adapt_rate=0.05, keep_samples=keep, thin=thin,
            chol_every=50, noise_dtype=None if keep else bf16),
            MCMC_SWEEPS, 0),
        "mala": (lambda s, t, keep, thin: mala_sampler(
            s, logp, init, t, step_size=0.3, adapt_rate=0.05,
            keep_samples=keep, thin=thin), MCMC_SWEEPS, 1),
        "hmc": (lambda s, t, keep, thin: hmc_sampler(
            s, logp, init, t, num_leapfrog=HMC_LEAPFROG, step_size=0.2,
            adapt_rate=0.05, keep_samples=keep, thin=thin),
            HMC_SWEEPS, HMC_LEAPFROG),
    }
    out = {}
    for name, (run, sweeps, grads) in samplers.items():
        line = f"  MCMC {name} C={c} d={d} MVT df={df:g}"
        if timed:
            best, res = math.inf, None
            for rep in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run(rep, sweeps, False, 1)
                acc = float(res.accept_rate)  # the host read ends the run
                secs = time.perf_counter() - t0
                if rep:
                    best = min(best, secs)
            line += (f", {sweeps} sweeps: {c * sweeps / best:.6g} "
                     f"chain-steps/s"
                     + (f", {c * sweeps * grads / best:.6g} grad-evals/s"
                        if grads else "")
                     + f", best {best:.4f} s of 2, pooled acceptance "
                     f"{acc:.4f}, step size {float(res.step_size):.4f} "
                     f"[{card}]")
        keep_sweeps, thin = MCMC_KEEP[name]
        res = run(7, keep_sweeps, True, thin)
        kept = res.samples[res.samples.shape[0] // 2:]
        var = float(kept.reshape(-1, d).var(0).mean())
        rhat = float(split_rhat(kept).max())
        acc = float(res.accept_rate)
        target, lo, hi = MCMC_ACCEPT[name]
        want = df / (df - 2.0)
        print(f"{line}; kept run of {keep_sweeps} sweeps (every {thin}): "
              f"marginal variance {var:.4f} (target "
              f"{want:.4f}, rtol {MCMC_VAR_RTOL}), max split R-hat "
              f"{rhat:.4f} (< {MCMC_RHAT}), acceptance {acc:.4f} (target "
              f"{target}, band [{lo}, {hi}])")
        out[name] = (var, rhat, acc)
        assert abs(var - want) <= MCMC_VAR_RTOL * want, \
            f"MCMC {name}: marginal variance {var}"
        assert rhat < MCMC_RHAT, f"MCMC {name}: split R-hat {rhat}"
        assert lo <= acc <= hi, f"MCMC {name}: acceptance {acc}"
    # The bfloat16 proposal law's drift (MCMC_KEEP's comment): MH's kept
    # run again with the bfloat16 noise of the rate rows; shown, not held.
    sweeps, thin = MCMC_KEEP["mh"]
    res = metropolis_hastings_sampler(
        7, logp, init, sweeps, step_size=2.38 / math.sqrt(d),
        adapt_rate=0.05, thin=thin, noise_dtype=bf16)
    kept = res.samples[res.samples.shape[0] // 2:]
    print(f"  MCMC mh with bfloat16 noise, kept run of {sweeps} sweeps: "
          f"coordinate mean {float(kept.mean()):.4f} (float32 noise: 0 "
          f"within its error), marginal variance "
          f"{float(kept.reshape(-1, d).var(0).mean()):.4f}, max split R-hat "
          f"{float(split_rhat(kept).max()):.4f}: the bfloat16 normal law "
          f"has mean {float(bf16_normal_table().double().mean()):.5f}")
    return out


def family_path(card: str) -> None:
    """Phase 4h: the rest of the sharded family on a one-rank NCCL group
    (the bfloat16 sharded filter beside the float32 one, the
    ensemble-sharded EnKF, replicated filters on a (1, 1) grid) and MCMC
    part 1 (the module docstring, 4h)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.parallel import Mesh, ParticleAxis, \
        initialize_distributed, replicated_sharded_filters, \
        sharded_bootstrap_filter, sharded_ensemble_kalman_filter
    from cusmc_tpu_torch.parallel.mesh import rank_seed
    from cusmc_tpu_torch.smc.enkf import ensemble_kalman_filter
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    dev = torch.device("cuda")
    n = N_BIG
    oracle_keys = ("F", "G", "V", "W", "m0", "C0")
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            axis = ParticleAxis()
            for label, d, steps in FAMILY_ROWS:
                p = demo_model_params(d)
                models = {k: DLM.create(noise="mvt", df=5.0, device=dev,
                                        state_dtype=dt, **p)
                          for k, dt in (("bf16", torch.bfloat16),
                                        ("f32", None))}
                _, ys = models["f32"].simulate(
                    torch.Generator(dev).manual_seed(0), steps)
                for r in ("systematic", "residual", "metropolis"):
                    def sharded(kind, seed=1, ax=axis, r=r):
                        return sharded_bootstrap_filter(
                            seed, models[kind], ys, n, ax, resampler=r)
                    tag = f"{label} d={d} {r}"
                    _, got = _counted_best(
                        f"bf16 sharded {tag}", lambda _: sharded("bf16"),
                        FAMILY_LAUNCHES[r, "bf16"], steps, reps=0)
                    assert got.final_particles.dtype == torch.bfloat16
                    assert bool(torch.isfinite(
                        got.final_particles.float()).all())
                    # The same ops and streams without an axis: the
                    # one-rank group's collectives are the identity.
                    _same_result(f"bf16 sharded {tag}", got,
                                 sharded("bf16", ax=None))
                    same = "the run without collectives"
                    if r == "metropolis":
                        gen = torch.Generator(dev).manual_seed(
                            rank_seed(1, 0))
                        _same_result(f"bf16 sharded {tag}", got,
                                     bootstrap_filter(
                                         gen, models["bf16"], ys, n,
                                         resampler=r, return_history=False))
                        same += " and the single-device run"
                    _counted_best(f"f32 sharded {tag}",
                                  lambda _: sharded("f32"),
                                  FAMILY_LAUNCHES[r, "f32"], steps, reps=0)
                    best = _best_of({
                        "f32": lambda: sharded("f32", 2),
                        "bf16": lambda: sharded("bf16", 2)})
                    rates = {k: n * (steps - 1) / v for k, v in best.items()}
                    print(f"  sharded {tag} MVT df=5 N=2^20 T={steps}: bf16 "
                          f"{rates['bf16']:.6g} particle-steps/s beside f32 "
                          f"{rates['f32']:.6g} (bf16 / f32 "
                          f"{rates['bf16'] / rates['f32']:.3f}; best of 2 "
                          f"in turns), logZ bf16 "
                          f"{float(got.log_evidence):.3f}; bitwise "
                          f"{same}; launches "
                          + ", ".join(f"{k} {v * (steps - 1)}" for k, v in
                                      FAMILY_LAUNCHES[r, "bf16"].items())
                          + f" [{card}]")

            # The ensemble-sharded EnKF at P = 1 against the single-device
            # EnKF seeded with the rank stream's seed: bitwise.
            p = demo_model_params(ENKF_D)
            m = DLM.create(noise="mvn", device=dev, **p)
            steps = 200
            _, ys = m.simulate(torch.Generator(dev).manual_seed(3), steps)
            km, _, _ = kalman_filter(ys.cpu(), **{k: p[k] for k in
                                                  oracle_keys})
            runs = {"sharded": lambda: sharded_ensemble_kalman_filter(
                        3, m, ys, ENKF_N, axis),
                    "single": lambda: ensemble_kalman_filter(
                        torch.Generator(dev).manual_seed(rank_seed(3, 0)),
                        m, ys, ENKF_N)}
            _, got = _counted_best("sharded EnKF",
                                   lambda _: runs["sharded"](), {}, steps,
                                   reps=0)
            want = runs["single"]()
            for f in ("final_ensemble", "means", "spread"):
                assert torch.equal(getattr(got, f), getattr(want, f)), \
                    f"sharded EnKF: {f} differs from the single-device run"
            rel = float(np.abs(got.means.cpu().numpy()[5:] - km[5:]).mean()
                        / (np.abs(km[5:]).mean() + 1.0))
            assert rel < 0.05, f"sharded EnKF: means off Kalman ({rel})"
            best = _best_of(runs)
            print(f"  sharded EnKF d={ENKF_D} N={ENKF_N} T={steps} (one-rank "
                  f"group): {ENKF_N * (steps - 1) / best['sharded']:.6g} "
                  f"particle-steps/s beside the single-device "
                  f"{ENKF_N * (steps - 1) / best['single']:.6g}; bitwise "
                  f"the single-device run; mean error / scale against "
                  f"Kalman {rel:.5f} (limit 0.05) [{card}]")

            # Replicated sharded filters on a (1, 1) grid of ranks.
            p = demo_model_params()
            mvn = DLM.create(noise="mvn", device=dev, **p)
            ys = load_y_sim()[:REPLICATE_T]
            _, _, kll = kalman_filter(ys, **{k: p[k] for k in oracle_keys})
            mesh = Mesh({"chains": 1, "particles": 1})
            for r, used in (("metropolis",
                             {"roll_metropolis_sweeps_expspace": 4}),
                            ("systematic", {"blocked_cumsum": 4,
                                            "inverse_cdf_search": 4})):
                secs, res = _counted_best(
                    f"replicated {r}", lambda s: replicated_sharded_filters(
                        s, mvn, ys, n, REPLICATES, mesh, resampler=r),
                    used, REPLICATE_T, reps=1)
                lz = res.log_evidence.cpu().numpy()
                assert lz.shape == (REPLICATES,)
                assert tuple(res.final_particles.shape) == (REPLICATES, n, 2)
                assert (np.abs(lz - kll) < 0.08 * abs(kll)).all(), \
                    f"replicated {r}: logZ {lz} off Kalman {kll}"
                assert np.unique(lz).size == REPLICATES, \
                    f"replicated {r}: replicates not distinct"
                print(f"  replicated {r} R={REPLICATES} N=2^20 "
                      f"T={REPLICATE_T} MVN on a (1, 1) grid: logZ "
                      + ", ".join(f"{v:.3f}" for v in lz)
                      + f" (Kalman {kll:.3f}, band "
                      f"{0.08 * abs(kll):.3f}), distinct; "
                      f"{REPLICATES * n * (REPLICATE_T - 1) / secs:.6g} "
                      f"particle-steps/s after one warm-up [{card}]")
        finally:
            dist.destroy_process_group()
    mcmc_rows(dev, card)


# -- the main paths' own traffic ------------------------------------------

# Steps of a T = 200 run whose inputs to the block-window kernels are kept
# while the main paths run: the first resample, one in the middle, the last.
TRAFFIC_STEPS = (0, 99, 198)
# (wrapper name, label) -> [(step, args, kwargs)], filled by ``capture``
# (and, with step None, by phase 3 for the search-only kernel's shuffled
# queries).
TRAFFIC: dict = {}


def _clone(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple):
        return tuple(_clone(x) for x in v)
    return v


@contextlib.contextmanager
def capture(module, name, labels):
    """While open, the calls that ``module`` makes to its function ``name``
    (a kernel's wrapper, imported there by name) run unchanged, and the
    arguments of the steps in TRAFFIC_STEPS are kept, cloned, in
    TRAFFIC[name, label]: each step makes one call for each of ``labels``,
    in that order."""
    fn = getattr(module, name)
    calls = itertools.count()

    def recorder(*args, **kwargs):
        step, which = divmod(next(calls), len(labels))
        if step in TRAFFIC_STEPS:
            TRAFFIC.setdefault((name, labels[which]), []).append(
                (step, _clone(args), dict(kwargs)))
        return fn(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        yield
    finally:
        setattr(module, name, fn)


def other_tree(root):
    """The kernels that phase 5 times, of another checkout of the repo at
    ``root`` (its ``cusmc_tpu_torch/ops/kernels.py``, loaded under another
    name, builds them from its own sources into its own ``build/``):
    wrapper name -> ``fn(args, kwargs)`` returning the ancestors, called
    with the arguments that this tree's wrapper takes, and
    "blocked_cumsum" -> ``fn(w)`` returning the cdf (phase 3's counts over
    zero weights). The C entries keep
    their signatures across trees (but for the fused CDF step's ``tiled``
    argument, added with the "tile" design)."""
    import importlib.util

    import torch

    from cusmc_tpu_torch.ops.fused_cdf_step import MODES, cdf_auto_tile
    from cusmc_tpu_torch.ops.fused_step import step_path

    path = os.path.join(root, "cusmc_tpu_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location(
        f"other_kernels_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    lib = mod.library()
    print(f"  built the kernels of {root} in "
          f"{time.perf_counter() - t0:.1f} s")
    # Before the "tile" design the fused CDF step took no `tiled` argument;
    # before the bfloat16 state the search-and-apply took no `bf16` one.
    has_tiled = len(mod.SIGNATURES["cusmc_fused_cdf_step"]) == 23
    has_bf16 = len(mod.SIGNATURES["cusmc_inverse_cdf_apply"]) == 12

    stream = torch.cuda.current_stream().cuda_stream

    def cumsum(w):
        n = w.numel()
        state = torch.zeros(2 + n // 8192, dtype=torch.int64,
                            device=w.device)
        cdf = torch.empty_like(w)
        mod.check(lib.cusmc_blocked_cumsum(
            w.data_ptr(), cdf.data_ptr(), state.data_ptr(), state.numel(), n,
            0, 1, stream), root)
        return cdf

    def search(args, kw):
        cdf, q = args
        a = torch.empty(q.numel(), dtype=torch.int32, device=q.device)
        mod.check(lib.cusmc_inverse_cdf_search(
            cdf.data_ptr(), q.data_ptr(), a.data_ptr(), cdf.numel(),
            q.numel(), stream), root)
        return a

    def apply(args, kw):
        cdf, q, X = args
        base = kw.get("local_base") or 0
        out = torch.empty((X.shape[0], q.numel()), dtype=X.dtype,
                          device=X.device)
        a = torch.empty(q.numel(), dtype=torch.int32, device=q.device)
        mod.check(lib.cusmc_inverse_cdf_apply(
            cdf.data_ptr(), q.data_ptr(), X.data_ptr(), out.data_ptr(),
            a.data_ptr(), cdf.numel(), q.numel(), X.shape[1], base,
            X.shape[0], *((0,) if has_bf16 else ()), stream), root)
        return a

    def cdf_step(args, kw):
        cdf, X, y, G, Q, F, Li, df, log_norm, (u, seed) = args
        (d, n), k = X.shape, F.shape[0]
        Xo, ll = torch.empty_like(X), torch.empty_like(cdf)
        a = torch.empty(n, dtype=torch.int32, device=X.device)
        tiled = (int(step_path(d, k) == "tile"),) if has_tiled else ()
        mod.check(lib.cusmc_fused_cdf_step(
            *(t.data_ptr() for t in (cdf, X, y, G, Q, F, Li, u, seed, Xo, ll,
                                     a)),
            n, kw.get("tile") or cdf_auto_tile(n, max(d, k)), d, k,
            MODES.index(kw["mode"]), int(kw["noise"] == "mvt"),
            kw.get("df_int") or 0, 1.0 if df is None else float(df),
            float(log_norm), *tiled, stream), root)
        return a

    return {"inverse_cdf_search": search, "inverse_cdf_apply": apply,
            "fused_cdf_filter_step": cdf_step, "blocked_cumsum": cumsum}


def check_traffic(others) -> None:
    """Phase 5: the three block-window kernels on the inputs that the main
    paths gave them (TRAFFIC): for each kept step, the spans of the cdf
    that its blocks search and the share of blocks that fits the window
    (and would fit a window of another size), the kernel against its plain
    version (ancestors equal, a mismatch only at a shown cdf tie; gathered
    values exactly, states and ll at 1e-4) and its device time; beside it
    the device time of the same kernel of each tree in ``others``
    (``other_tree``), on the same inputs, in the order other, this, this,
    other, with its ancestors equal to this tree's."""
    import torch

    from cusmc_tpu_torch.ops.fused_cdf_step import fused_cdf_filter_step, \
        fused_cdf_filter_step_plain
    from cusmc_tpu_torch.ops.kernels import CDF_BLOCK, CDF_WINDOW, \
        SEARCH_BLOCK, SEARCH_WINDOW
    from cusmc_tpu_torch.ops.monotone_gather import block_spans, \
        inverse_cdf_apply, inverse_cdf_apply_plain, inverse_cdf_search, \
        inverse_cdf_search_plain, window_fit_share

    kept_on_paths = [k for k, v in TRAFFIC.items() if v[0][0] is not None]
    assert len(kept_on_paths) == 9, f"kept on the main paths: {kept_on_paths}"
    for (fn, label), kept in sorted(TRAFFIC.items()):
        assert kept[0][0] is None or \
            [s for s, _, _ in kept] == list(TRAFFIC_STEPS), label
        for step, args, kw in kept:
            name = label if step is None else f"{label}, step {step}"
            if fn == "fused_cdf_filter_step":
                cdf, X, _, _, _, _, _, _, _, (u, _) = args
                n = cdf.numel()
                assert kw["mode"] == "systematic", name
                pos = (torch.arange(n, dtype=torch.float32, device=cdf.device)
                       + u) * (cdf[-1] / torch.tensor(float(n),
                                                      device=cdf.device))
                block, window, ends = CDF_BLOCK, CDF_WINDOW, True
                x, ll, a = fused_cdf_filter_step(*args, **kw)
                x_p, ll_p, a_p = fused_cdf_filter_step_plain(*args, **kw)
                _compare(name, a, a_p, (x, ll), (x_p, ll_p),
                         lambda _: _ancestors_equal(name, a, a_p, cdf, pos))

                def ours(args=args, kw=kw):
                    return fused_cdf_filter_step(*args, **kw)[2]
            elif fn == "inverse_cdf_apply":
                cdf, pos, X = args
                base = kw.get("local_base")
                block, window, ends = SEARCH_BLOCK, SEARCH_WINDOW, False
                y, a = inverse_cdf_apply(*args, **kw)
                y_p, a_p = inverse_cdf_apply_plain(*args, **kw)
                _ancestors_equal(name, a, a_p, cdf, pos)
                keep = a == a_p
                assert torch.equal(y[:, keep], y_p[:, keep]), \
                    f"{name}: gathered values differ"
                name += f" (d={X.shape[0]}" + ("" if base is None else
                                               f", local_base={base}") + ")"

                def ours(args=args, kw=kw):
                    return inverse_cdf_apply(*args, **kw)[1]
            else:
                cdf, pos = args
                block, window, ends = SEARCH_BLOCK, SEARCH_WINDOW, False
                a = inverse_cdf_search(cdf, pos)
                _ancestors_equal(name, a, inverse_cdf_search_plain(cdf, pos),
                                 cdf, pos)

                def ours(cdf=cdf, pos=pos):
                    return inverse_cdf_search(cdf, pos)

            def theirs(fns, fn=fn, args=args, kw=kw):
                return fns[fn](args, kw)
            spans = block_spans(cdf, pos, block, ends).double()
            shares = ", ".join(
                f"{w}: {window_fit_share(cdf, pos, block, w, ends):.4f}"
                for w in (window // 4, window // 2, window, 2 * window))
            distinct = int(torch.unique(a).numel())
            print(f"  {name}: N={cdf.numel()}, {pos.numel()} queries, "
                  f"{distinct} distinct ancestors; span of a {block}-query "
                  f"block median {float(spans.median()):.0f}, p99 "
                  f"{float(spans.quantile(0.99)):.0f}, max "
                  f"{float(spans.max()):.0f} cdf entries; share of blocks "
                  f"that fit a window of {shares} floats (the kernel's: "
                  f"{window})")
            mine = device_ms(ours)
            line = f"    device time: this tree {mine:.4f} ms"
            for root, fns in others:
                _ancestors_equal(f"{name}, {root}", theirs(fns), a, cdf, pos)
                t = [device_ms(lambda: theirs(fns))]
                t += [device_ms(ours), device_ms(ours)]
                t.append(device_ms(lambda: theirs(fns)))
                line += (f"; {root} {t[0]:.4f}/{t[3]:.4f} ms, this tree "
                         f"{t[1]:.4f}/{t[2]:.4f} ms beside it")
            print(line)
    TRAFFIC.clear()
    torch.cuda.synchronize()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one CUDA card.")
    parser.add_argument(
        "--against", nargs="+", default=[], metavar="DIR",
        help="other checkouts of the repo (the parent commit unpacked with "
             "git archive, say): phase 5 times their block-window kernels "
             "beside this tree's on the main paths' own inputs")
    args = parser.parse_args(argv)
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
    build_native()
    others = [(root, other_tree(root)) for root in args.against]
    with phase("kernels against their plain versions"):
        rec = check_kernels()
        rec["blocked_cumsum"]["zero_steps"] = check_zero_steps(others)
        rec.update(check_shard_kernels())
        rec.update(check_fused_kernels())
    with phase("the kernels at the other models' widths (d = 1; d = 13, "
               "k = 1)"):
        check_model_kernels()
    with phase("the kernels on a bfloat16 state (mixed precision)"):
        rec.update(check_bf16_kernels())
    with phase("statistics of the fused kernels"):
        check_statistics()
    with phase("the \"tile\" design's oracle (d = 16 and 32)"):
        check_tile_oracle()

    launches = {}
    for path, title, drive in (
            ("main", "main path", main_path),
            ("pallas", "fused path (engine='pallas')", pallas_path),
            ("sharded", "sharded path (one-rank NCCL group)", sharded_path),
            ("bf16", "mixed precision (a bfloat16 state, beside float32)",
             bf16_path),
            ("generic", "generic path (the log-space step)",
             generic_path),
            ("streaming", "the headless runner and the streaming filter",
             streaming_path),
            ("models", "the other models and the auxiliary family",
             models_path),
            ("family", "the sharded family and MCMC", family_path)):
        with phase(title):
            _zero_counts()
            drive(card)
            launches[path] = _counts()
            print(f"  launches on the {path} path: " + ", ".join(
                f"{k} {v}" for k, v in launches[path].items() if v))
    with phase("the block-window kernels on the main paths' own inputs"):
        check_traffic(others)

    records = []
    for name, source, replaces, paths in KERNELS:
        paths = (paths,) if isinstance(paths, str) else paths
        for path in paths:
            assert launches[path][name] > 0, \
                f"{name} never launched on the {path} path"
        count = sum(launches[path][name] for path in paths)
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
