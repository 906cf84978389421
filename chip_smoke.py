#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cusmc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. The card's name and power limit, from nvidia-smi.
2. Build: nvcc compiles the port's kernels (cusmc_tpu_torch/csrc/*.cu),
   one process per source, all started together; the phase fails when an
   instantiation of the fused kernels (every "thread" bucket, exact tile
   and padded tile width, FUSED_INSTANCES) reports a stack frame or a
   spill (ptxas), or when the draws' exact rewrites
   (``cos_reduced``, ``to_uniform``) differ from cosf and float(m) 2^-23
   on any of their 2^23 arguments (a small check built beside them).
3. Kernels: each kernel against its plain PyTorch version on the same
   tensors, with the tolerance stated beside each check. The prefix sum,
   the search and the roll walk at N = 2^20 and a ragged N, d = 2 (the
   search-and-apply also at d = 32, timed there too, and on shuffled
   queries; the prefix sum also at a few-element N, on weights that stress
   its tile boundaries, with one kernel a call counted by the profiler and
   the same result on a second call); the fused Metropolis step at
   N = 2^20, d = 2, 16, 32, 64 and 128, MVN and MVT df=5, with the design
   each d takes ("thread" or "tile"); the fused inverse-CDF step,
   systematic and stratified, at N = 2^20 and N = 1_000_448, d = 2, 16,
   32, 64 and 128, with its design; the composed DLM step's two kernels
   (propagate and log-likelihood, ops/packed_model.py) at d = 2, k = 2,
   MVT df=5 and d = 13, k = 1, MVN, at N = 2^20 and at the benchmark's
   composed cells' N (2^23, 2^22), timed beside their plain version (the
   cuBLAS products and elementwise chain they replace), the cuBLAS
   products alone and their bytes' bound. The search-only kernel, the
   search-and-apply and the fused inverse-CDF step search the cdf through
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
   models' widths (phases 4g and 4i): the search-and-apply and the roll
   walk at d = 1 and d = 13 (N = 2^20, exp-space and concentrated
   weights), the cumsum and the search-and-apply at PMMH's N = 2^16, d = 1
   (the weight kinds above; each record's error is the largest of all its
   cases), and both fused kernels on the monthly structural DLM, d = 13,
   k = 1, which takes the "thread" design's (16, 1) width bucket: the
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
   also held bitwise flat over its zero weights. Then the roll walk at
   the auto schedule's short sweep counts, B = 3 and 5, at N = 8192 and
   2^20, d = 2 (exp-space, uniform and concentrated weights; ancestors and
   values exactly the plain version's), timed beside its bound. Then the
   roll walk at every width the paths give it (``check_roll_widths``:
   d = 1, 2, 13, 16, 32 float32 and 2, 16, 32 bfloat16; N = 2^20,
   2^20 - 3 and 1000003; B = 1, 3, 5, 10; the "identity", "one front"
   and "mixed" ancestor patterns), as the card's plan runs it (one pass,
   or banded: ``resampling/rolls.roll_band_rows``) and at forced band
   sizes with partial last bands (ROLL_SPLITS), ancestors and values
   exactly the plain version's, one launch counted a call; then at
   N = 2^20, B = 10 each width and pattern timed with L2 warm and cold
   (``queued_ms``: CUDA events around a call queued behind a sleep
   kernel) beside its bound, the band sizes of ROLL_BAND_SWEEP, one pass
   against bands about the switch (ROLL_SWITCH_WIDTHS), and the walk
   alone. Then the fused kernels at the widths of
   FUSED_WIDTHS (``check_fused_widths``: the Metropolis step at d = 2
   float32 and bfloat16, 4, 5, 8 and the monthly DLM's d = 13, k = 1, MVN
   and MVT; the CDF step at d = 2 and 13; the exact "tile" shapes; past 16
   the padded "tile" widths: the Metropolis step at d = k = 24, 40, 64 and
   128, (32, 1), (64, 1) and (2, 64), MVN and MVT, bfloat16 at 64 and 128,
   the CDF step at 64 and 128), each held to its plain version and printed
   with its design and widths, then timed with L2 warm and cold beside the
   bound of ``fused_bound`` (bytes, and the Philox multiplies, special
   functions and flops at their rates, at the unpadded widths; the padded
   tiles' flops printed beside).
3b. Statistics of the fused kernels (benchmarks/validate_fused_tpu.py
   checks 1-5d with their thresholds): zero-noise consistency, offspring
   against the indexed Metropolis resampler, noise moments, the inverse-CDF
   sandwich with an exact gather, stratified offspring, and log-evidence
   against the Kalman filter and the composed path.
3c. The "tile" design's oracle, for both fused kernels at d = 16, 32 and
   64 (systematic for the CDF step; d = 64 in the padded widths' kernel),
   the design printed beside each case:
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
4i. MCMC part 2, the SMC samplers, PMMH and the chain-sharded samplers,
   with every launch count set to 0 first: (a) at bench_mh.py's
   configuration, ChEES (200 sweeps; chain-steps/s, grad-evals/s = C sum
   n_leap / s and mean_leapfrog), parallel tempering (8 rungs of 128
   chains, beta_min 0.05, bfloat16 noise, 2000 sweeps; replica-steps/s)
   and the stretch move (1024 walkers, 2000 sweeps; walker-steps/s), one
   warm-up and the best of 2, then kept runs (float32 noise) whose
   marginal variance, split R-hat, acceptance (PT: and swap rates) sit in
   bands sized on the CPU (``mcmc2_rows``); (b) ``sample_to_convergence``
   with ChEES on that target (blocks of 100, at most 10) and with PT on
   the bimodal target of tests/test_driver.py, both converged, PT's share
   of x0 > 0 in (0.2, 0.8); (c) the SMC sampler at N = 2^16 on the
   shifted Gaussian at d = 3 and 32 (rwm, mala, hmc, waste-free rwm),
   stages, particle-moves/s, log-evidence and weighted mean in bands
   sized on the CPU (``smc_sampler_rows``; the d = 32 random-walk rows,
   whose values spread widely from seed to seed, on 16 seeds, each seed
   in a band and the seeds' mean in a band sized from the CPU's spread,
   ``smc_seed_spread``); (d) SMC^2 on the AR(1) model
   (150 observations, 256 x 256), its posterior mean within 3 sd + 0.03
   of the grid oracle, the share of its time its rejuvenations take; (e)
   PMMH on the 1-d DLM (T = 101, N = 2^16, 150 steps, systematic), its
   posterior median and acceptance in the JAX test's bands, the cumsum,
   the search-and-apply and the composed step's two kernels launched
   exactly 151 x 100 times each and no other kernel in the whole phase,
   the first two's inputs kept at four steps for
   phase 5; (f) the chain-sharded MH, PT, ChEES
   and stretch samplers on a one-rank NCCL group, each bitwise the
   unsharded sampler with rank 0's seed, rates side by side.
4j. The graft entry, the dry run and the examples, with every launch
   count set to 0 first: ``graft_entry.entry()``'s step (N=4096, MVT
   df=5, metropolis; one launch each of the roll walk and the composed
   step's two kernels and no other);
   ``dryrun_multichip(1)`` on a one-rank NCCL group (the sharded filter
   for systematic, metropolis and residual, sharded streaming, the
   chain-sharded samplers, the sharded EnKF; N = 8); the eight examples
   of ``examples/torch`` in process at their own sizes, each timed and
   each printed quantity in its band (``EXAMPLE_BANDS``) or finite, the
   sweep counts of 06's auto schedule in {10, 5, 3}; and example 01 as a
   script (``python3 examples/torch/01_particle_filter.py``). The kernels'
   inputs are kept for phase 5 (``EXAMPLE_TRAFFIC``, every call of the
   dry run).
5. The block-window kernels on the main paths' own inputs, kept at steps
   0, 99 and 198 of the warm-up runs of phases 4 (the search-and-apply of
   the composed systematic headline, d = 2), 4b (the fused CDF step of the
   systematic pallas runs, d = 2 and 32; the search-and-apply of the
   composed systematic run at d = 32) and 4c (the search-only kernel's two
   calls a step of the sharded residual run; the search-and-apply's two
   calls a step of the single-device residual run and its local-block
   mode in the sharded systematic run), and of phase 4i's PMMH at calls
   1, 7501, 7579 and 15001 of its 15100 (the search-and-apply at d = 1
   and the cumsum; ``PMMH_TRAFFIC_STEPS``), and of phase 4j (the inputs
   of the examples' and the dry run's cumsum, search-and-apply in both
   modes, search-only kernel, take-columns and roll walk, N = 8 to 16384):
   the spans of the cdf that their
   blocks search, the share of blocks that fits the window (and would fit
   one a quarter, half or twice as large), each kernel against its plain
   version, and its device time; the same for the search-only kernel's
   shuffled queries of phase 3. The roll walk and take-columns are held
   exactly to their plain versions there and timed; the roll walk also on
   the composed metropolis rows' inputs at steps 0, 99 and 198 (phase 4's
   headline, d = 2, and phase 4b's full width, d = 32).
   ``--against DIR [DIR ...]`` times the same kernels of other checkouts
   of the repo (the parent commit unpacked with ``git archive``, say)
   beside this tree's on those inputs, and their roll walk beside this
   tree's in phase 3 (held equal to it); a last phase then runs the
   composed metropolis rows (d = 2 and 32) with each tree's roll walk in
   turns, their rates, busy shares and the walk's share, each run bitwise
   this tree's; with it phase 3 holds each other tree's fused kernels
   bitwise to this tree's at FUSED_WIDTHS and times them in turns, and a
   last phase runs the pallas headline and structural rows with each
   tree's fused wrappers in turns (``fused_row``). ``--packed`` runs
   only the composed DLM step's kernels' part of phase 3 and prints no
   result. ``--rolls`` runs only
   the roll walk's part of phase 3, those rows (keeping their inputs) and
   phase 5 on them, and prints no result; ``--fused`` only the fused
   kernels' part of phase 3, the pallas rows and the d >= 64 rows
   (``wide_rows``, the README's pallas regime: the demo model at d = k =
   64 and 128, float32 and bfloat16, MVT df=5, N=2^20, T=200, metropolis
   B=10, pallas beside xla in turns, best of 3: particle-steps/s, ESS/s,
   busy share, the step kernel's ms a step and both engines'
   log-evidence beside the Kalman value, each run's log-evidence finite
   and its launches exact), ``--timed DIR ...``
   adding trees that are timed there and held to nothing (variants that
   drop work), and prints no result.

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
import re
import subprocess
import sys
import time

N_BIG = 1 << 20
N_RAGGED = 1_000_003
N_RAGGED_CDF = 1_000_448  # 977 * 1024: the fused CDF step needs N % 1024
D = 2
D_MID = 16   # the narrower width of the fused steps' "tile" design
D_WIDE = 32
D_PAD = 64   # a width of the "tile" design's padded widths (phase 3c)
FUSED_PAD_DIMS = (D_PAD, 128)  # d = k of phase 3's padded-width cases
TIMING_REPS = 20
PLAIN_FUSED_REPS = 5      # the plain fused steps take tens of ms a call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published (700 W part)
FP32_FLOPS = 67e12         # H100 SXM, float32 outside the tensor cores
TF32_FLOPS = 495e12        # H100 SXM, TF32 on the tensor cores, dense
BF16_FLOPS = 989e12        # H100 SXM, bf16 on the tensor cores, dense
# The fused kernels' draws run on two more pipes. At the clock at which
# the published float32 rate is reached (132 SMs x 128 lanes x 2 flops),
# the CUDA C++ Programming Guide's throughput for compute capability 9.0
# gives 64 32-bit integer multiplies an SM a clock (Philox) and 16
# special functions (exp2, log2, rsqrt, reciprocal, sin, cos).
H100_SMS = 132
BOOST_HZ = FP32_FLOPS / (H100_SMS * 128 * 2)
INT32_MULS = 64 * H100_SMS * BOOST_HZ
SFU_OPS = 16 * H100_SMS * BOOST_HZ
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


def _profile_kernels(fn, reps: int, attempts: int = 5) -> dict:
    """kernel name -> (launches, device microseconds) that torch.profiler
    recorded over ``reps`` calls of ``fn``. torch.profiler (2.11, CUDA
    12.8, on the H100) has returned no kernel record at all for a whole
    profiling session: rarely in the early phases, and in phase 5 for
    about every other session. Such a session is run again, up to
    ``attempts`` times; an empty result is then the caller's to handle."""
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


def events_ms(fn, reps: int = TIMING_REPS) -> float:
    """Time per call of ``reps`` calls of ``fn`` launched back to back,
    between two CUDA events: the device time where the launches keep
    ahead of the card, else the host's launch time as well."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time per call of ``fn``: each kernel's mean duration over
    ``reps`` calls (torch.profiler) times its launches a call, summed;
    without the host's launch cost that the event timing of a short call
    also holds. The profiler can drop kernel records, so a kernel's
    launches a call are its recorded launches over ``reps``, rounded, and
    its mean is taken over the records it kept. Where no profiling
    session recorded a kernel, the time is ``events_ms``'s, and a line
    says so."""
    fn()
    kernels = _profile_kernels(fn, reps)
    if not kernels:
        ms = events_ms(fn, reps)
        print(f"  (torch.profiler recorded no kernel in any session; "
              f"{ms:.4f} ms a call from CUDA events over {reps} calls back "
              f"to back)")
        assert ms > 0, "CUDA events timed no device time"
        return ms
    total_us = 0.0
    for name, (count, us) in kernels.items():
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


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS, ops=()):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over their rate: ``flops``
    at ``peak`` (float32 outside the tensor cores unless given), and each
    (count, rate) of ``ops`` (INT32_MULS, SFU_OPS), on pipes that run
    side by side; the published H100 SXM peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max([flops / peak] + [c / r for c, r in ops]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ops_text(flops, peak, ops) -> str:
    """The operation counts of a bound, each with its time."""
    parts = [f"{flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s "
             f"{flops / peak * 1e3:.4f} ms"]
    for (count, rate), name in zip(ops, ("integer multiplies",
                                         "special functions")):
        parts.append(f"{count / 1e9:.3f} G {name} {count / rate * 1e3:.4f} "
                     f"ms")
    return ", ".join(parts)


def time_kernel(name, kern, plain, library, label, nbytes, flops,
                plain_reps=TIMING_REPS, peak=FP32_FLOPS, ops=()) -> dict:
    """Times a kernel, its plain version (alternating plain, kernel,
    kernel, plain) and the library call, each by CUDA events and by device
    time; returns the record fields. ``flops`` are operations at the
    ``peak`` rate, ``ops`` other operations as ``bound`` takes them."""
    p1 = median_ms(plain, plain_reps)
    k1 = median_ms(kern)
    k2 = median_ms(kern)
    p2 = median_ms(plain, plain_reps)
    lib = None if library is None else median_ms(library)
    dk = device_ms(kern)
    dp = device_ms(plain, plain_reps)
    dl = None if library is None else device_ms(library)
    bound_ms, bound_by = bound(nbytes, flops, peak, ops)
    print(f"  time {name} {label}: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms per call (CUDA events, median); device "
          f"time per call: kernel {dk:.4f} ms, plain {dp:.4f} ms "
          f"(torch.profiler); library "
          f"{'none' if lib is None else f'{lib:.4f} ms, device {dl:.4f} ms'}"
          f"; bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
          f"{ops_text(flops, peak, ops)})")
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib,
            "device_ms": dk, "library_device_ms": dl}


def kernels_per_call(fn, reps: int = TIMING_REPS) -> int:
    """The number of device kernels one call of ``fn`` launches: the
    launches torch.profiler recorded over ``reps`` calls, over ``reps``,
    rounded."""
    fn()
    kernels = _profile_kernels(fn, reps)
    assert kernels, "torch.profiler recorded no kernel in any session"
    return round(sum(count for count, _ in kernels.values()) / reps)


# An instantiation of either fused kernel and its compiled widths, from
# the mangled name: the "thread" design's fused_step_kernel<DM, KM, T> and
# fused_cdf_kernel<DM, KM>, the "tile" design's fused_*_tile_kernel<D(, T)>
# (d = k = D exactly) and fused_*_wide_kernel<DM, KM(, T)> (padded widths).
FUSED_KERNEL = re.compile(r"(fused_(?:step|cdf)(?:_tile|_wide)?_kernel)I"
                          r"((?:Li\d+E)+)(f|13__nv_bfloat16)?")
# The instantiations the build must report: the "thread" buckets (d, k up
# to 16: 8 a kernel, the Metropolis step's in float32 and bfloat16), the
# exact tiles (16 and 32) and the padded tile widths (32, 64 and 128 with
# KM = 16 or DM), each Metropolis one in both state types.
FUSED_INSTANCES = 3 * 8 + 3 * 2 + 3 * 6
# The composed DLM step's kernels (csrc/packed_model.cu): the propagate in
# each "thread" width DM, the log-likelihood in each bucket (DM, KM).
PACKED_KERNEL = re.compile(r"(packed_(?:propagate|loglik)_kernel)I"
                           r"((?:Li\d+E)+)")
PACKED_INSTANCES = 4 + 8


def ptxas_report(log: str) -> list:
    """[(kernel entry, line)] of nvcc's -Xptxas -v output."""
    rows, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            rows.append((entry, line.strip()))
    return rows


def check_fused_frames(rows, pattern=FUSED_KERNEL) -> int:
    """Fails unless every instantiation of both fused kernels (or of the
    kernels ``pattern`` names), of both designs and in every compiled
    width, reports a 0-byte stack frame and no spill; prints each one's
    registers, stack and spills. Returns the number of instantiations."""
    seen = {}
    for entry, line in rows:
        m = pattern.search(entry)
        if not m:
            continue
        widths = tuple(int(w) for w in re.findall(r"Li(\d+)E", m.group(2)))
        elem = m.group(3) if pattern.groups > 2 else None
        key = (m.group(1), widths,
               "bf16" if elem and "bf" in elem else "f32")
        seen.setdefault(key, []).append(line)
    for key, lines in sorted(seen.items()):
        text = " ".join(lines)
        frame = re.search(r"(\d+) bytes stack frame", text)
        spills = re.findall(r"(\d+) bytes spill", text)
        regs = re.search(r"Used (\d+) registers", text)
        print(f"  {key[0]}<{', '.join(map(str, key[1]))}> {key[2]}: "
              f"{regs.group(1) if regs else '?'} registers, stack frame "
              f"{frame.group(1) if frame else '?'} bytes, spills "
              f"{'/'.join(spills) or '?'} bytes")
        assert frame and frame.group(1) == "0" and spills and \
            all(x == "0" for x in spills), \
            f"{key}: stack frame or spill in a kernel"
    return len(seen)


# The draws' two exact rewrites (csrc/philox.cuh), held on the card on
# every argument they can be given: to_uniform's mantissa form against
# float(m) * 2^-23 and cos_reduced against cosf on 2 pi u, for each of the
# 2^23 values of the low 23 bits m. A check of its own, built beside the
# library.
DRAW_IDENTITIES_CU = r"""
#include "philox.cuh"

extern "C" __global__ void draw_identities(unsigned* bad) {
  const unsigned m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (1u << 23)) return;
  const float u = cusmc::to_uniform(m);
  const float ref = fmaxf(__fmul_rn(__uint2float_rn(m), 1.0f / 8388608.0f),
                          1e-12f);
  if (__float_as_uint(u) != __float_as_uint(ref)) atomicAdd(bad, 1u);
  const float x = __fmul_rn(6.2831855f, u);
  if (__float_as_uint(cusmc::cos_reduced(x)) != __float_as_uint(cosf(x))) {
    atomicAdd(bad + 1, 1u);
  }
}

extern "C" int run_draw_identities(unsigned* bad, void* stream) {
  draw_identities<<<(1u << 23) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(bad);
  return static_cast<int>(cudaGetLastError());
}
"""


def check_draw_identities() -> None:
    """Builds DRAW_IDENTITIES_CU with nvcc and fails unless both rewrites
    are bitwise on all 2^23 arguments."""
    import ctypes

    import torch

    from cusmc_tpu_torch.ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / f"draw_identities_{os.getpid()}.cu"
    lib_path = src.with_suffix(".so")
    src.write_text(DRAW_IDENTITIES_CU)
    try:
        out = subprocess.run(
            [kernels.find_nvcc(), *kernels.ARCH_FLAGS, "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(kernels.SRC_DIR), "-o",
             str(lib_path), str(src)], capture_output=True, text=True,
            timeout=600)
        assert out.returncode == 0, f"nvcc failed:\n{out.stdout}{out.stderr}"
        lib = ctypes.CDLL(str(lib_path))
        lib.run_draw_identities.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        bad = torch.zeros(2, dtype=torch.int32, device="cuda")
        assert lib.run_draw_identities(
            bad.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        uniform_bad, cos_bad = (int(v) for v in bad.cpu())
    finally:
        src.unlink(missing_ok=True)
        lib_path.unlink(missing_ok=True)
    print(f"  draws: to_uniform's mantissa form {uniform_bad} and "
          f"cos_reduced {cos_bad} of 2^23 arguments off cosf / "
          f"float(m) * 2^-23 (bitwise)")
    assert uniform_bad == 0 and cos_bad == 0, "a draw rewrite is not exact"


def build_kernels() -> float:
    from cusmc_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.library()
    seconds = time.perf_counter() - t0
    info = kernels.build_info
    print(f"build: {seconds:.2f} s (nvcc {info.get('seconds', 0.0):.2f} s) "
          f"-> {info.get('path')}")
    rows = ptxas_report(info.get("log", ""))
    for entry, line in rows:
        print(f"  ptxas: {entry[:90]}: {line}")
    if rows:
        n = check_fused_frames(rows)
        assert n == FUSED_INSTANCES, \
            f"{n} fused instantiations compiled, expected {FUSED_INSTANCES}"
        n = check_fused_frames(rows, PACKED_KERNEL)
        assert n == PACKED_INSTANCES, \
            f"{n} packed instantiations compiled, expected {PACKED_INSTANCES}"
    else:
        print("  (a cached build: no ptxas report to check)")
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


def _rolls_case(w, X, gen, name, num_steps=10):
    """Kernel vs plain (the walk, apply and ancestors of rolls.py) on the
    same ``num_steps`` shifts and uniforms: exactly equal."""
    import torch

    from cusmc_tpu_torch.resampling.rolls import roll_metropolis_draws, \
        roll_metropolis_sweeps_expspace, \
        roll_metropolis_sweeps_expspace_plain

    n = w.shape[0]
    shifts, u = roll_metropolis_draws(gen, n, num_steps, w.device)
    y, a = roll_metropolis_sweeps_expspace(w, shifts, u, X)
    y_p, a_p = roll_metropolis_sweeps_expspace_plain(w, shifts, u, X)
    assert torch.equal(a, a_p), f"{name}: ancestors differ " \
        f"({int((a != a_p).sum())} of {n})"
    assert torch.equal(y, y_p), f"{name}: values differ"
    moved = float((a != torch.arange(n, device=w.device)).float().mean())
    print(f"  rolls {name}: N={n} B={num_steps} ancestors and values equal "
          f"(moved share {moved:.3f})")
    return shifts, u, float((y - y_p).abs().max())


# The sweep counts of num_steps="auto" below B = 10 (its ESS bucket over
# base 10: ceil(10 / 2) and ceil(10 / 4)), and the sizes they run at: the
# auto-sweep example's N and the headline's.
AUTO_SWEEPS = (5, 3)
AUTO_SWEEP_SIZES = (8192, N_BIG)


def check_roll_sweeps() -> float:
    """Phase 3 for the roll walk at the auto schedule's short sweep counts
    (B = 3 and 5) at N = 8192 and 2^20, d = 2: on exp-space, uniform and
    concentrated weights against its plain version (ancestors and values
    exactly equal), then timed beside its bound on exp-space weights.
    Returns the largest |kernel - plain|."""
    import torch

    from cusmc_tpu_torch.resampling.rolls import \
        roll_metropolis_sweeps_expspace, \
        roll_metropolis_sweeps_expspace_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    errs = []
    for n in AUTO_SWEEP_SIZES:
        X = torch.randn((D, n), generator=gen, device=dev)
        ll = -0.5 * torch.randn(n, generator=gen, device=dev) ** 2 * 50.0
        w_exp = torch.exp(ll - ll.max())
        w_conc = torch.full((n,), 1e-12, device=dev)
        w_conc[n // 3] = 1.0
        for b in AUTO_SWEEPS:
            for name, w in (("exp", w_exp),
                            ("uniform", torch.rand(n, generator=gen,
                                                   device=dev)),
                            ("concentrated", w_conc)):
                shifts, u, e = _rolls_case(w, X, gen, f"{n}/{name}", b)
                errs.append(e)
            shifts, u, _ = _rolls_case(w_exp, X, gen, f"{n}/exp", b)
            time_kernel("roll_metropolis_sweeps_expspace",
                        lambda: roll_metropolis_sweeps_expspace(
                            w_exp, shifts, u, X),
                        lambda: roll_metropolis_sweeps_expspace_plain(
                            w_exp, shifts, u, X),
                        None, f"N={n} d={D} B={b}", (8 + 4 * b + 8 * D) * n,
                        b * n)
    torch.cuda.synchronize()
    return max(errs)


# -- the roll walk at every width (phase 3) ---------------------------------

# The widths the roll walk runs at: (state type, d) for the stochastic
# volatility model and UNGM, the headline, the monthly structural DLM, the
# bfloat16 rows' middle width and the full width; bfloat16 at the mixed-
# precision rows' widths.
ROLL_WIDTHS = (("float32", 1), ("float32", 2), ("float32", 13),
               ("float32", 16), ("float32", 32), ("bfloat16", 2),
               ("bfloat16", 16), ("bfloat16", 32))
ROLL_SIZES = (N_BIG, N_BIG - 3, N_RAGGED)
ROLL_SWEEPS = (1, 3, 5, 10)
# Ancestor patterns: "identity" (w constant, u = 1: every proposal rejects,
# a = i, one aligned front), "one front" (w constant, u = 1/2: every
# proposal accepts, a = i + s_B) and "mixed" (exp-space weights and the
# drawn uniforms: the winners spread over the B + 1 fronts).
ROLL_PATTERNS = ("identity", "one front", "mixed")
# Band sizes forced beside the card's plan, (state type, d, rows a band):
# partial last bands, and the banded design where the plan runs one pass.
ROLL_SPLITS = (("float32", 13, 3), ("float32", 2, 1), ("float32", 32, 5),
               ("float32", 16, 9), ("bfloat16", 16, 3), ("bfloat16", 2, 1),
               ("bfloat16", 32, 7))
# Band sizes timed at N = 2^20, B = 10 on the mixed pattern (d itself: one
# pass), for the choice of ROLL_BAND_SHARE.
ROLL_BAND_SWEEP = {("float32", 13): (1, 2, 4, 13),
                   ("float32", 16): (1, 2, 4, 16),
                   ("float32", 32): (1, 2, 4, 8, 32),
                   ("bfloat16", 16): (2, 4, 8, 16),
                   ("bfloat16", 32): (2, 4, 8, 32)}
# Widths about the switch from one pass to bands at N = 2^20, each timed
# both ways on the mixed pattern, for the choice of ROLL_ONE_PASS_SHARE.
ROLL_SWITCH_WIDTHS = (("float32", 3), ("float32", 4), ("float32", 6),
                      ("bfloat16", 6), ("bfloat16", 8), ("bfloat16", 12))
# Cycles of the sleep kernel queued before each timed call of queued_ms:
# about 0.5 ms on the H100, longer than the host takes to queue the call.
SLEEP_CYCLES = 1_000_000


def queued_ms(fn, flush=None, reps: int = 15) -> float:
    """Median device time of one call of ``fn`` between two CUDA events,
    the call queued behind a sleep kernel so that the events time the
    card's work and not the host's launch; ``flush`` (a write through a
    buffer larger than L2) runs before the first event: a cold L2."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def roll_bytes(n, d, b, itemsize) -> int:
    """The roll walk's bytes: 4B + 2 s d + 8 a particle (csrc/rolls.cu)."""
    return (4 * b + 2 * itemsize * d + 8) * n


def roll_pattern(pattern, n, b, gen, dev):
    """(w, shifts, u) of an ancestor pattern of ROLL_PATTERNS."""
    import torch

    from cusmc_tpu_torch.resampling.rolls import roll_metropolis_draws

    shifts, u = roll_metropolis_draws(gen, n, b, dev)
    if pattern == "mixed":
        ll = -0.5 * torch.randn(n, generator=gen, device=dev) ** 2 * 50.0
        return torch.exp(ll - ll.max()), shifts, u
    w = torch.ones(n, device=dev)
    return w, shifts, torch.full_like(u, 1.0 if pattern == "identity"
                                      else 0.5)


def _roll_exact(name, fn, w, shifts, u, X, pattern, others=()):
    """``fn(w, shifts, u, X)`` against the plain version (and each other
    tree's kernel): ancestors and values exactly equal, the pattern's
    ancestors where it fixes them, one launch counted a call."""
    import torch

    from cusmc_tpu_torch.resampling.rolls import \
        roll_metropolis_sweeps_expspace, \
        roll_metropolis_sweeps_expspace_plain

    attr = "bf16_launches" if X.dtype == torch.bfloat16 else "launches"
    before = getattr(roll_metropolis_sweeps_expspace, attr)
    y, a = fn(w, shifts, u, X)
    assert getattr(roll_metropolis_sweeps_expspace, attr) == before + 1, \
        f"{name}: launches"
    y_p, a_p = roll_metropolis_sweeps_expspace_plain(w, shifts, u, X)
    n = w.numel()
    assert torch.equal(a, a_p), \
        f"{name}: ancestors differ ({int((a != a_p).sum())} of {n})"
    assert y.dtype == X.dtype and torch.equal(y, y_p), \
        f"{name}: values differ"
    i = torch.arange(n, device=w.device)
    if pattern == "identity":
        assert torch.equal(a.long(), i), f"{name}: not the identity"
    elif pattern == "one front":
        assert torch.equal(a.long(), (i + int(shifts[-1])) % n), \
            f"{name}: not the last shift"
    for root, fns in others:
        y_o, a_o = fns["roll_metropolis_sweeps_expspace"](w, shifts, u, X)
        assert torch.equal(a_o, a) and torch.equal(y_o, y), \
            f"{name}: {root}'s kernel differs"


def check_roll_widths(others) -> None:
    """Phase 3 for the roll walk at every width the paths give it
    (ROLL_WIDTHS) and at N = 2^20, 2^20 - 3 and 1000003, B = 1, 3, 5 and
    10, on the three ancestor patterns: the kernel as the card's plan runs
    it (one pass or banded, ``roll_band_rows``) and at the forced band
    sizes of ROLL_SPLITS, ancestors and values exactly the plain
    version's (and each ``others`` tree's kernel's). Then at N = 2^20,
    B = 10 each width and pattern timed (``queued_ms``, L2 warm and cold)
    beside its bound and each other tree's kernel (in turns: other, this,
    this, other), the band sizes of ROLL_BAND_SWEEP, one pass against
    bands at ROLL_SWITCH_WIDTHS, and the walk alone."""
    import torch

    from cusmc_tpu_torch.resampling.rolls import ROLL_BAND_SHARE, \
        ROLL_ONE_PASS_SHARE, l2_bytes, roll_band_rows, \
        roll_metropolis_sweeps_expspace, roll_metropolis_sweeps_in_bands, \
        roll_path

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9753)
    l2 = l2_bytes(dev)
    print(f"  L2 {l2} bytes; one pass while X fits {ROLL_ONE_PASS_SHARE:.4f}"
          f" of it, else bands of {ROLL_BAND_SHARE:.4f} of it")
    types = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = 0
    for n in ROLL_SIZES:
        states = {}
        for kind, d in ROLL_WIDTHS:
            states[kind, d] = torch.randn((d, n), generator=gen,
                                          device=dev).to(types[kind])
        for b in ROLL_SWEEPS:
            for pattern in ROLL_PATTERNS:
                w, shifts, u = roll_pattern(pattern, n, b, gen, dev)
                for (kind, d), X in states.items():
                    _roll_exact(f"rolls N={n} d={d} {kind} B={b} {pattern}",
                                roll_metropolis_sweeps_expspace, w, shifts,
                                u, X, pattern, others)
                    cases += 1
                for kind, d, rows in ROLL_SPLITS:
                    _roll_exact(
                        f"rolls N={n} d={d} {kind} B={b} {pattern} "
                        f"{rows} rows a band",
                        lambda *a, rows=rows:
                            roll_metropolis_sweeps_in_bands(*a, rows),
                        w, shifts, u, states[kind, d], pattern)
                    cases += 1
        plans = ", ".join(
            f"d={d} {kind} {roll_path(r, d)} ({r} rows a band)"
            for (kind, d), X in states.items()
            for r in (roll_band_rows(n, d, X.element_size(), l2),))
        print(f"  rolls N={n}: the plan {plans}")
        del states
    print(f"  rolls: {cases} cases (widths {len(ROLL_WIDTHS)}, forced "
          f"splits {len(ROLL_SPLITS)}, B in {ROLL_SWEEPS}, patterns "
          f"{len(ROLL_PATTERNS)}, N in {ROLL_SIZES}), ancestors and values "
          f"exactly the plain version's"
          + (f" and {len(others)} other trees' kernels'" if others else ""))

    n, b = N_BIG, 10
    flush_buf = torch.empty(l2 // 2, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.fill_(1.0)

    def timed(label, args):
        X = args[3]
        nbytes = roll_bytes(n, X.shape[0], b, X.element_size())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        line = f"  time rolls {label}: bound {t_bytes:.4f} ms (bytes, " \
               f"{nbytes / 1e6:.1f} MB)"

        def mine_fn():
            return roll_metropolis_sweeps_expspace(*args)
        for temp, fl in (("warm", None), ("cold", flush)):
            mine, parts = [], []
            for root, fns in others:
                def theirs(fns=fns):
                    return fns["roll_metropolis_sweeps_expspace"](*args)
                t = [queued_ms(theirs, fl), queued_ms(mine_fn, fl),
                     queued_ms(mine_fn, fl), queued_ms(theirs, fl)]
                mine += t[1:3]
                parts.append(f", {root} {t[0]:.4f}/{t[3]:.4f} ms (share "
                             f"{t_bytes / min(t[0], t[3]):.3f})")
            if not others:
                mine = [queued_ms(mine_fn, fl), queued_ms(mine_fn, fl)]
            line += (f"; {temp}: this tree "
                     + "/".join(f"{t:.4f}" for t in mine)
                     + f" ms (share of bound {t_bytes / min(mine):.3f})"
                     + "".join(parts))
        print(line)

    for (kind, d) in ROLL_WIDTHS:
        X = torch.randn((d, n), generator=gen, device=dev).to(types[kind])
        rows = roll_band_rows(n, d, X.element_size(), l2)
        for pattern in ROLL_PATTERNS:
            w, shifts, u = roll_pattern(pattern, n, b, gen, dev)
            timed(f"N=2^20 d={d} {kind} B={b} {pattern} "
                  f"[{roll_path(rows, d)}, {rows} rows a band]",
                  (w, shifts, u, X))
        for rows in ROLL_BAND_SWEEP.get((kind, d), ()):
            def banded(rows=rows, args=(w, shifts, u, X)):
                return roll_metropolis_sweeps_in_bands(*args, rows)
            print(f"  time rolls N=2^20 d={d} {kind} B={b} mixed, {rows} rows "
                  f"a band [{roll_path(rows, d)}]: warm "
                  f"{queued_ms(banded):.4f} ms, cold "
                  f"{queued_ms(banded, flush):.4f} ms")
        del X
    for kind, d in ROLL_SWITCH_WIDTHS:
        X = torch.randn((d, n), generator=gen, device=dev).to(types[kind])
        plan = roll_band_rows(n, d, X.element_size(), l2)
        fit = max(1, int(ROLL_BAND_SHARE * l2) // (n * X.element_size()))
        mb = X.numel() * X.element_size() / 1e6
        line = (f"  time rolls N=2^20 d={d} {kind} B={b} mixed ({mb:.1f} MB; "
                f"the plan: {roll_path(plan, d)}")
        for rows in (d, min(fit, d - 1)):
            def fn(rows=rows, args=(w, shifts, u, X)):
                return roll_metropolis_sweeps_in_bands(*args, rows)
            line += f"; {roll_path(rows, d)} ({rows} rows a band) warm " \
                    f"{queued_ms(fn):.4f} ms, cold {queued_ms(fn, flush):.4f} ms"
        print(line + ")")
        del X
    X0 = torch.empty((0, n), device=dev)
    walk = queued_ms(lambda: roll_metropolis_sweeps_expspace(w, shifts, u,
                                                             X0))
    print(f"  time rolls N=2^20 B={b} the walk alone (d=0): {walk:.4f} ms, "
          f"bound {roll_bytes(n, 0, b, 4) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    torch.cuda.synchronize()


# The fused kernels at the widths the paths give them, and about their
# buckets: (kernel, d, k, noise, state type or cdf mode). The "thread"
# design at d = 2 (float32 and bfloat16; the headline), 4, 5, 8 and the
# monthly structural DLM's d = 13, k = 1; the "tile" design at d = k = 16
# and 32, whose times a change of the shared walk must keep; and the
# widths past 16 (the README's d >= 64 pallas regime; ``shape_model`` for
# k != d): d = k = 24, 40, 64 and 128, d = 32 and 64 with k = 1, and
# d = 2 with k = 64, the Metropolis step MVN and MVT (bfloat16 at 64 and
# 128), the CDF step at 64 and 128.
WIDE_SHAPES = ((24, 24), (32, 1), (40, 40), (64, 1), (64, 64), (128, 128),
               (2, 64))
FUSED_WIDTHS = tuple(
    [("step", d, d, noise, dtype) for d, dtype in
     ((2, "float32"), (2, "bfloat16"), (4, "float32"), (5, "float32"),
      (8, "float32")) for noise in ("mvn", "mvt")]
    + [("step", 13, 1, noise, "float32") for noise in ("mvn", "mvt")]
    + [("cdf", 2, 2, "mvt", mode) for mode in ("systematic", "stratified")]
    + [("cdf", 13, 1, noise, mode) for noise in ("mvn", "mvt")
       for mode in ("systematic", "stratified")]
    + [("step", d, d, "mvt", dtype) for d in (16, 32)
       for dtype in ("float32", "bfloat16")]
    + [("cdf", d, d, "mvt", "systematic") for d in (16, 32)]
    + [("step", d, k, noise, "float32") for d, k in WIDE_SHAPES
       for noise in ("mvn", "mvt")]
    + [("step", d, d, noise, "bfloat16") for d in (64, 128)
       for noise in ("mvn", "mvt")]
    + [("cdf", d, d, noise, "systematic") for d in (64, 128)
       for noise in ("mvn", "mvt")])


def shape_model(d, k, noise, dev):
    """A DLM of state width d and observation width k != d, made from a
    seed: the demo model's G (a slow rotation, 0.999), a dense F [k, d] of
    scale 0.3, V = 0.01 I, W = 0.001 I, m0 = 0, C0 = I; MVT with df=5."""
    import numpy as np

    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM

    rng = np.random.default_rng(100 * d + k)
    return DLM.create(F=0.3 * rng.standard_normal((k, d)),
                      G=demo_model_params(d)["G"], m0=np.zeros(d),
                      C0=np.eye(d), V=0.01 * np.eye(k), W=0.001 * np.eye(d),
                      noise=noise, df=5.0 if noise == "mvt" else None,
                      device=dev)


def width_model(d, k, noise, dev):
    """The model FUSED_WIDTHS runs at (d, k): the demo model (F = I) for
    k = d, the monthly structural DLM for d = 13, k = 1, else
    ``shape_model``."""
    if k == d:
        return _fused_model(d, noise, dev)[0]
    if (d, k) == (D_MONTHLY, 1):
        return monthly_model(dev, noise)
    return shape_model(d, k, noise, dev)


def _same_outputs(label, mine, theirs, root) -> str:
    """Another tree's (X_new, ll, ancestors) against this tree's:
    ancestors bitwise equal, states and ll bitwise or within 1e-4 (then
    the mismatches are counted); a bfloat16 state's states bitwise, one
    ulp apart (two roundings of the same float32 sum, as
    ``bf16_state_mismatches`` holds each tree to the plain version) or
    within 1e-4, and ll within 1e-4 where they agree. Returns a short
    verdict."""
    import torch

    (x, ll, a), (x_o, ll_o, a_o) = mine, theirs
    assert torch.equal(a, a_o), f"{label}: {root}'s ancestors differ"
    if torch.equal(x, x_o) and torch.equal(ll, ll_o):
        return "bitwise"
    keep = torch.ones_like(ll, dtype=torch.bool)
    if x.dtype == torch.bfloat16:
        ulps = (x.view(torch.int16).int() - x_o.view(torch.int16).int()).abs()
        near = (x.float() - x_o.float()).abs() <= 1e-4
        assert bool(((ulps <= 1) | near).all()), \
            f"{label}: {root}'s states > 1 ulp and 1e-4 off"
        keep = (ulps == 0).all(0)
    else:
        torch.testing.assert_close(x_o, x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ll_o[keep], ll[keep], rtol=1e-4, atol=1e-4)
    nx = int((x != x_o).sum())
    nl = int((ll != ll_o).sum())
    gap = max(float((x.float() - x_o.float()).abs().max()),
              float((ll[keep] - ll_o[keep]).abs().max()))
    return f"{nx} states and {nl} ll differ, max {gap:.2e}"


def check_fused_widths(others, timed=()) -> None:
    """The fused kernels at FUSED_WIDTHS, N = 2^20, B = 10: each held to
    its plain version as phase 3 holds it (``_fused_step_case``,
    ``_fused_step_case_bf16``, ``_fused_cdf_case``; the design and bucket
    printed) and to each ``others`` tree's kernel on the same inputs and
    draws (ancestors bitwise, states and ll bitwise or within 1e-4, the
    mismatches counted), then timed with L2 warm and cold (``queued_ms``)
    beside each other tree's, in turns (other, this, this, other), beside
    the bound of ``fused_bound`` and the operation that sets it. The trees
    of ``timed`` (variants that drop part of the work, to split the time)
    are timed the same way and held to nothing."""
    import torch

    from cusmc_tpu_torch.ops.fused_cdf_step import fused_cdf_filter_step
    from cusmc_tpu_torch.ops.fused_step import fused_filter_step, step_path
    from cusmc_tpu_torch.resampling.rolls import l2_bytes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    n = N_BIG
    flush_buf = torch.empty(l2_bytes(dev) // 2, dtype=torch.float32,
                            device=dev)

    def flush():
        flush_buf.fill_(1.0)

    for kind, d, k, noise, variant in FUSED_WIDTHS:
        model = width_model(d, k, noise, dev)
        if kind == "step" and variant == "bfloat16":
            _, args, kw = _fused_step_case_bf16(n, d, noise, gen, dev)
        elif kind == "step":
            _, args, kw = _fused_step_case(n, d, noise, gen, dev, model)
        else:
            _, args, kw = _fused_cdf_case(n, d, variant, gen, dev, model)
        if kind == "step":
            def mine_fn(args=args, kw=kw):
                return fused_filter_step(*args, **kw)
            key = "fused_step_outputs"
        else:
            def mine_fn(args=args, kw=kw):
                return fused_cdf_filter_step(*args, **kw)
            key = "fused_cdf_outputs"
        itemsize = 2 if variant == "bfloat16" else 4
        label = (f"fused_{kind} N=2^20 d={d} k={k} {noise} {variant} "
                 f"[{path_text(d, k)}]")
        mine = mine_fn()
        verdicts = [
            f"{root} {_same_outputs(label, mine, fns[key](args, kw), root)}"
            for root, fns in others]
        nbytes, flops, peak, ops = fused_bound(
            kind, d, k, n, noise=noise, df_int=kw.get("df_int"),
            itemsize=itemsize, design=step_path(d, k))
        t_bound, by = bound(nbytes, flops, peak, ops)
        line = (f"  time {label}: bound {t_bound:.4f} ms ({by}: "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms of bytes, "
                f"{ops_text(flops, peak, ops)})")
        if step_path(d, k) == "tile":
            padded = padded_flops(d, k, n, itemsize)
            line += (f"; the padded tiles issue {padded / 1e9:.2f} GFLOP, "
                     f"{padded / TF32_FLOPS * 1e3:.4f} ms at "
                     f"{TF32_FLOPS / 1e12:.0f} TFLOP/s")
        if verdicts:
            line += "; against this tree: " + ", ".join(verdicts)
        for temp, fl in (("warm", None), ("cold", flush)):
            times, parts = [], []
            for root, fns in list(others) + list(timed):
                def theirs(fns=fns, args=args, kw=kw):
                    return fns[key](args, kw)
                t = [queued_ms(theirs, fl), queued_ms(mine_fn, fl),
                     queued_ms(mine_fn, fl), queued_ms(theirs, fl)]
                times += t[1:3]
                parts.append(f", {root} {t[0]:.4f}/{t[3]:.4f} ms (share "
                             f"{t_bound / min(t[0], t[3]):.3f})")
            if not others and not timed:
                times = [queued_ms(mine_fn, fl), queued_ms(mine_fn, fl)]
            line += (f"; {temp}: this tree "
                     + "/".join(f"{t:.4f}" for t in times)
                     + f" ms (share of bound {t_bound / min(times):.3f})"
                     + "".join(parts))
        print(line)
    torch.cuda.synchronize()


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

def path_text(d, k) -> str:
    """The fused kernels' design at (d, k) and its compiled widths."""
    from cusmc_tpu_torch.ops import fused_step

    dm, km = fused_step.step_widths(d, k)
    if fused_step.step_path(d, k) == "thread":
        return f"thread, bucket ({dm}, {km})"
    if d == k and d in fused_step.TILE_DIMS:
        return "tile"
    return f"tile, padded ({dm}, {km})"


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
             f"path={path_text(d, k)}")
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
        f"path={path_text(d, k)}"
    err, nbad = _compare(label, a, a_p, (x, ll), (x_p, ll_p), ties)
    print(f"  {label}: ancestors {'equal' if not nbad else 'equal but ties'}"
          f", max|kernel-plain| {err:.3e} (states, ll), distinct ancestors "
          f"{int(torch.unique(a).numel())}")
    return err, args, kw


def check_fused_kernels() -> dict:
    """Phase 3 for the two fused steps at d = 2, 16, 32 and the padded
    "tile" widths' d = 64 and 128 (FUSED_PAD_DIMS). Records at the
    headline shape: N = 2^20, d = 2, MVT df=5 (metropolis B=10;
    systematic)."""
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
    for d in (D, D_MID, D_WIDE) + FUSED_PAD_DIMS:
        for noise in ("mvn", "mvt"):
            err, args, kw = _fused_step_case(N_BIG, d, noise, gen, dev)
            step_errs.append(err)
            if noise == "mvt":
                step_cases[d] = (args, kw)
    cdf_errs, cdf_cases = [], {}
    for n in (N_BIG, N_RAGGED_CDF):
        for d in (D, D_MID, D_WIDE) + FUSED_PAD_DIMS:
            for mode in ("systematic", "stratified"):
                err, args, kw = _fused_cdf_case(n, d, mode, gen, dev)
                cdf_errs.append(err)
                if n == N_BIG and mode == "systematic":
                    cdf_cases[d] = (args, kw)
    # d = 2 last: its numbers are recorded
    for d in FUSED_PAD_DIMS[::-1] + (D_WIDE, D_MID, D):
        design = step_path(d, d)
        nbytes, flops, peak, ops = fused_bound("step", d, d, N_BIG,
                                               design=design)
        args, kw = step_cases[d]
        rec["fused_filter_step"] = dict(max_abs_err=max(step_errs),
                                        **time_kernel(
            "fused_filter_step", lambda: fused_filter_step(*args, **kw),
            lambda: fused_filter_step_plain(*args, **kw), None,
            f"N=2^20 d={d} MVT df=5 B=10 tile={kw['tile']} "
            f"path={path_text(d, d)}", nbytes, flops, PLAIN_FUSED_REPS, peak,
            ops))
        nbytes, flops, peak, ops = fused_bound("cdf", d, d, N_BIG,
                                               design=design)
        cargs, ckw = cdf_cases[d]
        rec["fused_cdf_filter_step"] = dict(max_abs_err=max(cdf_errs),
                                            **time_kernel(
            "fused_cdf_filter_step",
            lambda: fused_cdf_filter_step(*cargs, **ckw),
            lambda: fused_cdf_filter_step_plain(*cargs, **ckw), None,
            f"N=2^20 d={d} MVT df=5 systematic tile={ckw['tile']} "
            f"path={path_text(d, d)}", nbytes, flops, PLAIN_FUSED_REPS, peak,
            ops))
    torch.cuda.synchronize()
    return rec


# -- the kernels at the widths of the other models (phase 4g) -------------

# The stochastic volatility model and UNGM run the packed fast step on a
# state of one row; the monthly structural DLM (a local linear trend and a
# 12-period seasonal) is d = 13 with k = 1, which takes both fused kernels'
# "thread" design in its (16, 1) width bucket.
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


def fused_bound(kind, d, k, n, *, num_sweeps=10, noise="mvt", df_int=5,
                itemsize=4, design="thread"):
    """``(bytes, flops, peak, ops)`` of one fused step ("step": the
    Metropolis step at ``num_sweeps``; "cdf": the inverse-CDF step) at
    state width d and observation width k, as ``bound`` takes them and as
    PERF.md's table counts them per particle. Bytes: X[:, a] read and the
    new state written (``itemsize``-byte states), ll and the ancestor
    written, and one log weight or cdf entry read (the B further
    candidates of the window come from L2). Integer multiplies: 40 a
    Philox call (10 rounds of two 32 x 32 -> 64 products, both halves),
    one call a group of four of the particle's rows. Special functions:
    an exp a walk candidate (B + 1), a log, a sqrt and a cos a normal,
    and for MVT the chi-square's log, the sqrt of df / g, the two
    divisions and the log1p (integer df; a Marsaglia-Tsang round adds a
    normal and two logs). Flops: the four products, 2 (2 d^2 + k d + k^2)
    in float32, or on the tensor cores in the "tile" design (3xTF32 in
    float32; in bfloat16 G, Q and F in one bf16 pass, Li in 3xTF32), at
    the unpadded widths: the least work (``padded_flops`` counts what the
    padded tiles issue)."""
    from cusmc_tpu_torch.ops.fused_step import chi2_rows

    rows = (num_sweeps if kind == "step" else 1) + 2 * d \
        + chi2_rows(noise, df_int)
    sfu = 3 * d + (num_sweeps + 1 if kind == "step" else 0)
    if noise == "mvt":
        sfu += 4 * 5 + 6 if df_int is None else \
            int(df_int // 2 > 0) + 3 * (df_int % 2) + 4
    ops = ((40.0 * -(-rows // 4) * n, INT32_MULS), (float(sfu) * n, SFU_OPS))
    model = 2.0 * (2 * d * d + k * d) * n  # G, Q and F
    li = 2.0 * k * k * n
    flops, peak = model + li, FP32_FLOPS
    if design == "tile":
        flops = 3 * (model + li) if itemsize == 4 else \
            model * TF32_FLOPS / BF16_FLOPS + 3 * li
        peak = TF32_FLOPS
    return (2 * itemsize * d + 12) * n, flops, peak, ops


def padded_flops(d, k, n, itemsize=4) -> float:
    """The tensor-core flops the "tile" design issues at (d, k): its four
    products at the compiled widths (DM, KM) of ``step_widths``, three
    TF32 passes each, but one for G, Q and F on a bfloat16 state (their
    values exact in TF32)."""
    from cusmc_tpu_torch.ops.fused_step import step_widths

    dm, km = step_widths(d, k)
    model = 2.0 * (2 * dm * dm + km * dm) * n
    return (3 if itemsize == 4 else 1) * model + 3 * 2.0 * km * km * n


def check_model_kernels() -> dict:
    """Phase 3 at the widths phases 4g and 4i give the existing kernels:
    the search-and-apply and the roll walk at d = 1 and d = 13 (N = 2^20,
    on exp-space and concentrated weights); the cumsum and the
    search-and-apply at PMMH's N = 2^16, d = 1 (phase 4i), on the weight
    kinds of ``check_kernels``; and both fused kernels on the monthly
    structural DLM (d = 13, k = 1; the Metropolis step MVN and MVT df=5,
    the CDF step systematic and stratified, MVN and MVT df=5), each
    against its plain version as the rest of phase 3 holds them, then
    timed beside its bound. Returns the cumsum's and the
    search-and-apply's largest |kernel - plain| at PMMH's width."""
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
    errs = pmmh_width_kernels(gen, dev)
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
    for noise in ("mvn", "mvt"):
        df_int = cases["step", noise][1]["df_int"]
        nbytes, flops, peak, ops = fused_bound("step", d, k, n, noise=noise,
                                               df_int=df_int)
        args, kw = cases["step", noise]
        time_kernel("fused_filter_step",
                    lambda: fused_filter_step(*args, **kw),
                    lambda: fused_filter_step_plain(*args, **kw), None,
                    f"N=2^20 d={d} k={k} {noise} B=10 tile={kw['tile']} "
                    f"path={path_text(d, k)}", nbytes, flops,
                    PLAIN_FUSED_REPS, peak, ops)
        nbytes, flops, peak, ops = fused_bound("cdf", d, k, n, noise=noise,
                                               df_int=df_int)
        args, kw = cases["cdf", noise, "systematic"]
        time_kernel("fused_cdf_filter_step",
                    lambda: fused_cdf_filter_step(*args, **kw),
                    lambda: fused_cdf_filter_step_plain(*args, **kw), None,
                    f"N=2^20 d={d} k={k} {noise} systematic "
                    f"tile={kw['tile']} path={path_text(d, k)}", nbytes,
                    flops, PLAIN_FUSED_REPS, peak, ops)
    torch.cuda.synchronize()
    return errs


# The composed DLM step's kernels (ops/packed_model.py) at the widths and
# particle counts of the benchmark's composed cells, and at N = 2^20.
PACKED_CASES = (("demo d=2, k=2, MVT df=5", "demo", (N_BIG, 1 << 23)),
                ("monthly d=13, k=1, MVN", "monthly", (N_BIG, 1 << 22)))


def check_packed_kernels() -> dict:
    """Phase 3 for the composed DLM step's two kernels: each against its
    plain version (the composed expressions: cuBLAS products and the
    elementwise chain around them, which the kernels replace) on the same
    draws at rtol 1e-4, atol 1e-4 (FMA chains against cuBLAS's order),
    then timed beside it, beside the cuBLAS products alone (the library
    column) and beside its bytes' bound, at every size of PACKED_CASES.
    Returns the records at N = 2^20, d = 2, with the other sizes under
    "sizes"."""
    import torch

    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.ops import packed_model as pm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    rec = {}
    for title, kind, sizes in PACKED_CASES:
        m = (DLM.create(noise="mvt", df=5.0, device=dev,
                        **demo_model_params())
             if kind == "demo" else monthly_model(dev))
        d, k = m.state_dim, m.obs_dim
        chi_rows = (0 if m.noise != "mvt" else
                    1 if m.df_int is None else m.df_int // 2 + m.df_int % 2)
        for n in sizes:
            X = torch.randn((d, n), generator=gen, device=dev)
            draws = m.packed_noise(gen, n)
            y = 0.1 * torch.randn((k,), generator=gen, device=dev)
            assert m.runs_kernels(X)
            x_new = pm.packed_propagate(m, X, draws)
            ll = pm.packed_loglik(m, y, x_new)
            errs = {}
            for name, got, want in (
                    ("packed_propagate", x_new,
                     pm.packed_propagate_plain(m, X, draws)),
                    ("packed_loglik", ll,
                     pm.packed_loglik_plain(m, y, x_new))):
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
                errs[name] = float((got - want).abs().max())
            label = f"{title} N=2^{n.bit_length() - 1}"
            print(f"  {label}: max |kernel - plain| propagate "
                  f"{errs['packed_propagate']:.3g}, log-likelihood "
                  f"{errs['packed_loglik']:.3g}")
            z = draws[0]
            rows = {
                "packed_propagate": time_kernel(
                    "packed_propagate",
                    lambda: pm.packed_propagate(m, X, draws),
                    lambda: pm.packed_propagate_plain(m, X, draws),
                    lambda: (torch.matmul(m.G_f32, X),
                             torch.matmul(m.W_sqrt_f32, z)),
                    label + " (library: the two cuBLAS products alone)",
                    4 * n * (3 * d + chi_rows), 4 * d * d * n),
                "packed_loglik": time_kernel(
                    "packed_loglik", lambda: pm.packed_loglik(m, y, x_new),
                    lambda: pm.packed_loglik_plain(m, y, x_new),
                    lambda: torch.matmul(m.V_chol_inv,
                                         torch.matmul(m.F_f32, x_new)),
                    label + " (library: the two cuBLAS products alone)",
                    4 * n * (d + 1), 2 * k * (d + k) * n)}
            for name, row in rows.items():
                share = row["bound_ms"] / row["device_ms"]
                print(f"  {name} {label}: {share:.1%} of its bound (device "
                      f"time), plain / kernel "
                      f"{row['plain_ms'] / row['ms']:.2f}x (events)")
                row["max_abs_err"] = errs[name]
                if kind == "demo" and n == N_BIG:
                    rec[name] = dict(row, sizes={})
                else:
                    rec[name]["sizes"][label] = row
    torch.cuda.synchronize()
    return rec


def pmmh_width_kernels(gen, dev) -> dict:
    """The cumsum and the search-and-apply at PMMH's N = PMMH_N, d = 1
    (phase 4i), on the weight kinds of ``check_kernels`` (exp-space,
    uniform, concentrated, zero runs; the cumsum also on adversarial
    weights), each held to its plain version as ``_cumsum_case`` and
    ``_search_case`` hold them, then timed beside its bound on exp-space
    weights. Returns name -> the largest |kernel - plain|."""
    import torch

    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum, \
        blocked_cumsum_plain
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_apply_plain

    n, d = PMMH_N, D_ONE
    ll = -0.5 * torch.randn(n, generator=gen, device=dev) ** 2 * 50.0
    w_exp = torch.exp(ll - ll.max())
    w_conc = torch.full((n,), 1e-12, device=dev)
    w_conc[n // 3] = 1.0
    sharp = torch.softmax(3.0 * torch.randn(n, generator=gen, device=dev), 0)
    kinds = (("exp", w_exp), ("uniform", torch.rand(n, generator=gen,
                                                    device=dev)),
             ("concentrated", w_conc), ("zero-runs", torch.floor(n * sharp)))
    X = torch.randn((d, n), generator=gen, device=dev)
    errs = [_cumsum_case(w, f"2^16/{name}") for name, w in
            kinds + (("adversarial", _adversarial_weights(gen, n, dev)),)]
    serrs = [_search_case(blocked_cumsum(w)[0], X, f"2^16/{name}")
             for name, w in kinds]
    cdf, _ = blocked_cumsum(w_exp)
    pos = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) / n \
        * cdf[-1]
    label = f"N=2^16 d={d} (PMMH's width)"
    time_kernel("blocked_cumsum", lambda: blocked_cumsum(w_exp),
                lambda: blocked_cumsum_plain(w_exp),
                lambda: torch.cumsum(w_exp, 0), label, 8 * n, n)
    time_kernel("inverse_cdf_apply", lambda: inverse_cdf_apply(cdf, pos, X),
                lambda: inverse_cdf_apply_plain(cdf, pos, X),
                lambda: X.index_select(1, torch.searchsorted(
                    cdf, pos, right=True)),
                label + " (library: searchsorted + index_select)",
                (12 + 8 * d) * n, 0)
    return {"blocked_cumsum": max(errs), "inverse_cdf_apply": max(serrs)}


# -- the bfloat16 (mixed-precision) state ---------------------------------

# A bfloat16 state the fused kernel stores may sit one bfloat16 ulp from
# its plain version's where the two round a float32 sum that lies on the
# boundary between two bfloat16 values: the kernel sums its products in
# FMA chains or, in the "tile" design, on the tensor cores, whose float32
# accumulation may differ from a sequential sum by a few ulps. Such a
# mismatch passes when the plain version's float32 value before rounding
# lies within this relative distance of that boundary.
BF16_BOUNDARY_RTOL = 1e-5
# Where G x_a and (Q z) s nearly cancel, those few float32 ulps of the
# terms are many bfloat16 ulps of their sum, or one far from a boundary
# (seen in 2^26 states of the demo model at d = 64: G x_a -0.0743, x_new
# 1.5e-7, 8 ulps apart; one ulp with the plain value 9.1e-5 off the
# boundary). Any other mismatch passes only there: the kernel's state
# within half a bfloat16 ulp of itself plus this many float32 ulps of the
# terms |G| |x_a| + |(Q z) s| from the plain value before rounding.
BF16_CANCEL_ULPS = 4


def bf16_state_mismatches(x, x_plain, x_pre, rtol=BF16_BOUNDARY_RTOL,
                          terms=None):
    """The mask of bfloat16 states that differ from the plain version's;
    each must be one ulp off with the plain float32 value before rounding
    (``x_pre``) within ``rtol`` of the boundary between the two, or, given
    ``terms`` (``terms(rows, cols)``: the float64 magnitude |G| |x_a| +
    |(Q z) s| of those entries' sums), off where its sum cancels
    (BF16_CANCEL_ULPS). Returns ``(mask, largest relative distance of a
    boundary mismatch to its boundary)``."""
    import torch

    diff = x != x_plain
    if not bool(diff.any()):
        return diff, 0.0
    rows, cols = diff.nonzero(as_tuple=True)
    xk, xp = x[rows, cols], x_plain[rows, cols]
    ulps = (xk.view(torch.int16).int() - xp.view(torch.int16).int()).abs()
    mid = (xk.float() + xp.float()) / 2
    dist = (x_pre[rows, cols] - mid).abs() / mid.abs()
    boundary = (ulps == 1) & (dist <= rtol)
    rest = ~boundary
    if bool(rest.any()):
        if terms is None:
            assert int(ulps.max()) == 1, "a state is > 1 ulp off"
            raise AssertionError(f"a 1-ulp mismatch "
                                 f"{float(dist[rest].max()):.3e} off its "
                                 f"boundary")
        pre = x_pre[rows[rest], cols[rest]].double()
        gap = (xk[rest].double() - pre).abs()
        limit = 2.0 ** -8 * xk[rest].double().abs() + BF16_CANCEL_ULPS * \
            2.0 ** -24 * terms(rows[rest], cols[rest])
        assert bool((gap <= limit).all()), \
            "a state is off its plain value where its sum does not cancel"
    return diff, float(dist[boundary].max()) if bool(boundary.any()) else 0.0


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
             f"path={path_text(d, d)}")
    bad = (a != a_p).nonzero().flatten()
    assert bad.numel() <= 1000, f"{label}: {bad.numel()} ancestors differ"
    ties(bad)
    keep = a == a_p
    a_keep, pre_keep = a[keep].long(), x_pre[:, keep]

    def terms(rows, cols):
        xa = X[:, a_keep[cols]].double().T          # [m, d]
        g = G.double()[rows]                         # [m, d]
        gx = (g * xa).sum(1)
        return (g.abs() * xa.abs()).sum(1) + \
            (pre_keep[rows, cols].double() - gx).abs()

    diff, dist = bf16_state_mismatches(x[:, keep], x_p[:, keep], pre_keep,
                                       terms=terms)
    same = diff.logical_not().all(0)
    torch.testing.assert_close(ll[keep][same], ll_p[keep][same], rtol=1e-4,
                               atol=1e-4)
    err = float((ll[keep][same] - ll_p[keep][same]).abs().max())
    print(f"  {label}: ancestors equal{' but ties' if bad.numel() else ''}"
          f" and the float32 kernel's; states bitwise but "
          f"{int(diff.sum())} of {x[:, keep].numel()}, one ulp off at a "
          f"boundary (largest distance {dist:.2e}, limit "
          f"{BF16_BOUNDARY_RTOL}) or where G x_a and (Q z) s cancel; "
          f"max|ll kernel-plain| {err:.3e}")
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
        nbytes, flops, peak, ops = fused_bound(
            "step", d, d, n, itemsize=2, design=step_path(d, d))
        rec["fused_filter_step[bf16]"] = dict(max_abs_err=err, **time_kernel(
            "fused_filter_step[bf16]", lambda: fused_filter_step(*args, **kw),
            lambda: fused_filter_step_plain(*args, **kw), None,
            f"N=2^20 d={d} MVT df=5 B=10 bf16 tile={kw['tile']} "
            f"path={path_text(d, d)}", nbytes, flops, PLAIN_FUSED_REPS, peak,
            ops))
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
# At d = 64 the same rule on oracle_logz(64, 2**16, range(8), "cpu"):
# biases 189.2-206.1 nats below Kalman, sds 15.0-39.3 (PERF.md section 6,
# PR 16).
ORACLE_BANDS = {D_MID: (10.7, 3.7, 1.9), D_WIDE: (46.1, 12.0, 6.0),
                D_PAD: (363.3, 78.6, 39.3)}
# The same check on a bfloat16 state (LOGZ_PATHS_BF16), sized the same way
# from oracle_logz(d, 2**16, range(8), "cpu", state_dtype=torch.bfloat16)
# before any card run read them (PERF.md section 6; d = 64: biases
# 184.6-204.0, sds 6.3-26.5, PR 16).
ORACLE_BANDS_BF16 = {D_MID: (15.1, 4.6, 2.3), D_WIDE: (47.2, 12.3, 6.2),
                     D_PAD: (310.0, 53.0, 26.5)}
ORACLE_SEEDS = (0, 1, 2, 3)


def check_tile_oracle() -> None:
    """Phase 3c: checks 1-4 of the "tile" design's oracle on both fused
    kernels at d = 16, 32 and 64 (the last in the padded widths' kernel),
    each line with the seconds it took; checks
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
    for d in (D_MID, D_WIDE, D_PAD):
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
                                    "family", "pmmh", "graft")),
    ("inverse_cdf_apply", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:277", ("main", "streaming",
                                              "models", "pmmh", "graft")),
    ("roll_metropolis_sweeps_expspace", "cusmc_tpu_torch/csrc/rolls.cu",
     "cusmc_tpu/resampling/rolls.py:109", ("main", "streaming", "models",
                                           "family", "graft")),
    ("fused_filter_step", "cusmc_tpu_torch/csrc/fused_step.cu",
     "cusmc_tpu/ops/fused_step.py:127", ("pallas", "models")),
    ("fused_cdf_filter_step", "cusmc_tpu_torch/csrc/fused_cdf_step.cu",
     "cusmc_tpu/ops/fused_cdf_step.py:104", ("pallas", "models")),
    ("inverse_cdf_search", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:422", ("sharded", "family",
                                              "graft")),
    ("take_columns", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:204", ("sharded", "generic",
                                              "family", "graft")),
    ("inverse_cdf_apply[local_base]", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:401", ("sharded", "streaming",
                                              "family", "graft")),
    ("fused_filter_step[bf16]", "cusmc_tpu_torch/csrc/fused_step.cu",
     "cusmc_tpu/ops/fused_step.py:127", "bf16"),
    ("roll_metropolis_sweeps_expspace[bf16]", "cusmc_tpu_torch/csrc/rolls.cu",
     "cusmc_tpu/resampling/rolls.py:109", ("bf16", "family")),
    ("inverse_cdf_apply[bf16]", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:277", "bf16"),
    ("take_columns[bf16]", GATHER_CU,
     "cusmc_tpu/ops/monotone_gather.py:204", ("generic", "family")),
    ("packed_propagate", "cusmc_tpu_torch/csrc/packed_model.cu",
     "none (XLA fusion of cusmc_tpu/models/dlm.py)", "main"),
    ("packed_loglik", "cusmc_tpu_torch/csrc/packed_model.cu",
     "none (XLA fusion of cusmc_tpu/models/dlm.py)", "main"),
)


def _wrappers():
    """name -> (wrapper, the attribute that counts its launches)."""
    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.fused_cdf_step import fused_cdf_filter_step
    from cusmc_tpu_torch.ops.fused_step import fused_filter_step
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
        inverse_cdf_search, take_columns
    from cusmc_tpu_torch.ops.packed_model import packed_loglik, \
        packed_propagate
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
            "take_columns[bf16]": (take_columns, "bf16_launches"),
            "packed_propagate": (packed_propagate, "launches"),
            "packed_loglik": (packed_loglik, "launches")}


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
# The composed DLM step's kernels: one launch each a step wherever a
# float32 DLM with d, k <= 16 runs the packed layout's composed step.
PACKED_KERNELS = ("packed_propagate", "packed_loglik")
PACKED_STEP = dict.fromkeys(PACKED_KERNELS, 1)


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
        # Warm-up, which keeps the inputs of the roll walk or of the
        # search-and-apply.
        with capture(particle_filter, *(
                ("roll_metropolis_sweeps_expspace",
                 ("composed metropolis run, d=2 headline",))
                if resampler == "metropolis" else
                ("inverse_cdf_apply",
                 ("composed systematic run, d=2 headline",)))):
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
            # and, at d = 32, the composed runs those of the
            # search-and-apply and the roll walk (the d = 2 composed runs
            # kept them in phase 4).
            with capture(particle_filter, "fused_cdf_filter_step",
                         (f"fused CDF step, d={d} systematic pallas run",)):
                one("pallas", 0)
            with capture(particle_filter, *(
                    ("roll_metropolis_sweeps_expspace",
                     (f"composed metropolis run, d={d} (engine xla)",))
                    if resampler == "metropolis" else
                    ("inverse_cdf_apply",
                     (f"composed systematic run, d={d} (engine xla)",)))) \
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
             debug_checks=True),
        {"roll_metropolis_sweeps_expspace": 1, **PACKED_STEP}),
    "debug_checks systematic": (
        dict(resampler="systematic", debug_checks=True),
        {"blocked_cumsum": 1, "inverse_cdf_apply": 1, **PACKED_STEP}),
    "debug_checks residual": (
        dict(resampler="residual", debug_checks=True),
        {"blocked_cumsum": 3, "inverse_cdf_apply": 2, **PACKED_STEP}),
    "custom key": (
        dict(resampler=GENERIC_KEY, resampler_kwargs={"num_steps": 10}),
        {"take_columns": 1, **PACKED_STEP}),
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


def _best_of(fns, reps=2, results=None) -> dict:
    """label -> best wall seconds (ending in a synchronize where there is
    a card) of each function, one warm-up round first, the functions in
    turns; with ``results`` (a dict), each one's best run's output is
    kept there under its label."""
    import torch

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    best = {k: math.inf for k in fns}
    for rep in range(reps + 1):
        for label, fn in fns.items():
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            secs = time.perf_counter() - t0
            if rep and secs < best[label]:
                best[label] = secs
                if results is not None:
                    results[label] = out
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
                {**MODEL_RUNS[engine, resampler],
                 **(PACKED_STEP if engine == "xla" else {})}, steps, width)
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
                                  {**FAMILY_LAUNCHES[r, "f32"],
                                   **(PACKED_STEP if d <= 16 else {})},
                                  steps, reps=0)
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
                             {"roll_metropolis_sweeps_expspace": 4,
                              **dict.fromkeys(PACKED_KERNELS, 4)}),
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


# -- MCMC part 2, the SMC samplers, PMMH, the chain-sharded samplers -------
# -- (phase 4i) ------------------------------------------------------------

# (a) At bench_mh.py's configuration (MCMC_CHAINS chains, d = MCMC_D, MVT
# df = MCMC_DF): ChEES (step 0.2, init_traj 2.0), PT (8 rungs of 128
# chains, beta_min 0.05, step 2.38 / sqrt(d), bfloat16 noise in the rate
# rows) and the stretch move (1024 walkers).
CHEES_SWEEPS, PT_SWEEPS, STRETCH_SWEEPS = 200, 2000, 2000
PT_RUNGS, PT_CHAINS, PT_BETA_MIN = 8, 128, 0.05
# The kept runs (float32 noise): (sweeps, thin); the second half is read.
MCMC2_KEEP = {"chees": (CHEES_SWEEPS, 1), "pt": (20000, 10),
              "stretch": (STRETCH_SWEEPS, 1)}
# Bands of the kept runs, sized on the CPU with ``mcmc2_rows("cpu",
# timed=False, seed=s)`` for s = 7, 8, 9, 10 before any card run read
# them (PERF.md section 6): about three times the largest distance
# of those four runs from the target variance 4/3 and from 1 (R-hat),
# and from the runs' mean (acceptance, swap rates, leapfrog counts;
# wider where the four runs' spread is tiny). The CPU read variance
# 1.2943-1.3520 / 1.2626-1.3538 / 1.3280-1.3380 (ChEES, PT, stretch),
# R-hat 1.0019-1.0046 / 1.0555-1.0632 / 1.8906-1.9010 (the stretch move's
# walkers barely move at d = 128: its ensemble holds the target's spread,
# each walker does not mix), acceptance 0.7598-0.7666 (ChEES adapts
# toward 0.651 on the pooled acceptance and settles above it) /
# 0.2306-0.2411 / 0.1964-0.1971, PT swap rates 0.0047-0.0059 (the
# coldest pair) to 0.889-0.901, ChEES mean_leapfrog 5.71-6.435.
MCMC2_BANDS = {
    "chees": {"variance": (1.215, 1.452), "rhat": (1.0, 1.015),
              "accept": (0.73, 0.80), "mean_leapfrog": (4.5, 8.0)},
    "pt": {"variance": (1.12, 1.55), "rhat": (1.0, 1.10),
           "accept": (0.213, 0.255), "swap_min": (0.001, 0.02),
           "swap_max": (0.85, 0.94)},
    "stretch": {"variance": (1.317, 1.350), "rhat": (1.8, 2.0),
                "accept": (0.19, 0.205)},
}
# (b) The driver: ChEES on (a)'s target in blocks of 100 sweeps (at most
# 10), PT on tests/test_driver.py:60-79's bimodal target.
DRIVER_BLOCK, DRIVER_MAX_BLOCKS = 100, 10
# (c) The SMC sampler at N = 2^16 on tests/test_smc_sampler.py:13-33's
# shifted Gaussian (prior N(0, 4 I), target N(mu, I), mu the pattern
# [2, -1, 0.5] repeated) at d = 3 and 32; bands of the log-evidence
# (exactly 0) and of the weighted mean's largest error against mu, sized
# on the CPU with ``smc_sampler_rows("cpu", timed=False)`` and seeds 2
# and 3 before any card run read them: about three times the largest of
# the three runs' distances. At d = 3 every kernel read |log Z| <= 0.0195
# and an error <= 0.0306; at d = 32 MALA (|log Z| <= 0.29, error <=
# 0.012) and HMC (<= 0.031, <= 0.011) hold.
SMC_N, SMC_DIMS = 1 << 16, (3, 32)
SMC_KERNELS = (("rwm", {}), ("mala", dict(step_size=0.3)),
               ("hmc", dict(step_size=0.25)),
               ("waste-free rwm", dict(waste_free=True,
                                       rejuvenation_steps=8,
                                       step_size=0.3)))
SMC_BANDS = {
    **{f"{k} d=3": {"log_evidence": (-0.06, 0.06), "mean_err": (0.0, 0.1)}
       for k in ("rwm", "mala", "hmc", "waste-free rwm")},
    "mala d=32": {"log_evidence": (-0.9, 0.9), "mean_err": (0.0, 0.04)},
    "hmc d=32": {"log_evidence": (-0.1, 0.1), "mean_err": (0.0, 0.035)},
}
# At d = 32 random-walk moves (5 a stage; waste-free 7) do not equilibrate,
# and one run's values spread widely from seed to seed, so the card runs
# SMC_SPREAD_SEEDS seeds of these rows: stat -> (each seed's band, the
# band of the seeds' mean). Sized on the CPU with ``smc_seed_spread("cpu",
# name, seeds)`` before any card run read them, on seeds 1-64 (rwm) and
# 1-24 (waste-free): each seed within the CPU mean +- 5 sd, the mean within
# the CPU mean +- 4 sd sqrt(1/16 + 1/n), n the CPU's seeds, rounded
# outward. The CPU read rwm log Z mean -0.3647, sd 0.5165 (-1.6228 to
# 1.3630), error 0.3044, sd 0.1056 (0.1653 to 0.6605); waste-free log Z
# -0.9158, sd 0.8758 (-2.5187 to 0.6948), error 0.7617, sd 0.2008 (0.4482
# to 1.0910). Rejuvenations that barely move fall far outside the mean
# bands: on the CPU, 16 seeds of rwm with a tenth of the proposal step
# read a mean log Z -3.68 and error 1.84, one move a stage -2.23 and
# 1.37, no move accepted -4.62 and 2.27.
SMC_SPREAD_SEEDS = 16
SMC_SPREAD_BANDS = {
    "rwm d=32": {"log_evidence": ((-3.0, 2.25), (-0.95, 0.22)),
                 "mean_err": ((0.0, 0.84), (0.18, 0.43))},
    "waste-free rwm d=32": {"log_evidence": ((-5.3, 3.5), (-2.05, 0.22)),
                            "mean_err": ((0.0, 1.77), (0.50, 1.03))},
}
# (d) SMC^2 on tests/test_smc2.py's AR(1) model, 150 observations.
SMC2_THETA, SMC2_X, SMC2_T = 256, 256, 150
AR_G, AR_W, AR_V = 0.8, 0.3, 0.5
# (e) PMMH on tests/test_models_smoothing_pmmh.py:118-140's 1-d DLM.
PMMH_T, PMMH_N, PMMH_STEPS, PMMH_V = 101, 1 << 16, 150, 0.04
# (f) The chain-sharded samplers: sweeps of each (ChEES fewer).
SHARDED_SWEEPS = {"mh": 200, "pt": 200, "chees": 20, "stretch": 200}


def mcmc2_target(dev):
    """bench_mh.py's target (MVT df = 8, identity scale, d = 128) and the
    first positions [MCMC_CHAINS, d]."""
    import torch

    from cusmc_tpu_torch.distributions import make_mvt_logprob

    d = MCMC_D
    logp = make_mvt_logprob(torch.zeros(d, device=dev),
                            torch.eye(d, device=dev), MCMC_DF)
    init = torch.randn((MCMC_CHAINS, d),
                       generator=torch.Generator(dev).manual_seed(1),
                       device=dev)
    return logp, init


def _in_band(label, value, band):
    lo, hi = band
    assert lo <= value <= hi, f"{label}: {value} outside [{lo}, {hi}]"


def mcmc2_rows(dev, card="", timed=True, seed=7) -> dict:
    """(a): ChEES, PT and the stretch move at bench_mh.py's configuration
    on ``dev``: with ``timed``, one warm-up and the best of 2 without
    samples (chain-steps/s, and for ChEES grad-evals/s = C sum(n_leap) /
    s beside mean_leapfrog; PT replica-steps/s; the stretch move
    walker-steps/s); then each one's kept run (MCMC2_KEEP, float32 noise)
    whose second half gives the pooled marginal variance (target df / (df
    - 2)), the largest split R-hat over the coordinates and the
    acceptance (PT: the cold rung's; and the swap rates), each held to
    MCMC2_BANDS when they are set; the kept runs draw from ``seed``.
    Returns name -> those numbers."""
    import torch

    from cusmc_tpu_torch.diagnostics.mcmc import split_rhat
    from cusmc_tpu_torch.mcmc import chees_hmc_sampler, \
        parallel_tempering_sampler, stretch_move_sampler

    dev = torch.device(dev)
    logp, init = mcmc2_target(dev)
    c, d = init.shape
    bf16 = torch.bfloat16
    pt_init = init[:PT_CHAINS]
    samplers = {
        "chees": (lambda s, t, keep, thin: chees_hmc_sampler(
            s, logp, init, t, step_size=0.2, init_traj=2.0,
            keep_samples=keep, thin=thin), CHEES_SWEEPS, c),
        "pt": (lambda s, t, keep, thin: parallel_tempering_sampler(
            s, logp, pt_init, t, num_rungs=PT_RUNGS, beta_min=PT_BETA_MIN,
            step_size=2.38 / math.sqrt(d), keep_samples=keep, thin=thin,
            noise_dtype=None if keep else bf16), PT_SWEEPS,
            PT_RUNGS * PT_CHAINS),
        "stretch": (lambda s, t, keep, thin: stretch_move_sampler(
            s, logp, init, t, keep_samples=keep, thin=thin),
            STRETCH_SWEEPS, c),
    }
    out = {}
    for name, (run, sweeps, points) in samplers.items():
        line = f"  MCMC {name} d={d} MVT df={MCMC_DF:g}"
        if timed:
            res = {}
            secs = _best_of({name: lambda: run(1, sweeps, False, 1)},
                            results=res)[name]
            res = res[name]
            unit = {"chees": "chain", "pt": "replica",
                    "stretch": "walker"}[name]
            line += (f", {sweeps} sweeps of {points} {unit}s: "
                     f"{points * sweeps / secs:.6g} {unit}-steps/s")
            if name == "chees":
                leap = float(res.mean_leapfrog)
                line += (f", {c * leap * sweeps / secs:.6g} grad-evals/s "
                         f"(mean_leapfrog {leap:.3f})")
            line += f", best {secs:.4f} s of 2 [{card}]"
        keep_sweeps, thin = MCMC2_KEEP[name]
        res = run(seed, keep_sweeps, True, thin)
        kept = res.samples[res.samples.shape[0] // 2:]
        got = {"variance": float(kept.reshape(-1, d).var(0).mean()),
               "rhat": float(split_rhat(kept).max()),
               "accept": float(res.accept_rate[0] if name == "pt"
                               else res.accept_rate)}
        if name == "pt":
            got["swap_min"] = float(res.swap_rate.min())
            got["swap_max"] = float(res.swap_rate.max())
        if name == "chees":
            got["mean_leapfrog"] = float(res.mean_leapfrog)
        bands = MCMC2_BANDS.get(name, {})
        print(f"{line}; kept run of {keep_sweeps} sweeps (every {thin}): "
              + ", ".join(f"{k} {v:.4f}" + (f" (band {bands[k]})"
                                             if k in bands else "")
                          for k, v in got.items()))
        for k, band in bands.items():
            _in_band(f"MCMC {name} {k}", got[k], band)
        out[name] = got
    return out


def bimodal(x):
    """tests/test_driver.py:60-79's target: log(N(-4 1, I) + N(+4 1, I)),
    unnormalised."""
    import torch

    a = -0.5 * torch.sum((x + 4.0) ** 2, dim=-1)
    b = -0.5 * torch.sum((x - 4.0) ** 2, dim=-1)
    return torch.logaddexp(a, b)


def driver_rows(dev, card="") -> dict:
    """(b): ``sample_to_convergence`` with "chees" on (a)'s target
    (DRIVER_BLOCK sweeps a block, at most DRIVER_MAX_BLOCKS) and with
    "pt" on the bimodal target (32 chains, blocks of 800, 6 rungs,
    beta_min 0.02, an adapted ladder). Both must converge, and PT must
    find both modes (a share of x0 > 0 in (0.2, 0.8))."""
    import torch

    from cusmc_tpu_torch.mcmc import sample_to_convergence

    dev = torch.device(dev)
    logp, init = mcmc2_target(dev)
    t0 = time.perf_counter()
    run = sample_to_convergence(3, logp, init, sampler="chees",
                                block_steps=DRIVER_BLOCK,
                                max_blocks=DRIVER_MAX_BLOCKS, step_size=0.2,
                                init_traj=2.0)
    secs = time.perf_counter() - t0
    print(f"  driver chees C={MCMC_CHAINS} d={MCMC_D} MVT: converged "
          f"{run.converged} in {run.blocks} blocks of {DRIVER_BLOCK}, "
          f"{secs:.3f} s; max R-hat {run.rhat.max():.4f}, min bulk ESS "
          f"{run.ess.min():.1f} [{card}]")
    assert run.converged, "driver chees did not converge"
    init2 = -4.0 + 0.5 * torch.randn(
        (32, 2), generator=torch.Generator(dev).manual_seed(4), device=dev)
    t0 = time.perf_counter()
    pt = sample_to_convergence(4, bimodal, init2, sampler="pt",
                               block_steps=800, max_blocks=8, min_ess=300.0,
                               step_size=0.6, num_rungs=6, beta_min=0.02,
                               adapt_ladder=True)
    secs = time.perf_counter() - t0
    frac = float((pt.samples[..., 0] > 0).mean())
    print(f"  driver pt bimodal C=32 d=2: converged {pt.converged} in "
          f"{pt.blocks} blocks of 800, {secs:.3f} s; max R-hat "
          f"{pt.rhat.max():.4f}, share of x0 > 0 {frac:.4f} (band (0.2, "
          f"0.8)) [{card}]")
    assert pt.converged, "driver pt did not converge"
    assert 0.2 < frac < 0.8, f"driver pt: share of x0 > 0 {frac}"
    return {"chees_blocks": run.blocks, "pt_blocks": pt.blocks,
            "pt_share": frac}


def shifted_gaussian(d, dev):
    """tests/test_smc_sampler.py:13-33's prior N(0, 4 I) and target N(mu,
    I), mu the pattern [2, -1, 0.5] repeated to d: (log_prior,
    log_target, prior_sample, mu), the log-densities with their factors
    computed once."""
    import torch

    from cusmc_tpu_torch.distributions import make_mvn_logprob, \
        mvn_sample_cov

    mu = torch.tensor([2.0, -1.0, 0.5] * (d // 3 + 1), device=dev)[:d]
    zero = torch.zeros(d, device=dev)
    pcov = 4.0 * torch.eye(d, device=dev)
    return (make_mvn_logprob(zero, pcov),
            make_mvn_logprob(mu, torch.eye(d, device=dev)),
            lambda g, s: mvn_sample_cov(g, zero, pcov, s), mu)


def smc_stats(res, mu) -> tuple:
    """An SMC sampler run's log-evidence and its weighted mean's largest
    error against ``mu``."""
    import torch

    w = torch.exp(res.log_weights.double())
    err = float(((w[:, None] * res.particles.double()).sum(0)
                 - mu.double()).abs().max())
    return float(res.log_evidence), err


def smc_seed_spread(dev, name, seeds, d=32) -> dict:
    """The SMC sampler of SMC_KERNELS' row ``name`` at N = SMC_N on the
    shifted Gaussian at ``d``, run once on each of ``seeds``: "log_evidence"
    and "mean_err" -> the runs' values, in seed order. Prints their mean,
    sd, least and largest. On the CPU this sizes SMC_SPREAD_BANDS, e.g.
    ``smc_seed_spread("cpu", "rwm", range(1, 65))``."""
    import numpy as np
    import torch

    from cusmc_tpu_torch.smc.smc_sampler import smc_sampler

    dev = torch.device(dev)
    lp, lt, ps, mu = shifted_gaussian(d, dev)
    kw = dict(SMC_KERNELS)[name]
    vals = {"log_evidence": [], "mean_err": []}
    for seed in seeds:
        lz, err = smc_stats(smc_sampler(seed, lp, lt, ps, SMC_N, d,
                                        rejuvenation=name.split()[-1],
                                        device=dev, **kw), mu)
        vals["log_evidence"].append(lz)
        vals["mean_err"].append(err)
    for k, v in vals.items():
        v = np.asarray(v)
        print(f"  SMC sampler {name} d={d} over {v.size} seeds: {k} mean "
              f"{v.mean():.4f}, sd {v.std(ddof=1):.4f}, least "
              f"{v.min():.4f}, largest {v.max():.4f}")
    return vals


def smc_sampler_rows(dev, card="", timed=True) -> dict:
    """(c): the SMC sampler at N = SMC_N on the shifted Gaussian at each
    of SMC_DIMS, with each of SMC_KERNELS: stages, particle-moves/s (N x
    moves a stage x stages / s; with ``timed``, after one warm-up), the
    log-evidence and the weighted mean's largest error against mu, held
    to SMC_BANDS when they are set. With ``timed``, each row of
    SMC_SPREAD_BANDS also runs SMC_SPREAD_SEEDS seeds (``smc_seed_spread``),
    each held to its per-seed band and their mean to its mean band."""
    import numpy as np
    import torch

    from cusmc_tpu_torch.smc.smc_sampler import smc_sampler

    dev = torch.device(dev)
    out = {}
    for d in SMC_DIMS:
        lp, lt, ps, mu = shifted_gaussian(d, dev)
        for name, kw in SMC_KERNELS:
            kernel = name.split()[-1]

            def run(seed=1, kw=kw, kernel=kernel):
                return smc_sampler(seed, lp, lt, ps, SMC_N, d,
                                   rejuvenation=kernel, device=dev, **kw)
            if timed:
                res = {}
                secs = _best_of({name: run}, reps=1, results=res)[name]
                res = res[name]
            else:
                t0 = time.perf_counter()
                res = run()
                secs = time.perf_counter() - t0
            lz, err = smc_stats(res, mu)
            moves = kw.get("rejuvenation_steps", 5)
            moves -= 1 if kw.get("waste_free") else 0
            rate = SMC_N * moves * res.num_stages / secs
            key = f"{name} d={d}"
            bands = SMC_BANDS.get(key) or {
                k: v[0] for k, v in SMC_SPREAD_BANDS.get(key, {}).items()}
            print(f"  SMC sampler {key} N={SMC_N}: {res.num_stages} stages, "
                  f"{rate:.6g} particle-moves/s ({secs:.3f} s"
                  + (", after one warm-up" if timed else ", CPU")
                  + f"), log-evidence {lz:.4f}"
                  + (f" (band {bands['log_evidence']})" if bands else "")
                  + f", weighted mean's largest error {err:.4f}"
                  + (f" (band {bands['mean_err']})" if bands else "")
                  + f", acceptance {float(res.accept_rate):.4f} [{card}]")
            for k, v in (("log_evidence", lz), ("mean_err", err)):
                if k in bands:
                    _in_band(f"SMC sampler {key} {k}", v, bands[k])
            out[key] = {"stages": res.num_stages, "log_evidence": lz,
                        "mean_err": err}
            if timed and key in SMC_SPREAD_BANDS:
                vals = smc_seed_spread(dev, name,
                                       range(1, SMC_SPREAD_SEEDS + 1), d)
                for k, (seed_band, mean_band) in \
                        SMC_SPREAD_BANDS[key].items():
                    for seed, v in enumerate(vals[k], 1):
                        _in_band(f"SMC sampler {key} seed {seed} {k}", v,
                                 seed_band)
                    m = float(np.mean(vals[k]))
                    print(f"    {k}: the {len(vals[k])} seeds' mean {m:.4f} "
                          f"(band {mean_band}), each seed in {seed_band} "
                          f"[{card}]")
                    _in_band(f"SMC sampler {key} mean {k}", m, mean_band)
                    out[key][f"{k}_seeds"] = vals[k]
        # Where a stage's time goes: its 30-step bisection for the next
        # temperature, timed alone on this d's prior cloud.
        from cusmc_tpu_torch.smc.smc_sampler import _next_delta
        x = ps(torch.Generator(dev).manual_seed(0), (SMC_N,))
        ratio = lt(x) - lp(x)
        logw = torch.zeros(SMC_N, device=dev)
        secs = _best_of({"bisection": lambda: _next_delta(
            logw, ratio, 0.5, SMC_N)}, reps=5)["bisection"]
        print(f"  SMC sampler d={d}: one stage's bisection (30 steps) "
              f"{secs * 1e3:.3f} ms [{card}]")
    return out


def ar1_data(steps, seed=3):
    """tests/test_liu_west.py:23-30's AR(1) data (g = 0.8, W = 0.3, V =
    0.5), [steps, 1] float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x, ys = 0.0, np.zeros((steps, 1), np.float32)
    for t in range(1, steps):
        x = AR_G * x + rng.normal(0, np.sqrt(AR_W))
        ys[t, 0] = x + rng.normal(0, np.sqrt(AR_V))
    return ys


def ar1_grid_posterior(ys):
    """tests/test_liu_west.py:60-74: the exact posterior mean and sd of g
    on a grid, from the Kalman likelihood times the N(0.5, 0.2^2)
    prior."""
    import numpy as np

    from cusmc_tpu_torch.smc.kalman import kalman_filter

    gs = np.linspace(0.3, 1.1, 161)
    logp = np.array([float(kalman_filter(
        np.asarray(ys, np.float64), np.eye(1), [[g]], [[AR_V]], [[AR_W]],
        np.zeros(1), np.eye(1))[2]) - 0.5 * ((g - 0.5) / 0.2) ** 2
        for g in gs])
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = float((w * gs).sum())
    return mean, float(np.sqrt((w * gs ** 2).sum() - mean ** 2))


def smc2_row(dev, card="", nt=SMC2_THETA, nx=SMC2_X) -> dict:
    """(d): SMC^2 on the AR(1) model's SMC2_T observations with nt theta
    particles of nx state particles each (the callables vectorised over
    the theta axis): the posterior mean of g within 3 sd + 0.03 of the
    grid oracle (tests/test_smc2.py), at least one rejuvenation; the
    seconds, the rejuvenations, and the share of the time they take (the
    run against the same run with ``ess_threshold=0``, which never
    rejuvenates)."""
    import torch

    from cusmc_tpu_torch.smc.smc2 import smc2

    dev = torch.device(dev)
    ys = ar1_data(200)[:SMC2_T]
    sw, lv = math.sqrt(AR_W), math.log(2.0 * math.pi * AR_V)
    fns = (lambda g, n, th: torch.randn((th.shape[0], n, 1), generator=g,
                                        device=dev),
           lambda g, x, th: th[:, None, :1] * x + sw * torch.randn(
               x.shape, generator=g, device=dev),
           lambda y, x, th: -0.5 * (y[0] - x[..., 0]) ** 2 / AR_V - 0.5 * lv,
           lambda g, n: 0.5 + 0.2 * torch.randn((n, 1), generator=g,
                                                device=dev),
           lambda th: -0.5 * ((th[:, 0] - 0.5) / 0.2) ** 2)
    res = {}
    best = _best_of({
        "smc2": lambda: smc2(5, *fns, ys, nt, nx, device=dev),
        "bare": lambda: smc2(5, *fns, ys, nt, nx, ess_threshold=0.0,
                             device=dev)}, reps=1, results=res)
    secs, bare, res = best["smc2"], best["bare"], res["smc2"]
    mean0, sd0 = ar1_grid_posterior(ys)
    w = torch.softmax(res.log_weights.double(), 0)
    mean = float(w @ res.thetas.double()[:, 0])
    print(f"  SMC^2 AR(1) T={SMC2_T} N_theta={nt} N_x={nx}: {secs:.3f} s "
          f"after one warm-up, {res.num_rejuvenations} rejuvenations taking "
          f"{max(secs - bare, 0.0) / secs:.3f} of it (the run without them "
          f"{bare:.3f} s); posterior mean of g {mean:.4f} (grid oracle "
          f"{mean0:.4f}, band 3 sd + 0.03 = {3 * sd0 + 0.03:.4f}), "
          f"acceptance of the last pass {float(res.accept_rate):.4f} "
          f"[{card}]")
    assert res.num_rejuvenations >= 1, "SMC^2: no rejuvenation"
    assert abs(mean - mean0) < 3.0 * sd0 + 0.03, \
        f"SMC^2: posterior mean {mean} off the grid oracle {mean0}"
    return {"mean": mean, "oracle": mean0, "seconds": secs,
            "rejuvenations": res.num_rejuvenations}


def pmmh_data(steps=PMMH_T, seed=11):
    """tests/test_models_smoothing_pmmh.py:118-140's 1-d DLM (G = 0.9, W
    = 0.01, V = 0.04) simulated with numpy, [steps, 1] float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x, ys = rng.normal(), np.zeros((steps, 1), np.float32)
    for t in range(1, steps):
        x = 0.9 * x + rng.normal(0, 0.1)
        ys[t, 0] = x + rng.normal(0, math.sqrt(PMMH_V))
    return ys


def pmmh_row(dev, card="", n=PMMH_N, steps=PMMH_STEPS) -> dict:
    """(e): PMMH over log V of the 1-d DLM (T = PMMH_T), n particles,
    ``steps`` steps of size 0.4, systematic, the model built on ``dev``
    from the chain's theta every step: posterior median of V in (0.3, 3)
    x the true V, acceptance in (0.02, 0.9); on the card, the cumsum, the
    search-and-apply and the composed step's two kernels launched exactly
    (steps + 1) (T - 1) times each and no other kernel. Prints PMMH
    steps/s and particle-steps/s."""
    import numpy as np
    import torch

    from cusmc_tpu_torch.mcmc import pmmh
    from cusmc_tpu_torch.models.dlm import DLM

    dev = torch.device(dev)
    i1 = torch.eye(1, device=dev)
    f, g, m0, w = i1, 0.9 * i1, torch.zeros(1, device=dev), 0.01 * i1

    def builder(th):
        return DLM.create(F=f, G=g, m0=m0, C0=i1, V=torch.exp(th[0]) * i1,
                          W=w, device=dev)

    ys = torch.from_numpy(pmmh_data()).to(dev)
    # Where a step's time goes beside its filter run: the model's build.
    build = _best_of({"build": lambda: builder(
        torch.full((1,), -3.0, device=dev))}, reps=20)["build"]
    on_card = dev.type == "cuda"
    before = _counts() if on_card else None
    t0 = time.perf_counter()
    res = pmmh(0, builder, lambda th: -0.5 * torch.sum(th ** 2) / 9.0,
               torch.zeros(1, device=dev), ys, n, steps, step_size=0.4)
    acc = float(res.accept_rate)  # the host read ends the chain
    secs = time.perf_counter() - t0
    post = np.exp(res.thetas.cpu().numpy()[steps // 2:, 0])
    med = float(np.median(post))
    runs = steps + 1
    print(f"  PMMH 1-d DLM T={PMMH_T} N={n}, {steps} steps: "
          f"{steps / secs:.6g} PMMH steps/s, "
          f"{n * (PMMH_T - 1) * runs / secs:.6g} particle-steps/s "
          f"({secs:.3f} s, {runs} filter runs, a model build "
          f"{build * 1e3:.3f} ms of each); acceptance {acc:.4f} (band "
          f"(0.02, 0.9)), posterior median of V {med:.5f} (band "
          f"({0.3 * PMMH_V:.3f}, {3 * PMMH_V:.3f})) [{card}]")
    assert 0.02 < acc < 0.9, f"PMMH: acceptance {acc}"
    assert 0.3 * PMMH_V < med < 3.0 * PMMH_V, f"PMMH: median V {med}"
    out = {"acceptance": acc, "median_V": med}
    if on_card:
        after = _counts()
        want = {k: runs * (PMMH_T - 1) for k in CDF_KERNELS + PACKED_KERNELS}
        for name in after:
            grown = after[name] - before[name]
            assert grown == want.get(name, 0), \
                f"PMMH: {name} launched {grown} times, expected " \
                f"{want.get(name, 0)}"
        print("  PMMH launches: " + ", ".join(
            f"{k} {v}" for k, v in want.items())
            + f" (= {runs} filter runs x {PMMH_T - 1} steps), no other "
            "kernel")
    return out


def sharded_mcmc_rows(card: str) -> None:
    """(f): the chain-sharded samplers on a one-rank NCCL group (a
    ``Mesh({"chains": 1})``) at (a)'s configuration, SHARDED_SWEEPS
    sweeps each: each bitwise the unsharded sampler seeded with rank 0's
    seed, its rate beside the unsharded rate (best of 2 in turns)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from cusmc_tpu_torch.mcmc import chees_hmc_sampler, \
        metropolis_hastings_sampler, parallel_tempering_sampler, \
        stretch_move_sampler
    from cusmc_tpu_torch.parallel import Mesh, initialize_distributed, \
        sharded_chees_sampler, sharded_mh_sampler, sharded_pt_sampler, \
        sharded_stretch_sampler
    from cusmc_tpu_torch.parallel.mesh import rank_seed

    dev = torch.device("cuda")
    logp, init = mcmc2_target(dev)
    d = init.shape[1]
    step = 2.38 / math.sqrt(d)
    rows = {
        "mh": (sharded_mh_sampler, metropolis_hastings_sampler, init,
               dict(step_size=step, noise_dtype=torch.bfloat16)),
        "pt": (sharded_pt_sampler, parallel_tempering_sampler,
               init[:PT_CHAINS], dict(num_rungs=PT_RUNGS,
                                      beta_min=PT_BETA_MIN, step_size=step,
                                      noise_dtype=torch.bfloat16)),
        "chees": (sharded_chees_sampler, chees_hmc_sampler, init,
                  dict(step_size=0.2, init_traj=2.0)),
        "stretch": (sharded_stretch_sampler, stretch_move_sampler, init, {}),
    }
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0)
        try:
            mesh = Mesh({"chains": 1})
            for name, (sharded, plain, x, kw) in rows.items():
                sweeps = SHARDED_SWEEPS[name]
                runs = {"sharded": lambda: sharded(
                            9, logp, x, sweeps, mesh, keep_samples=True,
                            **kw),
                        "unsharded": lambda: plain(
                            rank_seed(9, 0), logp, x, sweeps,
                            keep_samples=True, **kw)}
                got, want = runs["sharded"](), runs["unsharded"]()
                for f in ("samples", "accept_rate"):
                    assert torch.equal(getattr(got, f), getattr(want, f)), \
                        f"sharded {name}: {f} differs from the unsharded run"
                best = _best_of(runs)
                pts = x.shape[0] * (PT_RUNGS if name == "pt" else 1)
                print(f"  sharded {name} (one-rank group, {sweeps} sweeps of "
                      f"{pts}): {pts * sweeps / best['sharded']:.6g} "
                      f"chain-steps/s beside the unsharded "
                      f"{pts * sweeps / best['unsharded']:.6g}; bitwise the "
                      f"unsharded run with rank 0's seed [{card}]")
        finally:
            dist.destroy_process_group()


def samplers_path(card: str) -> None:
    """Phase 4i (the module docstring): (a) MCMC part 2, (b) the driver,
    (c) the SMC sampler, (d) SMC^2, (e) PMMH, (f) the chain-sharded
    samplers; every part but PMMH launches no kernel."""
    import torch

    from cusmc_tpu_torch.smc import particle_filter

    dev = torch.device("cuda")
    mcmc2_rows(dev, card)
    driver_rows(dev, card)
    smc_sampler_rows(dev, card)
    smc2_row(dev, card)
    # Phase 5 holds the kernels to their plain versions on PMMH's own
    # inputs, kept at PMMH_TRAFFIC_STEPS.
    with capture(particle_filter, "blocked_cumsum", ("pmmh d=1",),
                 PMMH_TRAFFIC_STEPS), \
            capture(particle_filter, "inverse_cdf_apply", ("pmmh d=1",),
                    PMMH_TRAFFIC_STEPS):
        pmmh_row(dev, card)
    sharded_mcmc_rows(card)
    runs = PMMH_STEPS + 1
    for name, count in _counts().items():
        want = (runs * (PMMH_T - 1)
                if name in CDF_KERNELS + PACKED_KERNELS else 0)
        assert count == want, f"phase 4i: {name} launched {count} times, " \
            f"expected {want} (PMMH's alone)"


# -- the graft entry, the dry run and the examples (phase 4j) -------------

EXAMPLES = ("01_particle_filter", "02_mcmc", "03_pmmh", "04_sharded",
            "05_rbpf_liu_west", "06_sharded_streaming", "07_advanced_mcmc",
            "08_nonlinear_ungm")
# The band of each quantity an example prints, at the example's own sizes:
# its JAX original's oracle (the MVT variance df/(df-2) = 4/3 within 10%,
# the true V = 0.04, the Liu-West truth g = 0.8, the PT target share 0.5,
# R-hat below 1.1), each wider than the spread of 16 seeds at the
# smaller sizes of tests/test_torch_examples.py; the rest finite.
MCMC_VAR_BAND = (1.2, 1.47)
EXAMPLE_BANDS = {
    "01_particle_filter": {"rmse": (0.0, 0.05)},
    "02_mcmc": {f"{k}.var": MCMC_VAR_BAND
                for k in ("mh", "MALA", "HMC", "adaptive-MH")},
    "03_pmmh": {"median_V": (0.02, 0.08), "acceptance": (0.05, 0.9)},
    "05_rbpf_liu_west": {"lw_theta_final": (0.6, 0.95)},
    "07_advanced_mcmc": {"right_share": (0.3, 0.7), "max_rhat": (0.9, 1.1)},
    "08_nonlinear_ungm": {"straddle": (0.0, 1.0)},
}
EXAMPLE_FINITE = {
    "01_particle_filter": ("log_evidence", "mean_ess"),
    "04_sharded": ("log_evidence", "final_ess"),
    "05_rbpf_liu_west": ("rbpf_log_evidence", "rbpf_final_ess"),
    "06_sharded_streaming": ("streaming_log_evidence", "min_ess",
                             "auto_log_evidence"),
    "08_nonlinear_ungm": ("log_evidence", "final_ess", "rmse"),
}
# The calls whose inputs phase 5 holds the kernels to: (example, module
# attribute, wrapper, label, calls). 01's 1000 roll walks; PMMH's 401
# filter runs of 200 steps (call 200 r + s is run r's step s: step 1 of
# the first, the middle and step 199 of the last run); 04's 500 roll
# walks; 06's sharded streaming resamples where the ESS falls under N/2
# (its first, 11th and 21st) and the first of its 500 auto-sweep roll
# walks at each sweep count (all are kept while it runs); UNGM's 199
# resamples.
AUTO_LABEL = "06 auto sweeps N=8192"
EXAMPLE_TRAFFIC = (
    ("01_particle_filter", "particle_filter",
     "roll_metropolis_sweeps_expspace", "01 N=10000", (0, 499, 999)),
    ("03_pmmh", "particle_filter", "blocked_cumsum", "03 PMMH N=1024",
     (1, 40001, 80199)),
    ("03_pmmh", "particle_filter", "inverse_cdf_apply", "03 PMMH N=1024",
     (1, 40001, 80199)),
    ("04_sharded", "presampling", "roll_metropolis_sweeps_expspace",
     "04 sharded N=16384", (0, 249, 499)),
    ("06_sharded_streaming", "presampling", "blocked_cumsum",
     "06 streaming N=4096", (0, 10, 20)),
    ("06_sharded_streaming", "presampling", "inverse_cdf_apply",
     "06 streaming N=4096", (0, 10, 20)),
    ("06_sharded_streaming", "particle_filter",
     "roll_metropolis_sweeps_expspace", AUTO_LABEL, None),
    ("08_nonlinear_ungm", "particle_filter", "blocked_cumsum",
     "08 UNGM N=16384", (0, 99, 198)),
    ("08_nonlinear_ungm", "particle_filter", "inverse_cdf_apply",
     "08 UNGM N=16384", (0, 99, 198)),
)
# The dry run's kernel calls (N = 8 on one rank: the sharded systematic,
# metropolis and residual filters and sharded streaming), all kept.
DRYRUN_TRAFFIC = (("presampling", "blocked_cumsum"),
                  ("classic", "blocked_cumsum"),
                  ("presampling", "inverse_cdf_apply"),
                  ("presampling", "inverse_cdf_search"),
                  ("presampling", "take_columns"),
                  ("presampling", "roll_metropolis_sweeps_expspace"))
EXAMPLE_SUBPROCESS_TIMEOUT = 300


def example_module(name):
    """``examples/torch/<name>.py``, imported by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(out: dict, prefix="") -> dict:
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


def check_example(name, out) -> None:
    """An example's printed quantities inside their bands, or finite."""
    import numpy as np

    out = _flat(out)
    for key, (lo, hi) in EXAMPLE_BANDS.get(name, {}).items():
        assert lo < out[key] < hi, \
            f"example {name}: {key} = {out[key]} outside ({lo}, {hi})"
        print(f"  example {name}: {key} = {out[key]:.6g} in ({lo}, {hi})")
    for key in EXAMPLE_FINITE.get(name, ()):
        assert np.isfinite(out[key]), f"example {name}: {key} = {out[key]}"


def graft_path(card: str, dev: str = "cuda") -> None:
    """Phase 4j: the graft entry's step on the card (one roll walk and the
    composed step's two kernels), the dry run on a one-rank NCCL group,
    the eight examples in process at their own sizes (each quantity in its
    band, each timed; the sweep counts of 06's auto schedule in {10, 5,
    3}) and example 01 as a script; the kernels' inputs kept for phase 5.
    ``dev="cpu"`` runs it all on the CPU (gloo; no launch is counted
    there)."""
    import torch

    from cusmc_tpu_torch import graft_entry
    from cusmc_tpu_torch.parallel import joined_group
    from cusmc_tpu_torch.parallel import resampling as presampling
    from cusmc_tpu_torch.resampling import classic, rolls
    from cusmc_tpu_torch.smc import particle_filter

    modules = {"particle_filter": particle_filter,
               "presampling": presampling, "classic": classic}
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    walk = "roll_metropolis_sweeps_expspace"

    t0 = time.perf_counter()
    fn, args = graft_entry.entry(dev)
    before = _counts()
    with capture(rolls, walk, ("entry N=4096",), (0,)):
        out = fn(*args)
        sync()
    after = _counts()
    assert all(bool(torch.isfinite(t).all()) for t in out), "entry"
    for name in after:
        grown = after[name] - before[name]
        assert grown == (on_card and name in (walk,) + PACKED_KERNELS), \
            f"entry: {name} launched {grown} times"
    print(f"  entry(): one step, N=4096, d=2, MVT df=5, metropolis B=10, "
          f"ess {float(out[2]):.1f}, lz {float(out[3]):.6g} "
          f"({time.perf_counter() - t0:.3f} s with the model build)")

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(joined_group(dev, 1))
        for mod, fn_name in DRYRUN_TRAFFIC:
            stack.enter_context(capture(modules[mod], fn_name,
                                        (f"dry run N=8 ({mod})",), None))
        res = graft_entry.dryrun_multichip(1, dev)
    secs = time.perf_counter() - t0
    print(f"  dryrun_multichip(1), one-rank group: {secs:.3f} s; "
          + ", ".join(f"{k} {float(v):.6g}" for k, v in res.items()
                      if getattr(v, "size", 1) == 1))

    sweeps = []
    auto = particle_filter.auto_num_steps

    def record(w, num_steps=10):
        sweeps.append(auto(w, num_steps))
        return sweeps[-1]

    times = {}
    for name in EXAMPLES:
        mod = example_module(name)
        with contextlib.ExitStack() as stack:
            for ex, m, fn_name, label, steps in EXAMPLE_TRAFFIC:
                if ex == name:
                    stack.enter_context(capture(modules[m], fn_name,
                                                (label,), steps))
            if name == "06_sharded_streaming":
                particle_filter.auto_num_steps = record
                stack.callback(setattr, particle_filter, "auto_num_steps",
                               auto)
            t0 = time.perf_counter()
            out = mod.main(None if on_card else "cpu")
            sync()
            times[name] = time.perf_counter() - t0
        print(f"  example {name}: {times[name]:.3f} s [{card}]")
        check_example(name, out)
    assert sweeps and set(sweeps) <= {10, 5, 3}, sweeps
    key = (walk, AUTO_LABEL)
    first = {}
    for kept in TRAFFIC.pop(key):
        first.setdefault(kept[1][1].numel(), kept)  # by the shifts' count
    TRAFFIC[key] = sorted(first.values(), key=lambda kept: kept[0])
    TRAFFIC_WANT[key] = tuple(kept[0] for kept in TRAFFIC[key])
    print(f"  06's auto schedule: {len(sweeps)} resamples, sweeps "
          + ", ".join(f"B={b} x{sweeps.count(b)}" for b in (10, 5, 3)))

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join("examples", "torch",
                                      "01_particle_filter.py")]
        + ([] if on_card else ["--device", "cpu"]),
        cwd=root, capture_output=True, text=True,
        timeout=EXAMPLE_SUBPROCESS_TIMEOUT)
    secs = time.perf_counter() - t0
    assert proc.returncode == 0, f"example 01 as a script:\n{proc.stderr}"
    lz = [float(line.split(":", 1)[1]) for line in proc.stdout.splitlines()
          if line.startswith("log evidence:")]
    assert len(lz) == 1 and math.isfinite(lz[0]), proc.stdout
    print(f"  python3 examples/torch/01_particle_filter.py: {secs:.3f} s, "
          f"log evidence {lz[0]:.6g} (in process "
          f"{times['01_particle_filter']:.3f} s)")


# -- the main paths' own traffic ------------------------------------------

# Steps of a T = 200 run whose inputs to the block-window kernels are kept
# while the main paths run: the first resample, one in the middle, the last.
TRAFFIC_STEPS = (0, 99, 198)
# (wrapper name, label) -> [(step, args, kwargs)], filled by ``capture``
# (and, with step None, by phase 3 for the search-only kernel's shuffled
# queries).
TRAFFIC: dict = {}
# (wrapper name, label) -> the steps ``capture`` was asked to keep.
TRAFFIC_WANT: dict = {}
# PMMH's calls of the cumsum and the search-and-apply (phase 4i), one a
# step of each of its 151 filter runs of 100 steps (call 100 r + s is
# run r's step s): step 1 of the first run (V = 1, the chain's start), of
# the middle run and of the last, and step 79 of the middle run. A run's
# step 0 resamples uniform weights; steps 1 (the prior's sd of 1 against
# an observation sd near 0.2) and 79 (an outlying observation) carry its
# most concentrated ones: on the CPU a median of 22200 and 22157 distinct
# ancestors of 65536 over the 151 runs, against 54271 over all steps.
PMMH_TRAFFIC_STEPS = (1, 7501, 7579, 15001)


def _clone(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple):
        return tuple(_clone(x) for x in v)
    return v


@contextlib.contextmanager
def capture(module, name, labels, steps=TRAFFIC_STEPS):
    """While open, the calls that ``module`` makes to its function ``name``
    (a kernel's wrapper, imported there by name) run unchanged, and the
    arguments of the ``steps`` are kept, cloned, in TRAFFIC[name, label]:
    each step makes one call for each of ``labels``, in that order.
    ``steps`` None keeps every call (for runs of few, small calls)."""
    fn = getattr(module, name)
    calls = itertools.count()
    for label in labels:
        TRAFFIC_WANT[name, label] = None if steps is None else tuple(steps)

    def recorder(*args, **kwargs):
        step, which = divmod(next(calls), len(labels))
        if steps is None or step in steps:
            TRAFFIC.setdefault((name, labels[which]), []).append(
                (step, _clone(args), dict(kwargs)))
        return fn(*args, **kwargs)

    # A wrapper that counts its launches through its own module-level name
    # (``rolls.roll_metropolis_sweeps_expspace``) then counts on ``fn``.
    recorder.__dict__ = fn.__dict__
    setattr(module, name, recorder)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _other_module(root, rel, name, kernels_mod):
    """The module at ``root``/``rel`` of another checkout, loaded under
    ``name`` with ``cusmc_tpu_torch.ops.kernels`` bound to that tree's
    kernels module while it imports, so that its wrappers launch that
    tree's kernels (and count on their own functions)."""
    import importlib.util

    import cusmc_tpu_torch.ops as ops_package

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    ours = ops_package.kernels
    ops_package.kernels = kernels_mod
    try:
        spec.loader.exec_module(mod)
    finally:
        ops_package.kernels = ours
    return mod


def other_trees(roots) -> list:
    """[(root, other_tree(root))] for each root, their kernels built side
    by side (one thread a tree: each build runs its own nvcc processes)."""
    import concurrent.futures
    import importlib.util

    mods = []
    for root in roots:
        spec = importlib.util.spec_from_file_location(
            f"other_kernels_{abs(hash(root))}",
            os.path.join(root, "cusmc_tpu_torch", "ops", "kernels.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max(1, len(mods))) as pool:
        list(pool.map(lambda mod: mod.build(), mods))
    print(f"  built the kernels of {len(mods)} other trees in "
          f"{time.perf_counter() - t0:.1f} s")
    for root, mod in zip(roots, mods):
        for entry, line in ptxas_report(mod.build_info.get("log", "")):
            if "fused" in entry:
                print(f"  ptxas ({root}): {entry[:90]}: {line}")
    return [(root, other_tree(root, mod)) for root, mod in zip(roots, mods)]


def other_tree(root, mod):
    """The kernels that phases 3 and 5 compare, of another checkout of the
    repo at ``root`` whose ``cusmc_tpu_torch/ops/kernels.py`` is loaded as
    ``mod`` (it builds them from its own sources into its own ``build/``):
    wrapper name -> ``fn(args, kwargs)`` returning the ancestors, called
    with the arguments that this tree's wrapper takes,
    "blocked_cumsum" -> ``fn(w)`` returning the cdf (phase 3's counts over
    zero weights), "fused_step_outputs" and "fused_cdf_outputs" ->
    ``fn(args, kwargs)`` returning that tree's (X_new, ll, ancestors), and
    "roll_metropolis_sweeps_expspace", "fused_filter_step" and
    "fused_cdf_filter_step" -> that tree's own wrappers (its
    ``resampling/rolls.py`` and ``ops/fused_*.py`` bound to its kernels).
    The C entries keep their signatures across trees but for arguments
    added since: the fused CDF step's ``tiled`` (the "tile" design), the
    search-and-apply's ``bf16`` (the bfloat16 state) and both fused steps'
    width bucket ``dm, km``."""
    import torch

    from cusmc_tpu_torch.ops.fused_cdf_step import MODES, cdf_auto_tile

    lib = mod.library()
    tag = abs(hash(root))
    other_rolls = _other_module(root, "cusmc_tpu_torch/resampling/rolls.py",
                                f"other_rolls_{tag}", mod)
    other_step = _other_module(root, "cusmc_tpu_torch/ops/fused_step.py",
                               f"other_fused_step_{tag}", mod)
    # That tree's fused CDF step imports its helpers from its fused step.
    this_step = sys.modules["cusmc_tpu_torch.ops.fused_step"]
    sys.modules["cusmc_tpu_torch.ops.fused_step"] = other_step
    try:
        other_cdf = _other_module(
            root, "cusmc_tpu_torch/ops/fused_cdf_step.py",
            f"other_fused_cdf_{tag}", mod)
    finally:
        sys.modules["cusmc_tpu_torch.ops.fused_step"] = this_step
    step_path = other_step.step_path
    has_tiled = len(mod.SIGNATURES["cusmc_fused_cdf_step"]) >= 23
    has_bf16 = len(mod.SIGNATURES["cusmc_inverse_cdf_apply"]) == 12
    has_buckets = len(mod.SIGNATURES["cusmc_fused_step"]) == 27

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

    def design(d, k):
        tiled = step_path(d, k) == "tile"
        if not has_buckets:
            widths = ()
        elif hasattr(other_step, "step_widths"):
            widths = other_step.step_widths(d, k)
        else:  # before the padded tile widths: (0, 0) for any tile shape
            widths = (0, 0) if tiled else other_step.thread_widths(d, k)
        return int(tiled), widths

    def cdf_outputs(args, kw):
        cdf, X, y, G, Q, F, Li, df, log_norm, (u, seed) = args
        (d, n), k = X.shape, F.shape[0]
        Xo, ll = torch.empty_like(X), torch.empty_like(cdf)
        a = torch.empty(n, dtype=torch.int32, device=X.device)
        tiled, widths = design(d, k)
        mod.check(lib.cusmc_fused_cdf_step(
            *(t.data_ptr() for t in (cdf, X, y, G, Q, F, Li, u, seed, Xo, ll,
                                     a)),
            n, kw.get("tile") or cdf_auto_tile(n, max(d, k)), d, k,
            MODES.index(kw["mode"]), int(kw["noise"] == "mvt"),
            kw.get("df_int") or 0, 1.0 if df is None else float(df),
            float(log_norm), *((tiled,) if has_tiled else ()), *widths,
            stream), root)
        return Xo, ll, a

    def step_outputs(args, kw):
        X, logw, y, G, Q, F, Li, df, log_norm, (s, seed) = args
        (d, n), k = X.shape, F.shape[0]
        Xo = torch.empty_like(X)
        ll = torch.empty_like(logw)
        a = torch.empty(n, dtype=torch.int32, device=X.device)
        tiled, widths = design(d, k)
        mod.check(lib.cusmc_fused_step(
            *(t.data_ptr() for t in (X, logw, y, G, Q, F, Li, s, seed, Xo, ll,
                                     a)),
            n, kw["tile"], d, k, kw["num_sweeps"], kw["num_window_tiles"],
            int(kw["noise"] == "mvt"), kw.get("df_int") or 0,
            1.0 if df is None else float(df), float(log_norm), tiled,
            *widths, int(X.dtype == torch.bfloat16), stream), root)
        return Xo, ll, a

    return {"inverse_cdf_search": search, "inverse_cdf_apply": apply,
            "fused_cdf_filter_step": lambda a, k: cdf_outputs(a, k)[2],
            "fused_cdf_outputs": cdf_outputs,
            "fused_step_outputs": step_outputs, "blocked_cumsum": cumsum,
            "roll_metropolis_sweeps_expspace":
                other_rolls.roll_metropolis_sweeps_expspace,
            "fused_step_wrapper": other_step.fused_filter_step,
            "fused_cdf_wrapper": other_cdf.fused_cdf_filter_step}


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

    kept_on_paths = {k for k, v in TRAFFIC.items() if v[0][0] is not None}
    assert kept_on_paths == set(TRAFFIC_WANT), \
        f"kept on the main paths: {sorted(kept_on_paths)}, wanted " \
        f"{sorted(TRAFFIC_WANT)}"
    for (fn, label), kept in sorted(TRAFFIC.items()):
        steps = tuple(s for s, _, _ in kept)
        want = TRAFFIC_WANT.get((fn, label))
        assert kept[0][0] is None or steps == (
            tuple(range(len(steps))) if want is None else want), label
        for step, args, kw in kept:
            name = label if step is None else f"{label}, step {step}"
            if fn == "blocked_cumsum":
                check_cumsum_traffic(name, args[0], others)
                continue
            if fn == "roll_metropolis_sweeps_expspace":
                check_roll_traffic(name, args, others)
                continue
            if fn == "take_columns":
                check_take_traffic(name, args)
                continue
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


def check_roll_traffic(name, args, others=()) -> None:
    """Phase 5 for the roll walk on a path's ``(w, shifts, u, X)``: held
    to its plain version (ancestors and values exactly equal) and to each
    ``others`` tree's kernel, and its device time (``queued_ms``) beside
    theirs, in the order other, this, this, other."""
    import torch

    from cusmc_tpu_torch.resampling.rolls import l2_bytes, roll_band_rows, \
        roll_metropolis_sweeps_expspace, roll_path

    w, shifts, u, X = args
    _roll_exact(name, roll_metropolis_sweeps_expspace, *args, "mixed",
                others)
    (d, n), b = X.shape, shifts.numel()
    rows = roll_band_rows(n, d, X.element_size(), l2_bytes(X.device))

    def ours():
        return roll_metropolis_sweeps_expspace(*args)
    a = ours()[1]
    t_bytes = roll_bytes(n, d, b, X.element_size()) / HBM_BYTES_PER_S * 1e3
    line = (f"  {name}: N={n} d={d} {str(X.dtype)[6:]} B={b} "
            f"[{roll_path(rows, d)}, {rows} rows a band], "
            f"{int(torch.unique(a).numel())} distinct ancestors, moved share "
            f"{float((a != torch.arange(n, device=a.device)).float().mean()):.3f}"
            f", ancestors and values equal to the plain version; device time "
            f"{queued_ms(ours):.4f} ms, bound {t_bytes:.4f} ms")
    for root, fns in others:
        def theirs(fns=fns):
            return fns["roll_metropolis_sweeps_expspace"](*args)
        t = [queued_ms(theirs), queued_ms(ours), queued_ms(ours),
             queued_ms(theirs)]
        line += (f"; {root} {t[0]:.4f}/{t[3]:.4f} ms, this tree "
                 f"{t[1]:.4f}/{t[2]:.4f} ms beside it")
    print(line)


# -- the composed metropolis rows with each tree's roll walk ---------------

def roll_row(card, others, keep=False) -> None:
    """The composed ("xla") metropolis rows of phase 4 and 4b (MVT df=5,
    N=2^20, T=200, B=10; d = 2 and 32) with this tree's roll walk and with
    each ``others`` tree's (its wrapper and kernel) in its place, in turns (this, other, other,
    this) after one warm-up each: particle-steps/s, and from one profiled
    run each the device's busy share and the roll walk's device time a
    step and share of the run's wall time (torch.profiler); each other
    tree's runs bitwise this tree's (final particles, log-evidence, ESS).
    With ``keep`` this tree's warm-ups keep the walk's inputs at
    TRAFFIC_STEPS for phase 5, as phases 4 and 4b do."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc import particle_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    n, steps = N_BIG, 200
    walks = {root: fns["roll_metropolis_sweeps_expspace"]
             for root, fns in others}
    for d in (D, D_WIDE):
        model = DLM.create(noise="mvt", df=5.0, device="cuda",
                           **demo_model_params(d))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        _, ys_h = model.simulate(gen, steps)

        def run(tree, seed):
            this = particle_filter.roll_metropolis_sweeps_expspace
            if tree is not None:
                particle_filter.roll_metropolis_sweeps_expspace = walks[tree]
            try:
                res = bootstrap_filter(seed, model, ys_h, n,
                                       resampler="metropolis",
                                       resampler_kwargs={"num_steps": 10},
                                       engine="xla", return_history=False)
                torch.cuda.synchronize()
            finally:
                particle_filter.roll_metropolis_sweeps_expspace = this
            return res

        label = f"composed metropolis run, d={d} (engine xla)" \
            if d == D_WIDE else f"composed metropolis run, d={d} headline"
        with capture(particle_filter, "roll_metropolis_sweeps_expspace",
                     (label,)) if keep else contextlib.nullcontext():
            mine = run(None, 0)

        def same(res, tree):
            for key in ("final_particles", "final_log_weights", "ess"):
                assert torch.equal(getattr(res, key), getattr(mine, key)), \
                    f"d={d}: {tree}'s run differs in {key}"
            assert float(res.log_evidence) == float(mine.log_evidence), \
                f"d={d}: {tree}'s log-evidence differs"

        for tree in walks:  # their warm-ups
            same(run(tree, 0), tree)
        trees = [None] + list(walks)
        best = {tree: math.inf for tree in trees}
        for tree in [t for root in walks for t in (None, root, root, None)] \
                or [None] * 3:
            t0 = time.perf_counter()
            res = run(tree, 0)
            best[tree] = min(best[tree], time.perf_counter() - t0)
            if tree is not None:
                same(res, tree)
        for tree in trees:
            for _ in range(5):  # the profiler can record no kernel at all
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run(tree, 0)
                    wall = time.perf_counter() - t0
                kern = [e for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
                if kern:
                    break
            busy = sum(e.self_device_time_total for e in kern) / 1e6 / wall
            walk_us = sum(e.self_device_time_total for e in kern
                          if "roll" in e.key)
            print(f"  composed metropolis N=2^20 T={steps} d={d} B=10, "
                  f"{'this tree' if tree is None else tree}'s roll walk: "
                  f"{n * (steps - 1) / best[tree]:.6g} particle-steps/s "
                  f"(best {best[tree]:.4f} s), device busy {busy:.3f}, the "
                  f"walk {walk_us / 1e3 / (steps - 1):.4f} ms a step, "
                  f"{walk_us / 1e6 / wall:.3f} of the wall time [{card}]")
        if walks:
            print(f"  d={d}: every other tree's run bitwise this tree's "
                  f"(final particles, log weights, ESS, log-evidence "
                  f"{float(mine.log_evidence):.6f})")


# -- the pallas rows with each tree's fused kernels ------------------------

def fused_row(card, others) -> None:
    """The fused ("pallas") rows of phases 4b and 4g with this tree's
    fused wrappers and with each ``others`` tree's (its wrappers and
    kernels) in their place, in turns (this, other, other, this) after one
    warm-up each: the headline (MVT df=5, N=2^20, T=200, d=2) and the
    monthly structural DLM (MVN, N=2^20, T=200, d=13, k=1), metropolis
    B=10 and systematic: particle-steps/s (best of 4 with each other tree,
    two rounds of turns), and from one profiled run each
    the device's busy share and the fused kernel's device time a step and
    share of the run's wall time (torch.profiler); each other tree's runs
    bitwise this tree's (final particles and log weights, ESS,
    log-evidence)."""
    import torch

    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc import particle_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    n, steps = N_BIG, 200
    dev = torch.device("cuda")
    rows = (("headline", DLM.create(noise="mvt", df=5.0, device=dev,
                                    **demo_model_params(D))),
            ("structural", monthly_model(dev)))
    names = {"metropolis": ("fused_filter_step", "fused_step_wrapper"),
             "systematic": ("fused_cdf_filter_step", "fused_cdf_wrapper")}
    for label, model in rows:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        _, ys = model.simulate(gen, steps)
        for resampler, kwargs in (("metropolis", {"num_steps": 10}),
                                  ("systematic", None)):
            attr, key = names[resampler]

            def run(tree):
                this = getattr(particle_filter, attr)
                if tree is not None:
                    setattr(particle_filter, attr, dict(others)[tree][key])
                try:
                    res = bootstrap_filter(0, model, ys, n,
                                           resampler=resampler,
                                           resampler_kwargs=kwargs,
                                           engine="pallas",
                                           return_history=False)
                    torch.cuda.synchronize()
                finally:
                    setattr(particle_filter, attr, this)
                return res

            mine = run(None)

            def same(res, tree):
                for name in ("final_particles", "final_log_weights", "ess"):
                    assert torch.equal(getattr(res, name),
                                       getattr(mine, name)), \
                        f"{label} {resampler}: {tree}'s run differs in {name}"
                assert float(res.log_evidence) == float(mine.log_evidence), \
                    f"{label} {resampler}: {tree}'s log-evidence differs"

            trees = [None] + [root for root, _ in others]
            for tree in trees[1:]:
                same(run(tree), tree)
            secs = {tree: [] for tree in trees}
            for tree in [t for root in trees[1:]
                         for t in (None, root, root, None)] * 2 \
                    or [None] * 3:
                t0 = time.perf_counter()
                res = run(tree)
                secs[tree].append(time.perf_counter() - t0)
                if tree is not None:
                    same(res, tree)
            best = {tree: min(v) for tree, v in secs.items()}
            for tree in trees:
                busy, fused_us, wall = profiled_run(lambda: run(tree))
                print(f"  {label} pallas {resampler} N=2^20 T={steps}, "
                      f"{'this tree' if tree is None else tree}'s fused "
                      f"kernel: {n * (steps - 1) / best[tree]:.6g} "
                      f"particle-steps/s (best {best[tree]:.4f} s of "
                      f"{len(secs[tree])}, slowest {max(secs[tree]):.4f} s), "
                      f"device "
                      f"busy {busy:.3f}, the kernel "
                      f"{fused_us / 1e3 / (steps - 1):.4f} ms a step, "
                      f"{fused_us / 1e6 / wall:.3f} of the wall time [{card}]")
            if others:
                print(f"  {label} {resampler}: every other tree's run bitwise "
                      f"this tree's (log-evidence "
                      f"{float(mine.log_evidence):.6f})")


def profiled_run(fn, match="fused"):
    """(busy share, device microseconds of the kernels whose name holds
    ``match``, wall seconds) of one call of ``fn`` under torch.profiler
    (host and device traced); a session that recorded no kernel is run
    again, up to five times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern:
            break
    busy = sum(e.self_device_time_total for e in kern) / 1e6 / wall
    return busy, sum(e.self_device_time_total for e in kern
                     if match in e.key), wall


# The d >= 64 rows, the README's recommended regime for engine="pallas"
# (README.md's table of configurations): the demo model (F = I, so k = d)
# at these widths and state types, metropolis B=10, N=2^20, T=200. They
# run in ``--fused`` (83 s), not in the whole script, whose phase 3 and
# 3c already hold the kernels at these widths.
WIDE_ROWS = ((64, "float32"), (64, "bfloat16"), (128, "bfloat16"),
             (128, "float32"))
WIDE_STEPS = 200


def wide_rows(card) -> None:
    """``bootstrap_filter`` on the demo model at d = k = 64 and 128
    (WIDE_ROWS; MVT df=5, N=2^20, T=200, metropolis B=10) through
    engine="pallas" beside engine="xla", in turns (pallas, xla, xla,
    pallas, pallas, xla) after one warm-up each: particle-steps/s and
    ESS/s (best of 3), then from one profiled run each the device's busy
    share and the step kernel's device ms a step (the fused step, or the
    roll walk for xla), and the log-evidence of both engines beside the
    Kalman filter's (float64, on the CPU). Each run's log-evidence must
    be finite; a pallas run launches the fused step (its bfloat16 count
    on a bfloat16 state) T-1 times and no composed kernel, an xla run the
    roll walk T-1 times and no fused kernel."""
    import torch

    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    n, steps = N_BIG, WIDE_STEPS
    for d, dtype in WIDE_ROWS:
        bf16 = dtype == "bfloat16"
        p = demo_model_params(d)
        model = DLM.create(noise="mvt", df=5.0, device="cuda",
                           state_dtype=torch.bfloat16 if bf16 else None, **p)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        _, ys = model.simulate(gen, steps)
        _, _, zk = kalman_filter(ys.double().cpu().numpy(),
                                 **{k: p[k] for k in ("F", "G", "V", "W",
                                                      "m0", "C0")})
        tag = "[bf16]" if bf16 else ""
        used = {"pallas": "fused_filter_step" + tag,
                "xla": "roll_metropolis_sweeps_expspace" + tag}
        kernel_name = {"pallas": "fused", "xla": "roll"}

        def one(engine, seed):
            before = _counts()
            t0 = time.perf_counter()
            res = bootstrap_filter(seed, model, ys, n, resampler="metropolis",
                                   resampler_kwargs={"num_steps": 10},
                                   engine=engine, return_history=False)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = _counts()
            for name in after:
                grown = after[name] - before[name]
                want = steps - 1 if name == used[engine] else 0
                if name == used[engine] or name in FUSED_KERNELS + \
                        COMPOSED_KERNELS or "[bf16]" in name:
                    assert grown == want, \
                        f"d={d} {dtype} {engine}: {name} launched {grown}"
            assert math.isfinite(float(res.log_evidence)), \
                f"d={d} {dtype} {engine}: log-evidence not finite"
            return secs, res

        for engine in ("pallas", "xla"):
            one(engine, 0)
        best = {"pallas": math.inf, "xla": math.inf}
        last = {}
        for rep, engine in enumerate(("pallas", "xla", "xla", "pallas",
                                      "pallas", "xla")):
            secs, last[engine] = one(engine, rep + 1)
            best[engine] = min(best[engine], secs)
        for engine in ("pallas", "xla"):
            res = last[engine]
            busy, kern_us, _ = profiled_run(lambda: bootstrap_filter(
                7, model, ys, n, resampler="metropolis",
                resampler_kwargs={"num_steps": 10}, engine=engine,
                return_history=False), kernel_name[engine])
            print(f"  wide d={d} {dtype} MVT df=5 metropolis engine={engine} "
                  f"N=2^20 T={steps}: {n * (steps - 1) / best[engine]:.6g} "
                  f"particle-steps/s, "
                  f"{float(res.ess.double().sum()) / best[engine]:.6g} "
                  f"ESS/s, best {best[engine]:.4f} s of 3, device busy "
                  f"{busy:.3f}, the {kernel_name[engine]} kernel "
                  f"{kern_us / 1e3 / (steps - 1):.4f} ms a step, logZ "
                  f"{float(res.log_evidence):.3f} (Kalman {zk:.3f}) [{card}]")
        print(f"  pallas / xla rate, d={d} {dtype}: "
              f"{best['xla'] / best['pallas']:.3f}")


def check_take_traffic(name, args) -> None:
    """Phase 5 for take-columns on a path's ``(X, a)``: exactly its plain
    version, and its device time."""
    import torch

    from cusmc_tpu_torch.ops.monotone_gather import take_columns, \
        take_columns_plain

    X, a = args
    assert torch.equal(take_columns(X, a), take_columns_plain(X, a)), \
        f"{name}: values differ"
    mine = device_ms(lambda: take_columns(X, a))
    print(f"  {name}: X {tuple(X.shape)}, {a.numel()} ancestors, values "
          f"equal to the plain version; device time {mine:.4f} ms")


def check_cumsum_traffic(name, w, others) -> None:
    """Phase 5 for the cumsum on a main path's weights ``w``: held to its
    plain version and to float64 as ``_cumsum_case`` holds it, and its
    device time; beside it the device time of the cumsum of each tree in
    ``others``, in the order other, this, this, other, with its largest
    distance from this tree's cdf."""
    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum

    _cumsum_case(w, name)

    def ours(w=w):
        return blocked_cumsum(w)[0]
    line = f"    device time: this tree {device_ms(ours):.4f} ms"
    for root, fns in others:
        gap = float((fns["blocked_cumsum"](w) - ours()).abs().max())
        t = [device_ms(lambda: fns["blocked_cumsum"](w))]
        t += [device_ms(ours), device_ms(ours)]
        t.append(device_ms(lambda: fns["blocked_cumsum"](w)))
        line += (f"; {root} {t[0]:.4f}/{t[3]:.4f} ms (max |cdf - this "
                 f"tree's| {gap:.3e}), this tree {t[1]:.4f}/{t[2]:.4f} ms "
                 "beside it")
    print(line)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one CUDA card.")
    parser.add_argument(
        "--against", nargs="+", default=[], metavar="DIR",
        help="other checkouts of the repo (the parent commit unpacked with "
             "git archive, say): phase 5 times their block-window kernels "
             "and roll walk beside this tree's on the main paths' own "
             "inputs, phase 3 their roll walk and fused kernels at every "
             "width, and two last phases run the composed metropolis rows "
             "with their roll walk and the pallas rows with their fused "
             "kernels")
    parser.add_argument(
        "--timed", nargs="+", default=[], metavar="DIR",
        help="with --fused: other checkouts whose fused kernels drop part "
             "of the work (variants that split the time), timed beside this "
             "tree's at every width and held to nothing")
    parser.add_argument(
        "--fused", action="store_true",
        help="run only the fused kernels' checks: phase 3's fused cases and "
             "the fused kernels at every width the paths give them (held to "
             "each --against tree's and timed beside them), then the pallas "
             "rows of phases 4b and 4g with each tree's fused kernels; "
             "prints no result")
    parser.add_argument(
        "--packed", action="store_true",
        help="run only the composed DLM step's kernels' checks and timings "
             "(phase 3's packed cases, at N = 2^20 and the benchmark's "
             "composed cells' sizes); prints no result")
    parser.add_argument(
        "--rolls", action="store_true",
        help="run only the roll walk's checks: phase 3's widths, the "
             "composed metropolis rows (keeping their inputs) and phase 5 "
             "on those inputs; prints no result")
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
    check_draw_identities()
    build_native()
    others = other_trees(args.against)
    if args.fused:
        with phase("the fused kernels against their plain versions"):
            check_fused_kernels()
        with phase("the fused kernels at every width, beside each tree's"):
            check_fused_widths(others, other_trees(args.timed))
        with phase("the pallas rows with each tree's fused kernels"):
            fused_row(card, others)
        with phase("the d >= 64 rows, pallas beside xla"):
            wide_rows(card)
        print(f"chip_smoke --fused: {time.perf_counter() - t_start:.1f} s; "
              f"card: {card}")
        return 0
    if args.packed:
        with phase("the composed DLM step's kernels against their plain "
                   "versions"):
            check_packed_kernels()
        print(f"chip_smoke --packed: {time.perf_counter() - t_start:.1f} s; "
              f"card: {card}")
        return 0
    if args.rolls:
        with phase("the roll walk at every width"):
            check_roll_widths(others)
        with phase("the composed metropolis rows with each tree's roll "
                   "walk"):
            roll_row(card, others, keep=True)
        with phase("the roll walk on those rows' own inputs"):
            check_traffic(others)
        print(f"chip_smoke --rolls: {time.perf_counter() - t_start:.1f} s; "
              f"card: {card}")
        return 0
    with phase("kernels against their plain versions"):
        rec = check_kernels()
        rec["blocked_cumsum"]["zero_steps"] = check_zero_steps(others)
        rec.update(check_shard_kernels())
        rec.update(check_fused_kernels())
        rec.update(check_packed_kernels())
        walk = rec["roll_metropolis_sweeps_expspace"]
        walk["max_abs_err"] = max(walk["max_abs_err"], check_roll_sweeps())
    with phase("the roll walk at every width"):
        check_roll_widths(others)
    with phase("the fused kernels at every width, beside each tree's"):
        check_fused_widths(others)
    with phase("the kernels at the other models' widths (d = 1; d = 13, "
               "k = 1; PMMH's N = 2^16, d = 1)"):
        for name, err in check_model_kernels().items():
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
    with phase("the kernels on a bfloat16 state (mixed precision)"):
        rec.update(check_bf16_kernels())
    with phase("statistics of the fused kernels"):
        check_statistics()
    with phase("the \"tile\" design's oracle (d = 16, 32 and 64)"):
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
            ("family", "the sharded family and MCMC", family_path),
            ("pmmh", "MCMC part 2, the SMC samplers, PMMH and the "
             "chain-sharded samplers", samplers_path),
            ("graft", "the graft entry, the dry run and the examples",
             graft_path)):
        with phase(title):
            _zero_counts()
            drive(card)
            launches[path] = _counts()
            print(f"  launches on the {path} path: " + ", ".join(
                f"{k} {v}" for k, v in launches[path].items() if v))
    with phase("the block-window kernels on the main paths' own inputs"):
        check_traffic(others)
    if others:
        with phase("the composed metropolis rows with each tree's roll "
                   "walk"):
            roll_row(card, others)
        with phase("the pallas rows with each tree's fused kernels"):
            fused_row(card, others)

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
