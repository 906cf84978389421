#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cusmc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. The card's name and power limit, from nvidia-smi.
2. Build: nvcc compiles the port's kernels (cusmc_tpu_torch/csrc/*.cu).
3. Kernels: each kernel against its plain PyTorch version on the same
   tensors, at N = 2^20 and at a ragged N, d = 2, with the tolerance stated
   beside each check; then the kernel's and the plain version's times per
   call (CUDA events, median of 20, launch cost included) and their device
   time per call (torch.profiler).
4. The main path, through the entry points a user calls, with every
   launch count set to 0 first: ``run()`` at the README quick start (MVT
   df=5, metropolis, N=10000, the 1001-step bundled trace); MVN systematic
   and MVN metropolis on the same trace, with log-evidence held against the
   Kalman filter at 2% of |loglik|; the headline (MVT df=5, N=2^20, T=200,
   d=2, no history) for metropolis B=10 and for systematic, one warm-up and
   the best of 3, as particle-steps/s = N (T-1) / s and ESS/s. Every run
   must have launched each of its kernels at least T-1 times.

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
D = 2
TIMING_REPS = 20


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


def build_kernels() -> float:
    from cusmc_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.library()
    seconds = time.perf_counter() - t0
    info = kernels.build_info
    print(f"build: {seconds:.2f} s (nvcc {info.get('seconds', 0.0):.2f} s) "
          f"-> {info.get('path')}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
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
    bound = (25 + tiles) * torch.finfo(torch.float32).eps * total
    err64 = float((cdf.double() - ref).abs().max())
    err_plain = float((cdf - plain).abs().max())
    assert bool(torch.all(cdf[1:] >= cdf[:-1])), f"{name}: cdf not monotone"
    assert err64 <= bound, f"{name}: |cdf - f64| = {err64} > {bound}"
    assert torch.equal(cdf128, cdf[FOLD - 1::FOLD])
    print(f"  cumsum {name}: N={n} max|kernel-f64|={err64:.3e} "
          f"max|kernel-plain|={err_plain:.3e} bound={bound:.3e} monotone")
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
    """Phase 3: agreement and timing of every kernel. Returns per-kernel
    records (``max_abs_err``, ``ms``, ``plain_ms`` at N = 2^20)."""
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
        timings = {
            "blocked_cumsum": (lambda: blocked_cumsum(w_exp),
                               lambda: blocked_cumsum_plain(w_exp)),
            "inverse_cdf_apply": (
                lambda: inverse_cdf_apply(cdf, pos, X),
                lambda: inverse_cdf_apply_plain(cdf, pos, X)),
            "roll_metropolis_sweeps_expspace": (
                lambda: roll_metropolis_sweeps_expspace(w_exp, shifts, u, X),
                lambda: roll_metropolis_sweeps_expspace_plain(
                    w_exp, shifts, u, X)),
        }
        for (name, (kern, plain)), err in zip(
                timings.items(), (max(errs), max(serrs), max(rerrs))):
            # Alternate plain, kernel, kernel, plain; keep the medians.
            p1 = median_ms(plain)
            k1 = median_ms(kern)
            k2 = median_ms(kern)
            p2 = median_ms(plain)
            rec[name] = {"max_abs_err": err, "ms": min(k1, k2),
                         "plain_ms": min(p1, p2)}
            print(f"  time {name} N=2^20 d={D}: kernel {k1:.4f}/{k2:.4f} ms, "
                  f"plain {p1:.4f}/{p2:.4f} ms per call (CUDA events, "
                  f"median of {TIMING_REPS}); device time per call: kernel "
                  f"{device_ms(kern):.4f} ms, plain {device_ms(plain):.4f} ms "
                  f"(torch.profiler, {TIMING_REPS} calls)")
    torch.cuda.synchronize()
    return rec


KERNELS = (
    ("blocked_cumsum", "cusmc_tpu_torch/csrc/cumsum.cu",
     "cusmc_tpu/ops/cumsum.py:45"),
    ("inverse_cdf_apply", "cusmc_tpu_torch/csrc/monotone_gather.cu",
     "cusmc_tpu/ops/monotone_gather.py:277"),
    ("roll_metropolis_sweeps_expspace", "cusmc_tpu_torch/csrc/rolls.cu",
     "cusmc_tpu/resampling/rolls.py:109"),
)


def _wrappers():
    from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
    from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply
    from cusmc_tpu_torch.resampling.rolls import \
        roll_metropolis_sweeps_expspace

    return {"blocked_cumsum": blocked_cumsum,
            "inverse_cdf_apply": inverse_cdf_apply,
            "roll_metropolis_sweeps_expspace":
                roll_metropolis_sweeps_expspace}


def _counts():
    return {k: f.launches for k, f in _wrappers().items()}


def _expect_launches(before, after, used, steps, label):
    for name in used:
        grown = after[name] - before[name]
        assert grown >= steps, f"{label}: {name} launched {grown} times, " \
            f"expected >= {steps}"
    print(f"  {label}: launches " + ", ".join(
        f"{k}+{after[k] - before[k]}" for k in after))


CDF_KERNELS = ("blocked_cumsum", "inverse_cdf_apply")
ROLL_KERNELS = ("roll_metropolis_sweeps_expspace",)


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
    _expect_launches(before, _counts(), ROLL_KERNELS, T - 1, "quick start")

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
        _expect_launches(before, _counts(), used, T - 1, f"kalman {resampler}")

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
                         f"headline {resampler}")


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

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_kernels()
    print("kernels against their plain versions:")
    rec = check_kernels()

    print("main path:")
    for f in _wrappers().values():
        f.launches = 0
    main_path(card)
    launches = _counts()

    records = []
    for name, source, replaces in KERNELS:
        assert launches[name] > 0, f"{name} never launched on the main path"
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rec[name]})
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
