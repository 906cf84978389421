#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up builds (or loads from ``build/cusmc_tpu_torch/``) the port's
kernels, builds the program the cell's traffic names
(``portbench/programs/<program>.py``) on the card from the cell's
configuration, hands over the observations and makes one warm-up run.
The window then runs requests back to back from one caller for
``--seconds`` seconds: each request is one run of the program over the
cell's observations (a ``bootstrap_filter`` run, in every cell so far),
keyed from the seed and its index, ending when its log-evidence and ESS
row are on the host. With ``--trace 1`` the same window is followed by
profiled runs, from which the per-layer metrics are read. Once the
window has closed and the program's state is freed, the plain reference
the traffic names (``portbench/reference/<reference>.py``) runs and
``compare.py`` decides ``correct``.

The last line of standard output is the result, one JSON object. A
machine without the card, or with fewer than the cell asks for, gets no
result and exit code 2; a run in which JAX or the JAX package was
loaded gets none and exit code 3.
"""

import time

_STARTED = time.perf_counter()  # before any other import: set-up's start

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# Every build and kernel cache at a fixed path inside the checkout.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import compare, models, peaks, spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cusmc_tpu")
# Key streams drawn from the seed: the warm-up, the window, the two
# profiled sessions and the reference.
WARM, WINDOW, PROFILED, HOST_TRACED, REFERENCE = range(5)
PROFILED_RUNS = 3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class NoDevice(RuntimeError):
    pass


def key(seed: int, stream: int, index: int) -> int:
    """A 63-bit generator seed for run ``index`` of ``stream``."""
    state = np.random.SeedSequence(
        [seed % (1 << 64), stream, index]).generate_state(2, np.uint64)
    return int(state[0] >> np.uint64(1))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def port_kernels():
    """The port's kernel build (``build_info``, ``library()``)."""
    from cusmc_tpu_torch.ops import kernels

    return kernels


def program(traffic: dict, state_dtype: str | None = None):
    """``make(model, ys, traffic, device)``: the program the traffic names
    (``portbench/programs/<program>.py``), its state in the traffic's
    ``state_dtype`` or in ``state_dtype``."""
    cls = spec.module("programs", traffic["program"]).Program
    dtype = DTYPES[state_dtype or traffic["state_dtype"]]
    return lambda model, ys, tr, device: cls(model, ys, tr, device, dtype)


def reference(traffic: dict):
    """The plain reference the traffic names
    (``portbench/reference/<reference>.py``)."""
    return spec.module("reference", traffic["reference"])


def step_ess(row):
    """The entries of an ESS row that belong to the T - 1 steps the rate
    counts: each step's Kish ESS of the weights its resample starts
    from. The row's first entry, the prior's, belongs to no step."""
    return row[1:]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def flat_cell(cell: dict, traffic: dict) -> dict:
    """The sizes and parameters the metrics read."""
    cfg = cell["config"]
    return {"kind": cfg["model"]["kind"], "d": cfg["d"], "k": cfg["k"],
            "noise": cfg["model"]["noise"], "df": cfg["model"].get("df"),
            **traffic}


def window(prog, seed: int, seconds: float, n: int, steps: int) -> dict:
    """Requests back to back until ``seconds`` have passed; the window
    ends when the last request started in it has its results."""
    lat, logz, ess, sums = [], [], [], []
    attempted = failed = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        attempted += 1
        ts = time.perf_counter()
        try:
            lz, row = prog.run(key(seed, WINDOW, attempted - 1))
        except Exception as exc:  # a raising run fails, and ends the window
            failed += 1
            print(f"portbench: run {attempted - 1} raised {exc!r}",
                  file=sys.stderr)
            break
        lat.append(time.perf_counter() - ts)
        if math.isfinite(lz) and np.all(np.isfinite(row)):
            logz.append(lz)
            ess.append(float(np.mean(step_ess(row))) / n)
            sums.append(float(np.sum(step_ess(row))))
        else:
            failed += 1
    return {"seconds": time.perf_counter() - t0, "latency": lat,
            "logz": logz, "ess": ess, "ess_sums": sums,
            "attempted": attempted, "failed": failed,
            "steps": steps - 1, "n": n}


def end_to_end(w: dict) -> dict:
    runs = len(w["latency"])
    secs = w["seconds"]
    return {
        "particle_steps_per_s": w["n"] * w["steps"] * runs / secs,
        "ess_per_s": sum(w["ess_sums"]) / secs,
        "run_p90_ms": float(np.percentile(w["latency"], 90)) * 1e3
        if runs else math.nan,
    }


def traced(prog, seed: int) -> tuple:
    """The two profiled sessions: the device alone over
    ``PROFILED_RUNS`` runs (kernel times, busy share), then host and
    device over one run (the idle gaps). Returns the context's trace
    part, the breakdown, and the profiled runs' outputs."""
    # One short session first, so that the profiler's own start-up falls
    # outside the measured ones.
    trace.profile(lambda: torch.ones(1, device="cuda").add_(1),
                  with_cpu=False)
    events, wall, outs = trace.profile(
        lambda: [prog.run(key(seed, PROFILED, j))
                 for j in range(PROFILED_RUNS)], with_cpu=False)
    runs = [r for batch in outs for r in batch]
    table = trace.kernel_table(events)
    part = {"groups": trace.groups(table), "kernels": table,
            "busy_s": trace.busy_seconds(events), "window_s": wall}
    host_events, _, outs = trace.profile(
        lambda: prog.run(key(seed, HOST_TRACED, 0)), with_cpu=True)
    runs += outs
    breakdown = {"device_ops": trace.device_ops(table),
                 "idle_gaps": trace.idle_gaps(host_events)}
    for name, row in sorted(table.items(), key=lambda kv: -kv[1]["seconds"]):
        print(f"portbench: kernel {row['group']} {row['count']} "
              f"{row['seconds']:.6f} s {trace.short_name(name)}", flush=True)
    return part, breakdown, runs


def prepare(name: str, seed: int, device: str = "cuda", overrides=None,
            out=sys.stdout) -> dict:
    """Set-up up to the program: the cell, its traffic (with
    ``overrides``), the model's matrices and the observations; the port
    imported from this checkout and, on the card, its kernels built or
    loaded."""
    bench = spec.benchmark()
    cell = spec.load_cell(name, bench)
    chips = int(cell["workload"]["chips"])
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {chips}")
    torch.set_num_threads(2)
    traffic = {**cell["traffic"], **(overrides or {})}
    cfg = cell["config"]
    model = models.matrices(cfg)
    ys = models.observations(cfg, model, int(traffic["steps"]),
                             cfg["observations"].get("seed", seed))
    kernels = port_kernels()
    pkg = Path(sys.modules["cusmc_tpu_torch"].__file__).resolve()
    if ROOT not in pkg.parents:
        raise RuntimeError(f"cusmc_tpu_torch imported from {pkg}, outside "
                           f"the checkout {ROOT}")
    if device == "cuda":
        kernels.library()
        info = kernels.build_info
        print(f"portbench: kernel build {info.get('seconds', 0.0):.3f} s "
              f"({'cached' if info.get('log') == '(cached)' else 'built'}, "
              f"{info.get('path')})", file=out, flush=True)
        print(f"portbench: card {card_line()}; {peaks.line()}", file=out,
              flush=True)
    return {"bench": bench, "cell": cell, "chips": chips,
            "traffic": traffic, "model": model, "ys": ys,
            "n": int(traffic["particles"]), "steps": int(traffic["steps"])}


def judge(w: dict, prep: dict, seed: int, device: str, out=sys.stdout):
    """Run the reference and compare: ``(numbers, correct)``."""
    traffic, model, ys, n = (prep[k] for k in ("traffic", "model", "ys",
                                               "n"))
    t_ref = time.perf_counter()
    ref_mod = reference(traffic)
    ref = [ref_mod.run(model, ys, traffic, key(seed, REFERENCE, j), device)
           for j in range(int(traffic["reference_runs"]))]
    ref_logz = [r[0] for r in ref]
    ref_ess = [float(np.mean(step_ess(r[1]))) / n for r in ref]
    found = compare.numbers(w["logz"], w["ess"], ref_logz, ref_ess)
    correct = compare.verdict(found, traffic["limits"], w["failed"])
    extra = getattr(ref_mod, "describe", lambda *a: "")(model, ys)
    extra = f", {extra}" if extra else ""
    print(f"portbench: {len(w['logz'])} runs compared, reference "
          f"{len(ref)} runs in {time.perf_counter() - t_ref:.1f} s; mean "
          f"log-evidence {np.mean(w['logz']) if w['logz'] else math.nan} "
          f"against {np.mean(ref_logz)}{extra}; mean ESS fraction "
          f"{np.mean(w['ess']) if w['ess'] else math.nan} against "
          f"{np.mean(ref_ess)}", file=out, flush=True)
    return found, correct


def execute(name: str, seed: int, seconds: float, traced_run: bool,
            device: str = "cuda", overrides=None, make_program=None,
            out=sys.stdout):
    """One run of cell ``name``; returns the result dict. ``device``,
    ``overrides`` (traffic keys) and ``make_program`` (in place of the
    traffic's program, as ``program`` makes one) serve the tests and the
    control."""
    prep = prepare(name, seed, device, overrides, out)
    n, steps, chips = prep["n"], prep["steps"], prep["chips"]
    make = make_program or program(prep["traffic"])
    prog = make(prep["model"], prep["ys"], prep["traffic"], device)
    prog.run(key(seed, WARM, 0))
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _STARTED

    w = window(prog, seed, seconds, n, steps)
    if w["latency"]:
        lat = np.asarray(w["latency"]) * 1e3
        print(f"portbench: window {len(lat)} runs in {w['seconds']:.3f} s; "
              f"run ms min {lat.min():.3f} median {np.median(lat):.3f} "
              f"max {lat.max():.3f}; first {lat[0]:.3f}", file=out,
              flush=True)
    result_metrics = {}
    breakdown = None
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": chips if device == "cuda" else 0}
    ctx = {"cell": flat_cell(prep["cell"], prep["traffic"]),
           "ess_fractions": list(w["ess"]),
           "step_seconds": (w["seconds"] / (len(w["latency"]) * w["steps"])
                            if w["latency"] else None)}
    if traced_run and w["failed"] == 0:
        part, breakdown, runs = traced(prog, seed)
        ctx.update(part, steps=PROFILED_RUNS * w["steps"])
        for lz, row in runs:
            w["attempted"] += 1
            if math.isfinite(lz) and np.all(np.isfinite(row)):
                w["logz"].append(lz)
                w["ess"].append(float(np.mean(step_ess(row))) / n)
            else:
                w["failed"] += 1
        dev["busy_s"], dev["window_s"] = part["busy_s"], part["window_s"]
    if device == "cuda":
        torch.cuda.synchronize()
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        print(f"portbench: peak_device_gib "
              f"{dev['memory_peak_bytes'] / 2**30:.4f}", file=out, flush=True)
    else:
        dev["memory_peak_bytes"] = 0
    del prog
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    for m in spec.metrics_of(name, traced_run, prep["bench"]):
        if m["name"] == "setup_s":
            value = setup_s
        elif traced_run:
            value = spec.reader(m["name"])(ctx)
        else:
            value = end_to_end(w)[m["name"]]
        if value is not None and math.isfinite(value):
            result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found, correct = judge(w, prep, seed, device, out)
    limits = prep["traffic"]["limits"]
    result = {"correct": bool(correct), "attempted": w["attempted"],
              "failed": w["failed"], "metrics": result_metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": _number(found[k]), "limit": limit}
                          for k, limit in limits.items()}
    return result


def _number(x):
    """A JSON number, or null for a value that is not finite."""
    return x if math.isfinite(x) else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = execute(args.workload, args.seed, args.seconds,
                         bool(args.trace))
    except NoDevice as exc:
        print(f"portbench: {exc}; no result", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}; "
              f"no result", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
