"""The program's own spans (``cusmc.*``, opened by
``cusmc_tpu_torch.utils.timing.named_scope``) and its host-read counter
(``host_scalar.reads``), read for the per-layer metrics of the filter's
phases.

From a Chrome trace of a session that recorded the host and the device:

- ``program_spans``: the ``user_annotation`` events named ``cusmc.*``,
  by host thread;
- ``device_by_span``: each device operation's seconds go to the innermost
  program span around its launch on the launching thread (the launch is
  the runtime or driver call with the operation's correlation id); an
  operation launched outside every span goes to ``None``;
- ``idle_split``: the device's idle time, in-step (gaps ended by an
  operation launched inside a ``cusmc.filter.step``) and at a run's edges
  (every other gap: set-up, finish, the read-back, and from the run's
  start to its first device operation).

``readings(ctx)`` runs, once a traced run, on the cell's program built
again as the harness builds it: one run under torch.profiler with the
host traced (the run keyed as the harness's host-traced one), then a host
probe at ``PROBE_PARTICLES`` particles, where the device waits on the
host: one warm-up run, then ``PROBE_RUNS`` runs under ``record_spans()``
with no profiler, keyed from the stream ``HOST_PROBE``. The probe's runs
are no requests: nothing counts them as attempted or compares their
outputs, and an error in one propagates. A program without the spans (or
without a card) gives None, and every reader then finds nothing.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import io
import json
import sys
from collections import Counter, defaultdict

from portbench import trace

PREFIX = "cusmc."
RUN = "cusmc.filter.run"
STEP = "cusmc.filter.step"
EDGES = ("cusmc.filter.setup", "cusmc.filter.finish")
PHASES = ("cusmc.normalize", "cusmc.resample", "cusmc.propagate",
          "cusmc.likelihood", "cusmc.fused_step")
HOST_PROBE = 5  # a key stream after the harness's five
PROBE_PARTICLES = 1 << 14
PROBE_RUNS = 20


def program_spans(events) -> dict:
    """tid -> [(start, end, name)] of the ``cusmc.*`` spans, in order of
    start (microseconds), the outer first where two start together."""
    out = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith(PREFIX)):
            s = float(e["ts"])
            out[e.get("tid")].append((s, s + float(e.get("dur", 0)),
                                      e["name"]))
    for rows in out.values():
        rows.sort(key=lambda r: (r[0], -r[1]))
    return dict(out)


def launches(events) -> dict:
    """correlation id -> the runtime or driver call that launched it."""
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                out[corr] = e
    return out


class _Spans:
    """The innermost span around a time on a thread: spans nest, so it
    is the latest-starting one that has not ended."""

    def __init__(self, by_tid: dict):
        self.by_tid = by_tid
        self.starts = {tid: [r[0] for r in rows]
                       for tid, rows in by_tid.items()}

    def at(self, tid, t: float):
        rows = self.by_tid.get(tid, [])
        for j in range(bisect.bisect_right(self.starts.get(tid, []), t) - 1,
                       -1, -1):
            if rows[j][1] >= t:
                return rows[j][2]
        return None


def _launch_span(lookup: _Spans, calls: dict, op):
    call = calls.get((op.get("args") or {}).get("correlation"))
    return None if call is None else lookup.at(call.get("tid"),
                                               float(call["ts"]))


def device_by_span(events, cats=trace.DEVICE_CATS) -> dict:
    """Device seconds by the innermost ``cusmc.*`` span around each
    operation's launch (operations of the categories ``cats``); the
    seconds of operations launched outside every span under ``None``."""
    lookup, calls = _Spans(program_spans(events)), launches(events)
    out = defaultdict(float)
    for op in trace.device_events(events):
        if op.get("cat") in cats:
            out[_launch_span(lookup, calls, op)] += \
                float(op.get("dur", 0.0)) * 1e-6
    return dict(out)


def idle_split(events) -> tuple:
    """``(in_step_s, edge_s)``: the device's idle gaps between operations,
    in-step where the operation that ends the gap was launched inside a
    ``cusmc.filter.step``, else at the edges, with the time from the first
    ``cusmc.filter.run``'s start to the first operation."""
    spans = program_spans(events)
    steps = _Spans({tid: [r for r in rows if r[2] == STEP]
                    for tid, rows in spans.items()})
    calls = launches(events)
    ops = sorted(trace.device_events(events), key=lambda e: float(e["ts"]))
    in_step = edge = 0.0
    runs = [r[0] for rows in spans.values() for r in rows if r[2] == RUN]
    if ops and runs:
        edge += max(0.0, float(ops[0]["ts"]) - min(runs)) * 1e-6
    end = None
    for op in ops:
        s = float(op["ts"])
        if end is not None and s > end:
            if _launch_span(steps, calls, op) == STEP:
                in_step += (s - end) * 1e-6
            else:
                edge += (s - end) * 1e-6
        t = s + float(op.get("dur", 0))
        end = t if end is None else max(end, t)
    return in_step, edge


def summary(events, probe=None, reads=None) -> dict:
    """The figures the metrics read: from a host-traced session's
    ``events``, device ms a step by span (``device_ms``; over the
    session's ``cusmc.filter.step`` spans), the unattributed share of the
    device time, the phases' device time against every kernel's less the
    set-up's and the finish's, and the idle ms a run in-step and at the
    edges; from the probe's ``record_spans`` totals, host and self ms a
    step by span; ``reads``: host reads a probe run."""
    counts = Counter(r[2] for rows in program_spans(events).values()
                     for r in rows)
    steps, runs = counts[STEP], counts[RUN]
    out = {"device_ms": {}, "host_ms": {}, "self_ms": {},
           "reads_per_run": reads, "edge_idle_ms": None,
           "in_step_idle_ms": None, "unattributed_share": None,
           "phase_ratio": None}
    if steps:
        dev = device_by_span(events)
        out["device_ms"] = {k: v * 1e3 / steps for k, v in dev.items()
                            if k is not None}
        total = sum(dev.values())
        out["unattributed_share"] = dev.get(None, 0.0) / total \
            if total else None
        kern = device_by_span(events, ("kernel",))
        rest = sum(kern.values()) - sum(kern.get(k, 0.0) for k in EDGES)
        phases = sum(kern.get(k, 0.0) for k in PHASES)
        out["phase_ratio"] = phases / rest if rest > 0 else None
    if runs:
        in_step, edge = idle_split(events)
        out["in_step_idle_ms"] = in_step * 1e3 / runs
        out["edge_idle_ms"] = edge * 1e3 / runs
    if probe and probe.get(STEP):
        probe_steps = probe[STEP][0]
        out["host_ms"] = {k: v[1] * 1e3 / probe_steps
                          for k, v in probe.items()}
        out["self_ms"] = {k: v[2] * 1e3 / probe_steps
                          for k, v in probe.items()}
    return out


def value(ctx: dict, part: str, name: str | None = None):
    """One figure of the cell's ``readings``: ``part``, or its entry
    ``name``; None where there is nothing to read."""
    r = readings(ctx)
    if r is None:
        return None
    return r.get(part) if name is None else r.get(part, {}).get(name)


def readings(ctx: dict):
    """The cell's ``summary``, measured once a traced run (kept in
    ``ctx["spans"]``), or None."""
    if "spans" not in ctx:
        ctx["spans"] = _measure(ctx)
    return ctx["spans"]


def _seed() -> int:
    """The run's ``--seed``, from the harness's command line."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:])[0].seed


def _cell_name(flat: dict, harness):
    """The cell of ``BENCHMARK.json`` whose files give the run's cell
    (``ctx["cell"]``), or None."""
    from portbench import spec

    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        if harness.flat_cell(cell, cell["traffic"]) == flat:
            return w["name"]
    return None


def _measure(ctx: dict):
    import torch

    if not torch.cuda.is_available():
        return None
    from cusmc_tpu_torch.utils import timing

    if not hasattr(timing, "record_spans"):
        return None
    from portbench import run as harness

    name = _cell_name(ctx.get("cell"), harness)
    if name is None:
        return None
    seed = _seed()

    def build(overrides=None):
        prep = harness.prepare(name, seed, "cuda", overrides, io.StringIO())
        make = harness.program(prep["traffic"])
        return make(prep["model"], prep["ys"], prep["traffic"], "cuda")

    prog = build()
    prog.run(harness.key(seed, harness.WARM, 0))
    events, _, _ = trace.profile(
        lambda: prog.run(harness.key(seed, harness.HOST_TRACED, 0)),
        with_cpu=True)
    del prog
    gc.collect()
    torch.cuda.empty_cache()

    prog = build({"particles": PROBE_PARTICLES})
    prog.run(harness.key(seed, HOST_PROBE, 0))
    torch.cuda.synchronize()
    before = timing.host_scalar.reads
    with timing.record_spans() as totals:
        for j in range(1, PROBE_RUNS + 1):
            prog.run(harness.key(seed, HOST_PROBE, j))
    reads = (timing.host_scalar.reads - before) / PROBE_RUNS
    del prog
    gc.collect()
    torch.cuda.empty_cache()

    out = summary(events, dict(totals), reads)
    _print(out)
    return out


def _print(out: dict):
    names = sorted(set(out["device_ms"]) | set(out["host_ms"]))
    for n in names:
        print(f"portbench: span {n} device_ms/step "
              f"{out['device_ms'].get(n, 0.0):.6f} host_ms/step "
              f"{out['host_ms'].get(n, 0.0):.6f} self_ms/step "
              f"{out['self_ms'].get(n, 0.0):.6f}", flush=True)
    print("portbench: spans " + json.dumps(
        {k: out[k] for k in ("unattributed_share", "phase_ratio",
                             "in_step_idle_ms", "edge_idle_ms",
                             "reads_per_run")}), flush=True)
