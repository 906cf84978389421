"""torch.profiler sessions over traced runs, and what the metrics read
from them: each kernel's launches and device seconds with its group and
layer (``kernel_layers.json``), the union of device operations on the
device timeline (``busy_s``), the device operations that took the most
time, and the idle gaps named by what the host was doing.

The trace is read from the profiler's Chrome trace, written to a
temporary file under ``TMPDIR`` and deleted once read. torch.profiler
has been seen to record no kernel at all in a whole session on the H100;
such a session is run again, up to five times in all.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ATTEMPTS = 5
TOP = 10


def layer_map():
    """The patterns of ``kernel_layers.json``, in its order, and its
    default group and layer."""
    spec = json.loads((Path(__file__).parent / "kernel_layers.json")
                      .read_text())
    groups = [(re.compile(g["pattern"]), g["group"], g["layer"])
              for g in spec["groups"]]
    default = spec["default"]
    return groups, (default["group"], default["layer"])


def classify(name: str, lmap=None):
    """``(group, layer)`` of a device operation's name."""
    groups, default = lmap or layer_map()
    for pattern, group, layer in groups:
        if pattern.search(name):
            return group, layer
    return default


def short_name(name: str) -> str:
    """A kernel's name without its return type, argument list and
    namespaces, cut to 80 characters."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    if name.startswith("void "):
        name = name[5:]
    head, _, tail = name.partition("<")
    head = head.rsplit("::", 1)[-1]
    name = head + ("<" + tail if tail else "")
    return name[:80]


def profile(fn, with_cpu: bool):
    """Run ``fn`` under torch.profiler (the device; with ``with_cpu`` the
    host too) until a session records a kernel, at most ``ATTEMPTS``
    times. Returns ``(events, wall seconds of the last session, outputs of
    every call of fn)``; ``events`` is empty when no session recorded a
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if with_cpu else [])
    outputs = []
    events, wall = [], 0.0
    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        with torch_profile(activities=acts) as prof:
            t0 = time.perf_counter()
            outputs.append(fn())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        if any(e.get("cat") == "kernel" for e in events):
            return events, wall, outputs
        print("portbench: torch.profiler recorded no kernel; profiling "
              "again", flush=True)
    return [], wall, outputs


def device_events(events):
    return [e for e in events if e.get("cat") in DEVICE_CATS
            and e.get("ph") == "X"]


def kernel_table(events, lmap=None) -> dict:
    """name -> {"group", "layer", "count", "seconds"} of every kernel."""
    lmap = lmap or layer_map()
    table = {}
    for e in events:
        if e.get("cat") != "kernel" or e.get("ph") != "X":
            continue
        row = table.get(e["name"])
        if row is None:
            group, layer = classify(e["name"], lmap)
            row = table[e["name"]] = {"group": group, "layer": layer,
                                      "count": 0, "seconds": 0.0}
        row["count"] += 1
        row["seconds"] += float(e.get("dur", 0.0)) * 1e-6
    return table


def groups(table: dict) -> dict:
    out = defaultdict(lambda: {"count": 0, "seconds": 0.0})
    for row in table.values():
        out[row["group"]]["count"] += row["count"]
        out[row["group"]]["seconds"] += row["seconds"]
    return dict(out)


def busy_intervals(events):
    """The union of the device operations' intervals, in microseconds,
    merged and in order."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in device_events(events))
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def busy_seconds(events) -> float:
    return sum(t - s for s, t in busy_intervals(events)) * 1e-6


def device_ops(table: dict) -> list:
    """The kernels that took the most device time: [[layer: name,
    seconds]], at most ``TOP``."""
    rows = sorted(table.items(), key=lambda kv: -kv[1]["seconds"])[:TOP]
    return [[f"{row['layer']}: {short_name(name)}", row["seconds"]]
            for name, row in rows]


def idle_gaps(events) -> list:
    """The device's idle time between operations, summed by what the host
    was doing: the innermost host operation around the launch of the
    device operation that ends each gap (or the runtime call, where no
    host operation encloses it). [[name, seconds]], at most ``TOP``,
    largest first."""
    launches = {}
    ops_by_tid = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == "cpu_op":
            ops_by_tid[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e["name"]))
    starts = {}
    for tid, ops in ops_by_tid.items():
        ops.sort()
        starts[tid] = [o[0] for o in ops]

    def host_op(launch):
        t = float(launch["ts"])
        tid = launch.get("tid")
        ops = ops_by_tid.get(tid, [])
        i = bisect.bisect_right(starts.get(tid, []), t) - 1
        for j in range(i, max(i - 200, -1), -1):
            if ops[j][1] >= t:
                return ops[j][2]
        return launch["name"]

    devs = sorted(device_events(events), key=lambda e: float(e["ts"]))
    sums = defaultdict(float)
    end = None
    for e in devs:
        s = float(e["ts"])
        if end is not None and s > end:
            corr = (e.get("args") or {}).get("correlation")
            launch = launches.get(corr)
            name = host_op(launch) if launch else "unknown"
            sums[name] += (s - end) * 1e-6
        t = s + float(e.get("dur", 0))
        end = t if end is None else max(end, t)
    rows = sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, secs] for name, secs in rows]
