"""Timing and profiling helpers.

Port of ``cusmc_tpu/utils/timing.py``. A CUDA call returns before the card
has finished, so every clock here stops after the work it times has ended:

- ``sync_time``: the best wall time of ``reps`` calls, each ending in
  ``torch.cuda.synchronize()`` when the output (or an argument) lives on
  the card; the first call (the kernels' build, caches) is left out.
- ``scan_slope``: the per-step cost of a loop, the slope between two
  horizon lengths, each run timed with CUDA events on the card (the host
  clock on the CPU): the slope cancels the launch and set-up cost.
- ``trace``: ``torch.profiler`` over a block, its Chrome trace written to
  ``log_dir``; ``named_scope``: ``torch.profiler.record_function``, a
  named range in that trace.
- ``Timer``: the reference's start/stop/elapsed timer, whose stop
  synchronises.

Each works on the CPU too.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch

named_scope = torch.profiler.record_function


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif hasattr(out, "__dataclass_fields__"):
        for name in out.__dataclass_fields__:
            yield from _tensors(getattr(out, name))


def _force(*outs) -> None:
    """Wait for the card when any tensor of ``outs`` lives on it."""
    for t in _tensors(outs):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def sync_time(fn: Callable, *args, reps: int = 5) -> float:
    """Best-of-``reps`` wall time (seconds) of ``fn(*args)``, each call
    waiting for the card; the first call is excluded."""
    _force(fn(*args), args)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _force(out, args)
        best = min(best, time.perf_counter() - t0)
    return best


def _run_seconds(fn: Callable, carry, reps: int) -> float:
    """Best of ``reps`` runs of ``fn(carry)``: CUDA events for a carry on
    the card, the host clock otherwise."""
    on_card = any(t.is_cuda for t in _tensors(carry))
    best = float("inf")
    for _ in range(reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(carry)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn(carry)
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return best


def scan_slope(mk_scan: Callable, carry, steps: Tuple[int, int] = (4, 16),
               reps: int = 3) -> float:
    """Per-step seconds of a loop: ``mk_scan(carry, T=T)`` runs T steps.

    Returns (time(T2) - time(T1)) / (T2 - T1), free of the fixed cost of
    a call."""
    t1, t2 = steps
    times = []
    for T in (t1, t2):
        def run(c, T=T):
            return mk_scan(c, T=T)

        _force(run(carry), carry)  # warm-up
        times.append(_run_seconds(run, carry, reps))
    return (times[1] - times[0]) / (t2 - t1)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (host, and the card when
    there is one) and write its Chrome trace into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Phase timer with the reference's start/stop/elapsed interface;
    ``stop(out)`` waits for the card when ``out`` holds a tensor on it."""

    def __init__(self):
        self._t0 = None
        self.elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, out=None) -> float:
        if out is not None:
            _force(out)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed
