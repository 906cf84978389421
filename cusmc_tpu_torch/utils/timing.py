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
  ``log_dir``.
- ``named_scope(name, args=None)``: a span. While a ``torch.profiler``
  session records, it is ``torch.profiler.record_function``: the span lands
  in the Chrome trace on the clock of the device operations it launches.
  Inside ``record_spans()`` it adds its host time to that block's totals.
  Otherwise it is one shared no-op context, a check of two flags.
- ``span_sequence()``: spans one after another (a loop's steps, a
  step's phases); None, a truth test a span, while nothing records.
- ``record_spans()``: host totals of every span closed in the block, by
  name, ``{name: (count, host_s, self_s)}``; self time leaves out the
  child spans. No profiler runs.
- ``host_scalar(t)``: the one way a filter run reads a 0-d tensor back
  to the host; ``host_scalar.reads`` counts the reads.
- ``Timer``: the reference's start/stop/elapsed timer, whose stop
  synchronises.

Each works on the CPU too. The filter's spans (``smc/particle_filter.py``)
are named ``cusmc.*``: ``cusmc.filter.run``, ``.setup``, ``.step`` and
``.finish``, and in a step its phases ``cusmc.normalize``,
``cusmc.resample``, ``cusmc.propagate``, ``cusmc.likelihood`` and
``cusmc.fused_step``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()
_recorder = None  # the recorder of the open ``record_spans`` block


class _Span:
    """A span of ``record_spans``: its host time goes to the totals under
    its name, its time less its child spans' as self time."""

    __slots__ = ("name", "rec", "t0", "child_ns")

    def __init__(self, name: str, rec: "_Recorder"):
        self.name = name
        self.rec = rec

    def __enter__(self):
        self.rec.open.append(self)
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        rec = self.rec
        while rec.open.pop() is not self:  # a child an error left open
            pass
        if rec.open:
            rec.open[-1].child_ns += ns
        count, host_s, self_s = rec.totals.get(self.name, (0, 0.0, 0.0))
        rec.totals[self.name] = (count + 1, host_s + ns * 1e-9,
                                 self_s + (ns - self.child_ns) * 1e-9)
        return False


class _Recorder:
    __slots__ = ("totals", "open")

    def __init__(self):
        self.totals = {}
        self.open = []  # the spans open now, innermost last


def named_scope(name: str, args=None):
    """A span named ``name`` (``args``: anything, made a string only for
    the profiler): ``torch.profiler.record_function`` while a profiler
    records, a span of the open ``record_spans`` block, else a shared
    no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(
            name, None if args is None else str(args))
    if _recorder is not None:
        return _Span(name, _recorder)
    return _NO_SPAN


class _SpanSequence:
    """Spans one after another (``span_sequence``)."""

    __slots__ = ("span",)

    def __init__(self):
        self.span = None

    def __call__(self, name: Optional[str], args=None) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
        if name is not None:
            self.span = named_scope(name, args)
            self.span.__enter__()


def span_sequence() -> Optional[_SpanSequence]:
    """Spans one after another, for a loop or the phases of a step:
    ``seq(name, args)`` ends the span that is open and opens a
    ``named_scope(name, args)``; ``seq(None)`` ends it. None while no
    profiler records and no ``record_spans`` block is open, so that the
    caller pays one call and then a truth test a span: a ``with`` a span
    cost the filter step 1.0-1.6% of its host time at N = 2^14 on the
    H100's host. Whether to record is decided once, at the call."""
    if _autograd_profiler._is_profiler_enabled or _recorder is not None:
        return _SpanSequence()
    return None


@contextlib.contextmanager
def record_spans():
    """Record the host time of every span closed inside the block, without
    a profiler. Yields the totals, ``{name: (count, host_s, self_s)}``,
    filled as the spans close; they stay in memory until the block ends.
    Spans nest on one thread."""
    global _recorder
    outer, _recorder = _recorder, _Recorder()
    try:
        yield _recorder.totals
    finally:
        _recorder = outer


def host_scalar(t: torch.Tensor):
    """The value of the 0-d tensor ``t`` on the host: a ``float``, ``bool``
    or ``int`` by its dtype. Waits for the work that makes ``t``; each call
    counts in ``host_scalar.reads``."""
    host_scalar.reads += 1
    return t.item()


host_scalar.reads = 0


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
