"""The readers of the program's spans (``portbench/spans.py``) on a small
Chrome trace made by hand: device time to the innermost ``cusmc.*`` span
around each launch, found by correlation id on the launching thread; the
device time launched outside every span; idle gaps in-step and at the
run's edges; and the metrics that read them, which find nothing where
their span is absent."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run, spans, spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("propagate_ms_per_step", "likelihood_ms_per_step",
       "resample_ms_per_step", "normalize_ms_per_step", "host_ms_per_step",
       "run_edge_idle_ms", "host_reads_per_run")


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def op(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts,
            "dur": dur, "tid": 7, "args": {"correlation": corr}}


def trace_events():
    """One run of two steps on thread 1; thread 2 holds a span that no
    launch of thread 1 may fall into."""
    return [
        span("cusmc.filter.run", 0, 1000),
        span("cusmc.filter.setup", 0, 100),
        span("cusmc.filter.step", 100, 300),
        span("cusmc.normalize", 100, 50),
        span("cusmc.propagate", 150, 100),
        span("cusmc.normalize", 250, 50),
        span("cusmc.filter.step", 400, 300),
        span("cusmc.resample", 410, 90),
        span("cusmc.filter.finish", 700, 100),
        span("cusmc.likelihood", 0, 2000, tid=2),
        span("aten::mm", 150, 10),  # not the program's: no prefix
        launch(1, 50), launch(2, 160), launch(3, 260), launch(4, 350),
        launch(5, 450), launch(6, 750), launch(7, 1100),
        op(1, 120, 10),                     # lead-in 120 us, an edge
        op(2, 140, 100),                    # gap 10, in-step
        op(3, 260, 20),                     # gap 20, in-step
        op(4, 280, 5, "gpu_memcpy"),        # the step's own store
        op(5, 300, 50),                     # gap 15, in-step
        op(6, 800, 10),                     # gap 450, the finish: edge
        op(7, 1200, 2, "gpu_memcpy"),       # gap 390, the read-back: edge
        op(9, 1300, 0, "gpu_memset"),       # no launch found: edge
    ]


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    got = spans.device_by_span(trace_events())
    want = {"cusmc.filter.setup": 10, "cusmc.propagate": 100,
            "cusmc.normalize": 20, "cusmc.filter.step": 5,
            "cusmc.resample": 50, "cusmc.filter.finish": 10, None: 2}
    assert set(got) == set(want)
    for k, us in want.items():
        assert got[k] == pytest.approx(us * 1e-6), k


def test_device_time_launched_outside_every_span():
    kernels = spans.device_by_span(trace_events(), ("kernel",))
    assert None not in kernels
    assert spans.device_by_span(trace_events())[None] == \
        pytest.approx(2e-6)


def test_idle_splits_in_step_and_edge():
    in_step, edge = spans.idle_split(trace_events())
    assert in_step == pytest.approx(45e-6)
    assert edge == pytest.approx((120 + 450 + 390 + 98) * 1e-6)


def test_summary_per_step_and_per_run():
    probe = {spans.STEP: (4, 0.004, 0.001),
             "cusmc.propagate": (4, 0.002, 0.002)}
    s = spans.summary(trace_events(), probe, 1.0)
    assert s["device_ms"]["cusmc.propagate"] == pytest.approx(0.05)
    assert s["device_ms"]["cusmc.normalize"] == pytest.approx(0.01)
    assert s["phase_ratio"] == pytest.approx(1.0)
    assert s["unattributed_share"] == pytest.approx(2 / 197)
    assert s["edge_idle_ms"] == pytest.approx(1.058)
    assert s["in_step_idle_ms"] == pytest.approx(0.045)
    assert s["host_ms"][spans.STEP] == pytest.approx(1.0)
    assert s["self_ms"][spans.STEP] == pytest.approx(0.25)
    assert s["reads_per_run"] == 1.0


@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_where_its_span_is_absent(name):
    read = spec.reader(name)
    assert read({"spans": None}) is None
    empty = spans.summary([])
    assert read({"spans": empty}) is None
    found = spans.summary(trace_events(), {spans.STEP: (4, 0.004, 0.001)},
                          2.0)
    value = read({"spans": found})
    if name in ("likelihood_ms_per_step",):
        assert value is None  # thread 2's span launched nothing
    else:
        assert value is not None and value >= 0, name


def test_each_new_metric_is_listed_with_its_source():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == ("program_counter"
                               if name == "host_reads_per_run"
                               else "program_span")
        assert m["workloads"]


def test_a_cell_is_found_from_its_files():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"], BENCH)
        flat = run.flat_cell(cell, cell["traffic"])
        assert spans._cell_name(flat, run) == w["name"]
    assert spans._cell_name({"d": 2}, run) is None


def test_readings_without_a_card_are_none_and_kept():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card measures")
    ctx = {"cell": {}}
    assert spans.readings(ctx) is None and "spans" in ctx
