"""PyTorch port, ``utils/timing.py``'s spans and host-read counter, and the
``cusmc.*`` spans of ``smc/particle_filter.py``: off, a span is a shared
no-op; under ``torch.profiler`` the filter's spans nest run > setup,
step > phase, finish, with one step span a step and every operator of a
step in a phase; ``record_spans`` totals them on the host; and
``host_scalar.reads`` counts the filter's reads back to the host. The
step factories run on their CPU paths (the fused engines' plain
versions)."""

import json

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter
from cusmc_tpu_torch.utils import timing
from cusmc_tpu_torch.utils.timing import host_scalar, named_scope, \
    record_spans, span_sequence

T, N = 9, 4096
PHASES = ("cusmc.normalize", "cusmc.resample", "cusmc.propagate",
          "cusmc.likelihood", "cusmc.fused_step")
EDGES = ("cusmc.filter.setup", "cusmc.filter.finish")
# The four step factories: generic log-space (a registry key outside the
# exp-space ops), exp-space fast, fused Metropolis, fused CDF.
STEPS = {
    "generic": (dict(resampler="multinomial"),
                ("cusmc.resample", "cusmc.propagate", "cusmc.likelihood")),
    "fast_exp": (dict(resampler="metropolis"),
                 ("cusmc.resample", "cusmc.propagate", "cusmc.likelihood")),
    "fused_metropolis": (dict(engine="pallas", pallas_tile=1024),
                         ("cusmc.fused_step",)),
    "fused_cdf": (dict(engine="pallas", resampler="systematic"),
                  ("cusmc.resample", "cusmc.fused_step")),
}


@pytest.fixture(scope="module")
def model_ys():
    model = DLM.create(device="cpu", noise="mvt", df=5.0,
                       **demo_model_params())
    return model, np.asarray(load_y_sim()[:T], np.float32)


def run(model_ys, seed=3, **kw):
    model, ys = model_ys
    return bootstrap_filter(seed, model, ys, N, return_history=False, **kw)


def outputs(res):
    return (res.final_particles, res.final_log_weights, res.ess,
            res.log_evidence)


def traced_spans(tmp_path, fn):
    """The ``cusmc.*`` spans and the operators of a CPU profile of
    ``fn``: [(start, end, name)] each, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]

    def rows(keep):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events if keep(e))

    spans = rows(lambda e: e.get("cat") == "user_annotation"
                 and e["name"].startswith("cusmc."))
    ops = rows(lambda e: e.get("cat") == "cpu_op")
    return spans, ops


def innermost(spans, t0, t1):
    """The innermost span holding [t0, t1], or None."""
    best = None
    for s, e, name in spans:
        if s <= t0 and t1 <= e and (best is None or s >= best[0]):
            best = (s, e, name)
    return best


def test_off_a_span_is_a_shared_no_op(monkeypatch, model_ys):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert named_scope("cusmc.a") is named_scope("cusmc.b", 7)
    assert span_sequence() is None
    with named_scope("cusmc.a"):
        pass
    run(model_ys)


@pytest.mark.parametrize("kind", list(STEPS))
def test_the_spans_nest_under_the_profiler(tmp_path, model_ys, kind):
    kw, own = STEPS[kind]
    spans, ops = traced_spans(tmp_path, lambda: run(model_ys, **kw))
    names = [n for _, _, n in spans]
    steps = [s for s in spans if s[2] == "cusmc.filter.step"]
    assert names.count("cusmc.filter.run") == 1
    assert all(names.count(n) == 1 for n in EDGES)
    assert len(steps) == T - 1
    for name in own:
        assert names.count(name) == T - 1, name
    assert names.count("cusmc.normalize") == 2 * (T - 1)
    assert not set(names) - set(own) - {"cusmc.normalize", "cusmc.filter.run",
                                         "cusmc.filter.step", *EDGES}
    runs = [s for s in spans if s[2] == "cusmc.filter.run"]
    for s, e, name in spans:
        if name == "cusmc.filter.run":
            continue
        parent = innermost([x for x in spans if x != (s, e, name)], s, e)
        want = ("cusmc.filter.step" if name in PHASES
                else "cusmc.filter.run")
        assert parent is not None and parent[2] == want, (name, parent)
    # Each operator of a step lies in one phase, but the step's stores of
    # its ESS and evidence increment into the run's rows.
    r0, r1 = runs[0][:2]
    loose = set()
    for s, e, name in ops:
        if r0 <= s and e <= r1 and innermost(steps, s, e) is not None:
            inner = innermost(spans, s, e)
            if inner[2] == "cusmc.filter.step":
                loose.add(name)
    assert loose <= {"aten::select", "aten::copy_", "aten::fill_",
                     "aten::as_strided"}, loose


@pytest.mark.parametrize("kind", list(STEPS))
def test_record_spans_totals_each_phase(model_ys, kind):
    kw, own = STEPS[kind]
    with record_spans() as totals:
        run(model_ys, **kw)
    assert totals["cusmc.filter.step"][0] == T - 1
    for name in own:
        assert totals[name][0] == T - 1, name
    assert totals["cusmc.normalize"][0] == 2 * (T - 1)
    for name in ("cusmc.filter.run", *EDGES):
        assert totals[name][0] == 1
    for name, (count, host_s, self_s) in totals.items():
        assert 0 <= self_s <= host_s, name
    run_s = totals["cusmc.filter.run"][1]
    inside = sum(totals[n][1] for n in ("cusmc.filter.step", *EDGES))
    assert inside <= run_s
    assert timing._recorder is None


@pytest.mark.parametrize("kw, reads", [
    (dict(engine="pallas", pallas_tile=1024), 1),      # the log-normaliser
    (dict(engine="pallas", resampler="systematic"), 1),
    (dict(ess_threshold=0.5), T - 1),                   # a decision a step
    (dict(resampler="multinomial", ess_threshold=0.5), T - 1),
    (dict(), 0),                                        # always resample
    (dict(resampler="systematic"), 0),
])
def test_host_reads_a_run(model_ys, kw, reads):
    before = host_scalar.reads
    run(model_ys, **kw)
    assert host_scalar.reads - before == reads


def test_host_scalar_reads_by_dtype():
    before = host_scalar.reads
    assert host_scalar(torch.tensor(True)) is True
    assert host_scalar(torch.tensor(3, dtype=torch.int32)) == 3
    assert isinstance(host_scalar(torch.tensor(3)), int)
    assert host_scalar(torch.tensor(0.5)) == 0.5
    assert host_scalar.reads - before == 4


@pytest.mark.parametrize("kind", list(STEPS))
def test_outputs_are_bitwise_the_same_recorded_or_not(model_ys, kind):
    kw, _ = STEPS[kind]
    plain = outputs(run(model_ys, **kw))
    with record_spans():
        recorded = outputs(run(model_ys, **kw))
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = outputs(run(model_ys, **kw))
    for a, b, c in zip(plain, recorded, profiled):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_record_spans_self_time_leaves_out_children():
    with record_spans() as totals:
        with named_scope("outer"):
            with named_scope("inner"):
                sum(range(20000))
            with named_scope("inner"):
                sum(range(20000))
    count, host_s, self_s = totals["outer"]
    assert count == 1 and totals["inner"][0] == 2
    assert self_s == pytest.approx(host_s - totals["inner"][1], abs=1e-6)
    assert self_s < host_s


def test_a_span_sequence_closes_each_span_before_the_next():
    with record_spans() as totals:
        with named_scope("outer"):
            seq = span_sequence()
            for name in ("a", "b", "a"):
                seq(name)
            seq(None)
        with named_scope("outer"):
            seq = span_sequence()
            seq("a")
            # an error leaves "a" open: the enclosing span drops it
    assert totals["a"][0] == 2 and totals["b"][0] == 1
    assert totals["outer"][0] == 2
    assert span_sequence() is None
