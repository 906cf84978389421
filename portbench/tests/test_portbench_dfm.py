"""The ``dfm`` model kind and its cell on the CPU at a small size (d = 3
factors, k = 20 series, so that k stays past the packed kernels' 16;
N = 4096, T = 40): its matrices from the seed, the port's bootstrap
filter against the reference filter in law under the cell's own limits
and against the Kalman filter's exact log-likelihood, the kind's count of
a step's work, and the likelihood's share of its roofline; and, through the harness at the faults' size of
``test_portbench_control.py``, the sound cell correct and each planted
fault not. The control (the reference wholly in bfloat16) is caught at
the cell's own size alone, on the card: at the faults' size its
``ess_mean_z`` reads some 7.5, under the limit."""

import sys
from pathlib import Path

import numpy as np
import pytest
import test_portbench_control as faults
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import compare, control, models, run, spec, work  # noqa: E402
from portbench.model_kinds import dfm  # noqa: E402
from portbench.reference import filter as reference  # noqa: E402
from portbench.reference import kalman  # noqa: E402

CELL = "fredmd_dfm8_systematic"
SMALL = {"kind": "dfm", "noise": "mvn", "factors": 3, "series": 20,
         "phi": 0.95, "loading_var": 0.0625, "psi_low": 0.3,
         "psi_high": 0.7, "seed": 11}
N, T = 4096, 40
PORT_RUNS, REF_RUNS = 12, 8


def small_model(seed=11):
    model = dfm.matrices({**SMALL, "seed": seed})
    model.update(noise="mvn", df=None)
    return model


@pytest.fixture(scope="module")
def small_runs():
    """The port's and the reference's (log-evidence, ESS fraction) runs
    on the small model's own path, with the cell's traffic."""
    cell = spec.load_cell(CELL)
    traffic = {**cell["traffic"], "particles": N, "steps": T}
    model = small_model()
    ys = models.simulate(model, T, 0)
    prog = run.program(traffic)(model, ys, traffic, "cpu")
    port = [prog.run(run.key(2**33 + 5, run.WINDOW, j))
            for j in range(PORT_RUNS)]
    ref = [reference.run(model, ys, traffic,
                         run.key(2**33 + 5, run.REFERENCE, j), "cpu")
           for j in range(REF_RUNS)]

    def split(rows):
        return ([lz for lz, _ in rows],
                [float(np.mean(run.step_ess(e))) / N for _, e in rows])

    return traffic, model, ys, split(port), split(ref)


def test_matrices_are_fixed_by_the_seed_with_the_stated_shapes():
    a, b, c = small_model(), small_model(), small_model(12)
    for key in ("F", "G", "m0", "C0", "V", "W"):
        assert np.array_equal(a[key], b[key]), key
    assert not np.array_equal(a["F"], c["F"])
    assert a["F"].shape == (20, 3) and a["G"].shape == (3, 3)
    assert a["V"].shape == (20, 20) and a["W"].shape == (3, 3)
    psi = np.diag(a["V"])
    assert np.array_equal(a["V"], np.diag(psi))
    assert np.all((psi >= 0.3) & (psi <= 0.7))
    # Unit stationary factor variance: P = G P G' + W holds at P = I, and
    # the prior is that law.
    assert np.allclose(a["G"] @ a["G"].T + a["W"], np.eye(3))
    assert np.array_equal(a["C0"], np.eye(3)) and not a["m0"].any()


def test_the_configuration_is_the_published_width():
    cfg = spec.load_cell(CELL)["config"]
    model = models.matrices(cfg)
    assert (cfg["d"], cfg["k"]) == (8, 134)
    assert model["F"].shape == (134, 8)
    assert np.array_equal(model["V"], np.diag(np.diag(model["V"])))
    assert cfg["observations"]["rows"] == spec.load_cell(
        CELL)["traffic"]["steps"] == 672


def test_port_and_reference_agree_in_law_under_the_cell_limits(small_runs):
    traffic, _, _, (lz, ess), (ref_lz, ref_ess) = small_runs
    found = compare.numbers(lz, ess, ref_lz, ref_ess)
    assert compare.verdict(found, traffic["limits"], 0), found


def test_port_log_evidence_is_near_the_kalman_log_likelihood(small_runs):
    _, model, ys, (lz, _), _ = small_runs
    exact = kalman.log_likelihood(model, ys)
    var = np.var(lz, ddof=1)
    se = np.sqrt(var / len(lz))
    # The log of the filter's unbiased estimate of the likelihood sits
    # below its log by about half its variance (Jensen): allow that, and
    # four standard errors of the mean either way.
    assert -4 * se <= exact - np.mean(lz) <= 0.5 * var + 4 * se


def test_step_work_counts_a_diagonal_whitening():
    d, k, n = 8, 134, 1 << 20
    cell = {"kind": "dfm", "d": d, "k": k, "noise": "mvn", "df": None,
            "particles": n, "resampler": "systematic"}
    nbytes, flops, peak, ops = dfm.step_work(cell)
    assert flops == (2 * d * d + 2 * d * d + 2 * k * d + 3 * k) * n
    assert flops / n < k * k  # no dense k x k product
    assert nbytes == (8 * d + 4) * n + 4 * k
    dlm_flops, dlm_ops = work.step_ops("cdf", d, k, n, noise="mvn",
                                       df_int=None)
    assert ops == dlm_ops and flops < dlm_flops
    assert models.step_work(cell) == (nbytes, flops, peak, ops)


def test_loglik_least_time_at_the_cell():
    cell = ctx_with({})["cell"]
    nbytes, flops = dfm.loglik_work(cell)
    assert nbytes == 36 * (1 << 20) + 4 * 134
    assert flops == (2 * 134 * 8 + 3 * 134) * (1 << 20)
    # Flops bind: 2.67 GFLOP at the float32 peak against 38 MB.
    assert round(work.least_seconds(nbytes, flops) * 1e3, 4) == 0.0398


def ctx_with(device_ms):
    cell = spec.load_cell(CELL)
    return {"cell": run.flat_cell(cell, cell["traffic"]),
            "spans": {"device_ms": device_ms}}


def test_the_roofline_reads_the_whole_likelihood_phase():
    ctx = ctx_with({"cusmc.likelihood": 1.5, "cusmc.propagate": 0.2})
    least_ms = work.least_seconds(*dfm.loglik_work(ctx["cell"])) * 1e3
    assert spec.reader("obs_loglik_roofline")(ctx) == pytest.approx(
        100 * least_ms / 1.5)


@pytest.mark.parametrize("kind, device_ms", [
    ("dfm", {"cusmc.propagate": 0.2}),  # a program without the span
    ("dfm", {"cusmc.likelihood": 0.0}),
    ("dlm", {"cusmc.likelihood": 1.5}),  # a kind without loglik_work
])
def test_the_roofline_reads_nothing_without_a_phase_or_a_count(kind,
                                                                device_ms):
    ctx = ctx_with(device_ms)
    ctx["cell"]["kind"] = kind
    assert spec.reader("obs_loglik_roofline")(ctx) is None


def test_the_roofline_reads_nothing_without_the_spans_readings():
    ctx = ctx_with({})
    ctx["spans"] = None
    assert spec.reader("obs_loglik_roofline")(ctx) is None


@pytest.mark.parametrize("fault", (None, "state_unchanged", "half_left_out",
                                   "answer_altered"))
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    if fault:
        pf, setup = faults.broken_setup(fault)
        monkeypatch.setattr(pf, "filter_setup", setup)
    result = faults.execute(CELL)
    assert result["correct"] == (fault is None), (fault, result["compared"])


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    traffic = spec.load_cell(CELL)["traffic"]
    result = run.execute(CELL, faults.SEED, spec.benchmark()["run_seconds"],
                         False, make_program=control.control_program(traffic))
    assert not result["correct"], result["compared"]
