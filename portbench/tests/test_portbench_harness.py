"""The harness on the CPU: ``BENCHMARK.json`` and every file it names,
the rules names and units keep, the per-layer metrics' readers, the
reference filter against the Kalman filter, and a short run of each cell
through the program's CPU path. ``test_cells_on_the_card`` needs the
card (marker ``cuda``) and skips without one."""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import compare, models, run, spec, trace  # noqa: E402
from portbench.reference import filter as reference  # noqa: E402
from portbench.reference import kalman  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"particles": 4096, "steps": 24, "reference_runs": 6, "tile": 1024}


def test_benchmark_has_exactly_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_keep_to_their_characters():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config",
                                                         "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        own = [e["name"] for e in BENCH[k]]
        assert len(own) == len(set(own))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_every_file_loads_and_names_an_existing_configuration():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("portbench/")
        mats = models.matrices(cfg)
        assert mats["G"].shape == (cfg["d"], cfg["d"])
        assert mats["F"].shape == (cfg["k"], cfg["d"])
    for path in sorted((ROOT / "portbench" / "workloads").glob("*.json")):
        traffic = json.loads(path.read_text())
        users = [w for w in BENCH["workloads"] if w["traffic"] == path.stem]
        assert users, f"{path.name} is no cell's traffic"
        for w in users:
            assert w["config"] in configs
            cfg = json.loads((ROOT / configs[w["config"]]["file"])
                             .read_text())
            assert traffic["steps"] <= cfg["observations"]["rows"]
        assert traffic["limits"]
        assert set(traffic["limits"]) <= set(compare.NUMBERS)
        assert traffic["state_dtype"] in run.DTYPES
        assert spec.module("programs", traffic["program"]).Program
        ref = spec.module("reference", traffic["reference"])
        assert callable(ref.resampler(traffic["reference_resampler"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads", CELLS)
        reporting = e2e[m["moves"]].get("workloads", CELLS)
        assert set(cells) <= set(reporting)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert callable(spec.reader(m["name"]))
    for cell in CELLS:
        names = [m["name"] for m in spec.metrics_of(cell, False, BENCH)]
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics_of(cell, True, BENCH)


def test_one_layer_name_for_each_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_readers_find_nothing_in_an_empty_trace():
    ctx = {"cell": {"d": 2, "k": 2, "noise": "mvt", "df": 5.0,
                    "particles": 1 << 22, "resampler": "metropolis",
                    "num_sweeps": 10}, "groups": {}, "steps": 199,
           "busy_s": 0.0, "window_s": 1.0, "ess_fractions": [],
           "step_seconds": None}
    for m in BENCH["per_layer"]:
        assert spec.reader(m["name"])(ctx) is None, m["name"]


def test_reference_filter_agrees_with_kalman_on_the_monthly_model():
    cfg = json.loads((ROOT / "portbench/configs/monthly-d13-mvn.json")
                     .read_text())
    model = models.matrices(cfg)
    ys = models.simulate(model, 36, 0)
    exact = kalman.log_likelihood(model, ys)
    traffic = {"particles": 1 << 15, "resampler": "systematic",
               "engine": "auto", "reference_resampler": "systematic"}
    z = [reference.run(model, ys, traffic, s, "cpu")[0] for s in range(6)]
    se = np.std(z, ddof=1) / np.sqrt(len(z))
    assert abs(np.mean(z) - exact) < 4 * se + 0.05


def test_kalman_of_a_scalar_random_walk():
    model = {"F": [[1.0]], "G": [[1.0]], "V": [[1.0]], "W": [[1.0]],
             "C0": [[1.0]], "m0": [0.0]}
    ys = np.array([[0.0], [0.5]])
    # y_1 ~ N(0, C0 + W + V) = N(0, 3)
    want = -0.5 * np.log(2 * np.pi * 3.0) - 0.5 * 0.25 / 3.0
    assert kalman.log_likelihood(model, ys) == pytest.approx(want)


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_on_the_cpu_is_correct(cell):
    result = run.execute(cell, 2**31 + 17, 1.0, False, device="cpu",
                         overrides=SMALL)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {m["name"] for m in
                                      spec.metrics_of(cell, False, BENCH)}
    assert list(result)[-1] == "compared"


def test_observations_are_the_same_for_the_same_seed():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        m = models.matrices(cfg)
        a = models.observations(cfg, m, 20, 7)
        b = models.observations(cfg, m, 20, 7)
        assert np.array_equal(a, b) and np.all(a[0] == 0)


@pytest.mark.parametrize("name, group", [
    ("void roll_metropolis_kernel<unsigned int>(float const*, int)",
     "roll_walk"),
    ("void roll_apply_band_kernel<float>(float const*, int)", "roll_walk"),
    ("void (anonymous namespace)::scan_kernel(float const*, float*)",
     "cdf_cumsum"),
    ("void inverse_cdf_apply_kernel<4, float>(float const*)", "cdf_search"),
    ("void fused_step_kernel<16, 1, float>(Args)", "fused_step"),
    ("void fused_cdf_tile_kernel<32, 32>(Args)", "fused_cdf_step"),
    ("Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>(Params)",
     "composed"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::exp_kernel_cuda>(int)", "composed"),
])
def test_the_one_map_of_kernel_names_to_groups(name, group):
    lmap = trace.layer_map()
    assert trace.classify(name, lmap)[0] == group
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert trace.classify(name, lmap)[1] in layers


def test_the_ess_of_a_step_leaves_out_the_prior():
    row = np.array([8.0, 8.0, 5.0, 3.0])
    assert list(run.step_ess(row)) == [8.0, 5.0, 3.0]


def test_the_traffic_state_dtype_reaches_the_program():
    cell = spec.load_cell("demo_d2_metropolis", BENCH)
    model = models.matrices(cell["config"])
    ys = models.observations(cell["config"], model, 4, 0)
    for name, dtype in run.DTYPES.items():
        traffic = {**cell["traffic"], "particles": 256, "state_dtype": name}
        prog = run.program(traffic)(model, ys, traffic, "cpu")
        assert prog.model.state_dtype == dtype


def test_a_module_is_found_by_its_name_alone():
    assert spec.module("model_kinds", "structural").matrices
    with pytest.raises(ValueError):
        spec.module("programs", "../run")
    with pytest.raises(FileNotFoundError):
        spec.module("programs", "no_such_program")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = run.execute(cell, 2**31 + 29, 2.0, True)
    assert result["correct"], result["compared"]
    assert result["device"]["busy_s"] > 0
    for m in result["metrics"]:
        if result["metrics"][m]["unit"] == "%":
            assert 0 <= result["metrics"][m]["value"] <= 100, m
