"""PyTorch port, the headless runner and its plumbing: the CLI
(``python -m cusmc_tpu_torch``, __main__.py), ``config.py``,
``utils/timing.py`` and ``utils/debug.debug_mode``, mirroring
tests/test_cli.py, tests/test_config_debug.py and tests/test_timing_misc.py.

Against the JAX package, where nothing random decides the answer:
``FilterConfig``'s dict round trip, ``build_model``'s factors (float32,
rtol 1e-6: both packages factor the same covariances in float32), the
CLI's JSON keys, ``y_t.csv`` byte for byte and ``x_t_N{p}.csv``'s header
and shape, and every exit-2 refusal with its message. The configs are
the JAX tests' own, so a file written for ``python -m cusmc_tpu run``
runs here unchanged. ``--mesh 1`` runs in a subprocess on a one-rank gloo
group; a resumed streaming run returns the first run's log-evidence
exactly.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from cusmc_tpu import config as jax_config
from cusmc_tpu.__main__ import main as jax_main
from cusmc_tpu_torch.__main__ import main
from cusmc_tpu_torch.config import FilterConfig, build_model, run_filter
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter
from cusmc_tpu_torch.smc.streaming import streaming_bootstrap_filter
from cusmc_tpu_torch.utils.debug import debug_mode
from cusmc_tpu_torch.utils.timing import Timer, named_scope, scan_slope, \
    sync_time, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_KEYS = {"command", "config", "num_particles", "timesteps", "resampler",
            "mesh", "stream", "log_evidence", "final_ess", "wall_s",
            "particle_steps_per_sec"}


@pytest.fixture()
def cfg_and_data(tmp_path):
    p = demo_model_params()
    cfg = {
        "num_particles": 512,
        "model": {k: np.asarray(v).tolist() for k, v in p.items()},
        "distribution": "mvn",
        "resampler": "systematic",
        "seed": 1,
    }
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps(cfg))
    datap = tmp_path / "y.csv"
    np.savetxt(datap, load_y_sim()[:40], delimiter=",",
               header="y0,y1", comments="")
    return str(cfgp), str(datap)


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip())


def test_cli_run_writes_reference_csvs(tmp_path, capsys, cfg_and_data):
    cfgp, datap = cfg_and_data
    out_dir, jax_dir = str(tmp_path / "out"), str(tmp_path / "jax_out")
    assert main(["run", "--config", cfgp, "--data", datap, "--output-dir",
                 out_dir, "--track", "3", "--device", "cpu"]) == 0
    line = _line(capsys)
    assert set(line) == RUN_KEYS
    assert np.isfinite(line["log_evidence"])
    assert line["resampler"] == "systematic" and line["timesteps"] == 40
    assert jax_main(["run", "--config", cfgp, "--data", datap,
                     "--output-dir", jax_dir, "--track", "3"]) == 0
    assert set(_line(capsys)) == RUN_KEYS
    assert sorted(os.listdir(out_dir)) == sorted(os.listdir(jax_dir)) == \
        ["x_t_N3.csv", "y_t.csv"]
    with open(os.path.join(out_dir, "y_t.csv"), "rb") as a, \
            open(os.path.join(jax_dir, "y_t.csv"), "rb") as b:
        assert a.read() == b.read()
    x, xj = (np.loadtxt(os.path.join(d, "x_t_N3.csv"), delimiter=",",
                        skiprows=1) for d in (out_dir, jax_dir))
    assert x.shape == xj.shape == (40, 3)
    assert np.isfinite(x).all()
    with open(os.path.join(out_dir, "x_t_N3.csv")) as a, \
            open(os.path.join(jax_dir, "x_t_N3.csv")) as b:
        assert a.readline() == b.readline() == "w,x,x\n"


def test_cli_demo(capsys):
    assert main(["demo", "--particles", "512", "--steps", "30",
                 "--device", "cpu"]) == 0
    line = _line(capsys)
    assert np.isfinite(line["log_evidence"])
    assert line["particle_steps_per_sec"] > 0
    assert jax_main(["demo", "--particles", "64", "--steps", "5"]) == 0
    assert set(_line(capsys)) == set(line)


def test_cli_rejects_unknown_config_keys(tmp_path, cfg_and_data):
    cfgp, datap = cfg_and_data
    cfg = json.loads(open(cfgp).read())
    cfg["not_a_key"] = 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(cfg))
    for run in (main, jax_main):
        with pytest.raises(ValueError, match=r"unknown config keys: "
                                             r"\['not_a_key'\]"):
            run(["run", "--config", str(bad), "--data", datap])


@pytest.mark.parametrize("extra", [
    ["--stream", "8", "--output-dir", "o"],
    ["--stream", "8", "--resume"],
    ["--checkpoint", "ck"],
    ["--resume", "--checkpoint", "ck"],
    ["--output-dir", "o", "--track", "512"],
    ["--output-dir", "o", "--track", "-1"],
], ids=["stream-output-dir", "resume-no-checkpoint",
        "checkpoint-no-stream", "resume-no-stream", "track-high",
        "track-negative"])
def test_cli_refusals_match_jax(tmp_path, capsys, cfg_and_data, extra):
    cfgp, datap = cfg_and_data
    extra = [str(tmp_path / a) if a in ("o", "ck") else a for a in extra]
    args = ["run", "--config", cfgp, "--data", datap] + extra
    assert main(args + ["--device", "cpu"]) == 2
    ours = capsys.readouterr()
    assert jax_main(args) == 2
    theirs = capsys.readouterr()
    assert ours.out == theirs.out == ""
    assert ours.err == theirs.err and ours.err


def test_cli_mesh_without_a_group_is_refused(capsys, cfg_and_data):
    cfgp, datap = cfg_and_data
    assert main(["run", "--config", cfgp, "--data", datap, "--mesh", "2",
                 "--device", "cpu"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "--mesh 2" in captured.err


def test_cli_stream_checkpoint_resume(tmp_path, capsys, cfg_and_data):
    cfgp, datap = cfg_and_data
    ck = str(tmp_path / "snap")
    args = ["run", "--config", cfgp, "--data", datap, "--stream", "8",
            "--checkpoint", ck, "--device", "cpu"]
    assert main(args) == 0
    first = _line(capsys)
    assert first["stream"] == 8 and np.isfinite(first["log_evidence"])
    assert main(args + ["--resume"]) == 0
    second = _line(capsys)
    assert second["log_evidence"] == first["log_evidence"]
    # The streamed run is the one-shot run.
    assert main(["run", "--config", cfgp, "--data", datap,
                 "--device", "cpu"]) == 0
    assert _line(capsys)["log_evidence"] == first["log_evidence"]


def test_cli_mesh_one_rank_group(tmp_path, cfg_and_data):
    # --mesh 1 without a launcher starts a one-rank gloo group on the CPU
    # (its own process: the group lives for the process).
    cfgp, datap = cfg_and_data
    code = textwrap.dedent(f"""
        import json, sys
        from cusmc_tpu_torch.__main__ import main
        base = ["run", "--config", {cfgp!r}, "--data", {datap!r},
                "--mesh", "1", "--device", "cpu"]
        assert main(base) == 0
        assert main(base + ["--stream", "8", "--checkpoint",
                            {str(tmp_path / "ck")!r}]) == 0
        assert main(base) == 0
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.strip().splitlines()]
    assert [ln["mesh"] for ln in lines] == [1, 1, 1]
    assert lines[1]["stream"] == 8
    assert lines[0]["log_evidence"] == lines[1]["log_evidence"] == \
        lines[2]["log_evidence"]


# -- config ---------------------------------------------------------------

class TestFilterConfig:
    def test_roundtrip_and_run(self):
        cfg = FilterConfig(num_particles=128, model=demo_model_params(),
                           resampler="systematic", seed=3,
                           return_history=False)
        cfg2 = FilterConfig.from_dict(cfg.to_dict())
        assert cfg2.resampler == "systematic" and cfg2.seed == 3
        ys = load_y_sim()[:31]
        r1 = run_filter(cfg, ys, "cpu")
        r2 = run_filter(cfg2, ys, "cpu")
        assert torch.equal(r1.final_particles, r2.final_particles)

    def test_mvt_config(self):
        params = dict(demo_model_params(), df=5.0)
        cfg = FilterConfig(num_particles=64, model=params,
                           distribution="mvt", return_history=False)
        result = run_filter(cfg, load_y_sim()[:21], "cpu")
        assert np.isfinite(float(result.log_evidence))

    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError, match="unknown config keys"):
            FilterConfig.from_dict({"num_particles": 8, "model": {},
                                    "bogus": 1})

    def test_fields_and_dicts_equal_jax(self):
        assert [(f.name, f.default) for f in dataclasses.fields(
            FilterConfig)] == [(f.name, f.default) for f in
                               dataclasses.fields(jax_config.FilterConfig)]
        d = dict(num_particles=64, model=dict(demo_model_params(), df=4.5),
                 distribution="mvt", resampler="residual", seed=9,
                 ess_threshold=0.5, resampler_kwargs={"a": 1})
        ours = FilterConfig(**d).to_dict()
        assert ours == jax_config.FilterConfig(**d).to_dict()
        assert FilterConfig.from_dict(ours).to_dict() == ours

    @pytest.mark.parametrize("noise", ["mvn", "mvt"])
    def test_build_model_equals_jax(self, noise):
        model = dict(demo_model_params())
        if noise == "mvt":
            model["df"] = 5.0
        cfg = dict(num_particles=64, model=model, distribution=noise)
        jm = jax_config.build_model(jax_config.FilterConfig(**cfg))
        want = DLM.from_jax_arrays(
            F=np.asarray(jm.F), G=np.asarray(jm.G), m0=np.asarray(jm.m0),
            C0_sqrt=np.asarray(jm.C0_sqrt), W_sqrt=np.asarray(jm.W_sqrt),
            V_chol=np.asarray(jm.V_chol), V_chol_inv=np.asarray(jm.V_chol_inv),
            df=None if jm.df is None else np.asarray(jm.df), noise=jm.noise,
            df_int=jm.df_int, device="cpu")
        got = build_model(FilterConfig(**cfg), "cpu")
        assert got.noise == want.noise and got.df_int == want.df_int
        for name in ("F", "G", "m0", "C0_sqrt", "W_sqrt", "V_chol",
                     "V_chol_inv"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype == torch.float32, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


# -- timing and debug_mode -------------------------------------------------

def test_sync_time_positive():
    assert sync_time(lambda x: (x * 2.0).sum(), torch.ones(1000),
                     reps=2) > 0


def test_scan_slope_measures_per_step():
    def mk(carry, T):
        for _ in range(T):
            carry = carry * 0.999 + 1e-4
        return carry

    assert np.isfinite(scan_slope(mk, torch.ones(10_000), steps=(4, 64),
                                  reps=2))


def test_timer_and_trace(tmp_path):
    t = Timer()
    t.start()
    with trace(str(tmp_path / "prof")):
        with named_scope("add one"):
            out = torch.ones(10) + 1
    elapsed = t.stop(out)
    assert elapsed > 0 and t.elapsed == elapsed
    assert os.listdir(tmp_path / "prof") == ["trace.json"]


def test_debug_mode_names_the_step():
    model = DLM.create(noise="mvn", device="cpu", **demo_model_params())
    ys = np.array(load_y_sim()[:21], np.float32)
    ys[7, 1] = np.nan
    for run in (lambda: bootstrap_filter(0, model, ys, 64,
                                         resampler="systematic"),
                lambda: streaming_bootstrap_filter(
                    0, model, ys, 64, chunk_steps=5, resampler="systematic",
                    halt_on_nonfinite=False)):
        with debug_mode(disable_jit=True):
            with pytest.raises(FloatingPointError, match="at step 7"):
                run()
        run()  # outside the context nothing checks
    with debug_mode():
        res = bootstrap_filter(0, model, load_y_sim()[:11], 64,
                               debug_checks=True, return_history=False)
    assert bool(torch.isfinite(res.log_evidence))
