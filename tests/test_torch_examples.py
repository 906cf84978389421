"""PyTorch port, the examples and the bundled trace.

``examples/torch/01-08``: each ``main(device="cpu", ...)`` at the small
sizes of ``SIZES`` returns the quantities its JAX original prints, each
held to the oracle the original names (``BANDS``). The bands were sized
with ``spread(name, range(16))`` below (16 CPU seeds each, the seed of
every sampler and filter; the data seeds stay the originals'), each band
wider than the 16 seeds' range:

- 01 (N=512, T=100) and 04 (N=1024, T=100, one rank), 06 (N=512 sharded
  streaming and N=1024 auto sweeps, T=100): log evidence finite, ESS
  finite; 06's auto bucket takes only 10, 5 or 3 sweeps, and more than
  one of them.
- 02 (d=16, 64 chains, MH 800, MALA 300, HMC 100, adaptive 800 sweeps):
  every sampler's variance of the second half in (1.0, 1.65) around
  df/(df-2) = 4/3 (16 seeds: MH 1.20-1.46, MALA 1.22-1.40, HMC 1.22-1.45,
  adaptive 1.13-1.54).
- 03 (PMMH, N=128, 100 steps, T=201): posterior median of V in (0.02,
  0.08) around the true 0.04 (16 seeds: 0.036-0.048), acceptance in
  (0.05, 0.9) (0.20-0.45).
- 05 (RBPF N=512, T=50; Liu-West N=1024, T=300): RBPF log evidence
  finite, the last Liu-West estimate of g in (0.6, 0.95) around 0.8
  (0.71-0.81).
- 07 (d=16, ChEES 32 chains x 600 sweeps; PT 32 chains x 600 sweeps):
  PT's right-mode share in (0.3, 0.7) around 0.5 (0.448-0.528), ChEES
  max R-hat below 1.1 (1.016-1.055).
- 08 (N=1024, T=50): straddle share in (0, 1) (0.58-0.64).

For 01 and 08 the port's log evidence at those sizes lies within 4
standard errors of the JAX example's computation (``cusmc_tpu.run`` on
the bundled trace; ``bootstrap_filter`` on the port's UNGM trace) over 8
seeds each. An AST scan checks that no example imports ``jax`` or
``cusmc_tpu``.

The bundled trace: the port's copy is byte for byte the JAX package's, no
code of ``cusmc_tpu_torch/`` names a path into ``cusmc_tpu/`` (docstrings
aside), and ``load_y_sim()`` reads it with ``cusmc_tpu/`` absent.
"""

import _torch_threads  # noqa: F401
import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cusmc_tpu_torch.smc import particle_filter as tpf

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch"
NAMES = ("01_particle_filter", "02_mcmc", "03_pmmh", "04_sharded",
         "05_rbpf_liu_west", "06_sharded_streaming", "07_advanced_mcmc",
         "08_nonlinear_ungm")
SIZES = {
    "01_particle_filter": dict(N=512, T=100),
    "02_mcmc": dict(chains=64, steps=800, mala_steps=300, hmc_steps=100,
                    am_steps=800),
    "03_pmmh": dict(N=128, steps=100),
    "04_sharded": dict(N=1024, T=100),
    "05_rbpf_liu_west": dict(rbpf_N=512, rbpf_T=50, lw_N=1024),
    "06_sharded_streaming": dict(N=512, auto_N=1024, T=100),
    "07_advanced_mcmc": dict(chains=32, steps=600, pt_chains=32,
                             pt_steps=600),
    "08_nonlinear_ungm": dict(N=1024, T=50),
}
MCMC_VAR = (1.0, 1.65)
BANDS = {
    "02_mcmc": {f"{k}.var": MCMC_VAR
                for k in ("mh", "MALA", "HMC", "adaptive-MH")},
    "03_pmmh": {"median_V": (0.02, 0.08), "acceptance": (0.05, 0.9)},
    "05_rbpf_liu_west": {"lw_theta_final": (0.6, 0.95)},
    "07_advanced_mcmc": {"right_share": (0.3, 0.7), "max_rhat": (0.9, 1.1)},
    "08_nonlinear_ungm": {"straddle": (0.0, 1.0)},
}
FINITE = {"01_particle_filter": ("log_evidence", "mean_ess", "rmse"),
          "04_sharded": ("log_evidence", "final_ess"),
          "05_rbpf_liu_west": ("rbpf_log_evidence", "rbpf_final_ess"),
          "06_sharded_streaming": ("streaming_log_evidence", "min_ess",
                                   "auto_log_evidence"),
          "08_nonlinear_ungm": ("log_evidence", "final_ess", "rmse")}
AUTO_SWEEPS = {10, 5, 3}
LOGZ_SEEDS = range(8)
LOGZ_SE = 4.0


def example(name):
    """The example module ``examples/torch/<name>.py``, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(out: dict, prefix="") -> dict:
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_flat(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


def spread(name, seeds) -> dict:
    """Each banded quantity of example ``name`` at ``SIZES`` over
    ``seeds``: (min, max). How ``BANDS`` were sized."""
    runs = [_flat(example(name).main(device="cpu", seed=s, **SIZES[name]))
            for s in seeds]
    return {k: (min(r[k] for r in runs), max(r[k] for r in runs))
            for k in BANDS.get(name, {})}


@pytest.mark.parametrize("name", NAMES)
def test_example_main_on_the_cpu(monkeypatch, name):
    sweeps = []
    if name == "06_sharded_streaming":
        auto = tpf.auto_num_steps

        def record(w, num_steps=10):
            sweeps.append(auto(w, num_steps))
            return sweeps[-1]
        monkeypatch.setattr(tpf, "auto_num_steps", record)
    out = _flat(example(name).main(device="cpu", **SIZES[name]))
    for key, (lo, hi) in BANDS.get(name, {}).items():
        assert lo < out[key] < hi, f"{name}: {key} = {out[key]}"
    for key in FINITE.get(name, ()):
        assert np.isfinite(out[key]), f"{name}: {key} = {out[key]}"
    if name == "01_particle_filter":
        assert out["posterior_x"] == (100, 512, 2)
    if name in ("04_sharded", "06_sharded_streaming"):
        assert out["ranks"] == 1
    if name == "06_sharded_streaming":
        assert out["history"] == (100, 512, 2)
        assert len(sweeps) == 99 and set(sweeps) <= AUTO_SWEEPS, sweeps
        assert len(set(sweeps)) > 1, sweeps
    if name == "07_advanced_mcmc":
        assert out["swap_rate"].shape == (7,)


def _mean_se(values):
    v = np.asarray(values, np.float64)
    return v.mean(), v.std(ddof=1) / np.sqrt(v.size)


@pytest.mark.parametrize("name", ["01_particle_filter", "08_nonlinear_ungm"])
def test_log_evidence_matches_the_jax_example(name):
    import jax.numpy as jnp

    sizes = SIZES[name]
    port = [example(name).main(device="cpu", seed=s, **sizes)
            ["log_evidence"] for s in LOGZ_SEEDS]
    if name == "01_particle_filter":
        import cusmc_tpu
        from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim

        p, ys = demo_model_params(), load_y_sim()[:sizes["T"]]
        ref = [float(cusmc_tpu.run(
            N=sizes["N"], d=2, timeSteps=sizes["T"], Y=ys, m0=p["m0"],
            C0=p["C0"], F=p["F"], G=p["G"], V=p["V"], W=p["W"], df=5.0,
            resampler="metropolis", distribution="mvt", key=s)
            ["log_evidence"]) for s in LOGZ_SEEDS]
    else:
        import jax

        from cusmc_tpu.models import UNGM as JUNGM
        from cusmc_tpu.smc.particle_filter import bootstrap_filter
        from cusmc_tpu_torch.models import UNGM

        gen = torch.Generator().manual_seed(7)
        _, ys = UNGM.create(q=10.0, r=1.0, device="cpu").simulate(
            gen, sizes["T"])
        jm = JUNGM.create(q=10.0, r=1.0)
        run = jax.jit(lambda k: bootstrap_filter(
            k, jm, jnp.asarray(ys.numpy()), sizes["N"],
            resampler="systematic", return_history=False).log_evidence)
        ref = [float(run(jax.random.key(s))) for s in LOGZ_SEEDS]
    (m_p, se_p), (m_j, se_j) = _mean_se(port), _mean_se(ref)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    assert abs(m_p - m_j) < LOGZ_SE * np.hypot(se_p, se_j), \
        (name, port, ref)


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", NAMES)
def test_examples_import_neither_jax_nor_the_jax_package(name):
    bad = [m for m in _imports(EXAMPLES / f"{name}.py")
           if m.split(".")[0] in ("jax", "jaxlib", "cusmc_tpu")]
    assert not bad, bad


def test_bundled_trace_is_the_jax_packages_byte_for_byte():
    from cusmc_tpu_torch.io import data

    ours = data.Y_SIM_PATH
    assert ours == ROOT / "cusmc_tpu_torch" / "io" / "_data" / "y_sim.csv"
    assert ours.read_bytes() == (ROOT / "cusmc_tpu" / "io" / "_data"
                                 / "y_sim.csv").read_bytes()


def _docstrings(tree):
    """The ids of the string constants that are docstrings."""
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                ids.add(id(first.value))
    return ids


def test_no_code_of_the_port_names_the_jax_package():
    # A path into cusmc_tpu/ is built from a "cusmc_tpu" string: none may
    # stand outside a docstring (citations of the reference stay there).
    found = []
    for path in sorted((ROOT / "cusmc_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and "cusmc_tpu" in node.value.replace("cusmc_tpu_torch",
                                                          "")):
                found.append(f"{path.relative_to(ROOT)}:{node.lineno}: "
                             f"{node.value!r}")
    assert not found, found


def test_load_y_sim_without_the_jax_package(tmp_path):
    shutil.copytree(ROOT / "cusmc_tpu_torch", tmp_path / "cusmc_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert not (tmp_path / "cusmc_tpu").exists()
    code = ("import sys; sys.path.insert(0, '.'); "
            "from cusmc_tpu_torch.io.data import load_y_sim, Y_SIM_PATH; "
            "ys = load_y_sim(); "
            "assert str(Y_SIM_PATH).startswith(sys.argv[1]), Y_SIM_PATH; "
            "assert 'cusmc_tpu' not in {m.split('.')[0] for m in "
            "sys.modules}; print(ys.shape, ys[1:].sum())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = np.genfromtxt(ROOT / "cusmc_tpu" / "io" / "_data" / "y_sim.csv",
                         delimiter=",", skip_header=1)
    assert proc.stdout.split(")")[0] == f"({want.shape[0]}, {want.shape[1]}"
