"""One rank of a gloo process group for the sharded-port tests.

    python tests/_torch_parallel_worker.py RANK WORLD STORE CASES OUT

Imports torch and the port, never jax or cusmc_tpu. ``CASES`` is a pickle
of a list of case dicts (numpy arrays and Python values only); the rank
runs them in order, every rank the same list, and pickles a dict
``{case id: outputs}`` of numpy arrays to ``OUT``. The parent side,
``start_group`` and ``finish_group``, starts the ranks in a fresh
directory and collects their outputs, each rank with its own
``communicate`` timeout.

Case kinds (all particle inputs are the global arrays; each rank takes its
block):

- ``"op"``: a resample op of ``parallel/resampling.py`` on ``X`` [d, N]
  (batch [N, d] for the all-gather op) and weights ``w`` [N], with
  ``draws`` (one entry per rank) or, when None, the op's own draws from
  the streams of ``seed``. Outputs ``(x, w_out, a[, mined])`` of the block,
  ``x`` as [d, L] in either layout.
- ``"filter"``: ``sharded_bootstrap_filter`` on the demo DLM and the first
  ``T`` rows of the bundled trace. Outputs log-evidence, ESS, the block's
  final particles and log weights, and its ancestors when kept.
- ``"single"``: the single-device filter of the same model seeded with
  the rank stream's seed, beside a ``"filter"`` case for the P = 1
  equality.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np


def _tensors(x):
    import torch

    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_tensors(v) for v in x)
    if isinstance(x, np.generic):
        return torch.tensor(x)
    return x


def _numpy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    return x


def _model(case):
    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
    from cusmc_tpu_torch.models.dlm import DLM

    params = demo_model_params()
    params.update(case.get("params", {}))
    noise = case.get("noise", "mvn")
    model = DLM.create(noise=noise, df=case.get("df"), device="cpu",
                       **params)
    return model, load_y_sim()[:case["T"]]


def run_case(case, axis):
    import torch

    from cusmc_tpu_torch.parallel import resampling
    from cusmc_tpu_torch.parallel.filter import sharded_bootstrap_filter
    from cusmc_tpu_torch.parallel.mesh import make_streams, rank_seed
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    p = axis.index
    if case["kind"] == "filter":
        model, ys = _model(case)
        res = sharded_bootstrap_filter(
            case["seed"], model, ys, case["N"], axis,
            resampler=case["resampler"],
            resampler_kwargs=case.get("kwargs"),
            ess_threshold=case.get("ess_threshold"),
            return_history=case.get("history", False))
        return _numpy((res.log_evidence, res.ess, res.final_particles,
                       res.final_log_weights, res.ancestors))
    if case["kind"] == "single":
        model, ys = _model(case)
        gen = torch.Generator().manual_seed(rank_seed(case["seed"], 0))
        res = bootstrap_filter(gen, model, ys, case["N"],
                               resampler=case["resampler"],
                               resampler_kwargs=case.get("kwargs"),
                               return_history=case.get("history", False))
        return _numpy((res.log_evidence, res.ess, res.final_particles,
                       res.final_log_weights, res.ancestors))

    n = case["w"].shape[0]
    L = n // axis.size
    make = getattr(resampling, case["make"])
    op = make(*case.get("args", ()), axis, n, L, **case.get("kwargs", {}))
    w = torch.from_numpy(case["w"][p * L:(p + 1) * L].copy())
    X = case["X"]
    X = X[p * L:(p + 1) * L] if case.get("batch") else X[:, p * L:(p + 1) * L]
    X = torch.from_numpy(np.ascontiguousarray(X))
    if case.get("draws") is not None:
        draws = _tensors(case["draws"][p])
    else:
        draws = op.draw(make_streams(case["seed"], axis, "cpu"), w)
    kw = {} if case.get("pred", "absent") == "absent" else \
        {"pred": case["pred"]}
    out = op(X, w, draws, **kw)
    if case.get("batch"):  # [L, d] -> [d, L], as the packed ops return
        out = (out[0].T,) + tuple(out[1:])
    return _numpy(out)


def main():
    rank, world, store, cases_path, out_path = sys.argv[1:6]
    import torch

    torch.set_num_threads(1)
    from cusmc_tpu_torch.parallel.mesh import ParticleAxis
    from cusmc_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed(f"file://{store}", int(world), int(rank),
                           backend="gloo")
    axis = ParticleAxis()
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {case["id"]: run_case(case, axis) for case in cases}
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                          "cusmc_tpu")]
    assert not bad, bad
    import torch.distributed as dist

    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def start_group(world, cases, tmp_path):
    """Start ``world`` ranks on ``cases``; ``finish_group`` collects them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tempfile.mkdtemp(dir=str(tmp_path))
    cases_path = os.path.join(tmp, "cases.pkl")
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    store = os.path.join(tmp, "store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=root, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    outs = [os.path.join(tmp, f"out{r}.pkl") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         store, cases_path, outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
        for r in range(world)]
    return procs, outs


def finish_group(group, timeout=240):
    """One output dict per rank. Each rank gets its own
    ``communicate(timeout=...)``; on expiry every rank is killed and the
    call raises."""
    procs, outs = group
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.communicate()
        raise
    for r, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, \
            f"rank {r} of {len(procs)} failed:\n{log}"
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    main()
