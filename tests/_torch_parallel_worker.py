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
  final particles and log weights, and its ancestors and particle history
  when kept.
- ``"single"``: the single-device filter of the same model seeded with
  the rank stream's seed, beside a ``"filter"`` case for the P = 1
  equality.
- ``"enkf"``: ``parallel.enkf.sharded_ensemble_kalman_filter`` on the
  demo DLM (``draws``: one entry per rank, or None). Outputs the block's
  final ensemble, the means and the spread.
- ``"replicated"``: ``parallel.replicated.replicated_sharded_filters`` on
  a ``parallel.mesh.Mesh`` of ``mesh`` (axis sizes). Outputs this rank's
  block (log-evidence, ESS, final particles and log weights) and its
  (chain, particle) indices on the grid.

``bf16=True`` gives the model (``"filter"``, ``"single"``, ``"stream"``)
or the op's ``X`` (``"op"``) a bfloat16 state; the rank asserts that the
state stays bfloat16 and outputs it as float32. ``one_shard=True`` runs a
``"filter"`` case with no axis (the same streams and ops, no
collectives). An ``"op"`` case with ``count=True`` also outputs the
number of ``ParticleAxis.ppermute`` calls the op made. A ``"stream"``
case with ``spill`` (a path) spills the history there from rank 0 and
outputs the file's bytes on rank 0 (None elsewhere, where no store may
be returned).
- ``"stream"``: ``smc/streaming.streaming_bootstrap_filter`` over the
  group (``sharded=False``: on one device, every rank alike), with
  ``chunk`` steps a chunk and an optional snapshot directory
  ``checkpoint`` (saved every ``every`` steps, default every chunk).
  ``mode`` "run" outputs log-evidence, ESS, the block's final particles
  and log weights, the store's history and start step; "halt" puts a NaN
  in row ``nan_at`` and outputs the raised error's last good step and
  snapshot file name; "spy" runs without store and checkpoint and outputs
  the halt guard's host reads and the shapes that crossed to the host.

A case with ``custom=True`` wraps the demo DLM in a ``CustomSSM`` (batch
methods only): the sharded filter then runs the batch layout with the
all-gather op, and a ``"single"`` case injects that op for one shard.
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
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return torch.tensor(x)
    return x


def _numpy(x):
    import torch

    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
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
    import torch

    model = DLM.create(noise=noise, df=case.get("df"), device="cpu",
                       state_dtype=torch.bfloat16 if case.get("bf16")
                       else None, **params)
    if case.get("custom"):
        from cusmc_tpu_torch.models.base import CustomSSM

        model = CustomSSM.create(
            model.state_dim,
            lambda m, gen, shape: m["dlm"].sample_initial(gen, shape),
            lambda m, gen, x: m["dlm"].propagate(gen, x),
            lambda m, y, x: m["dlm"].observation_logpdf(y, x),
            params={"dlm": model})
    return model, load_y_sim()[:case["T"]]


def stream_case(case, axis):
    from cusmc_tpu_torch.checkpoint import FilterCheckpoint
    from cusmc_tpu_torch.smc import streaming
    from cusmc_tpu_torch.utils.debug import FilterDivergedError

    model, ys = _model(case)
    ckpt = (FilterCheckpoint(case["checkpoint"]) if case.get("checkpoint")
            else None)
    kw = dict(chunk_steps=case["chunk"], resampler=case["resampler"],
              resampler_kwargs=case.get("kwargs"), checkpoint=ckpt,
              checkpoint_every=case.get("every"),
              axis=axis if case.get("sharded", True) else None)
    mode = case.get("mode", "run")
    if mode == "halt":
        bad = np.array(ys, np.float32)
        bad[case["nan_at"], 0] = np.nan
        try:
            streaming.streaming_bootstrap_filter(
                case["seed"], model, bad, case["N"], store_particles=False,
                **kw)
        except FilterDivergedError as e:
            return e.last_good_step, os.path.basename(e.snapshot)
        raise AssertionError("the filter did not halt")
    if mode == "spy":
        reads, shapes = [], []
        fetch, flag = streaming._host_fetch, streaming._host_flag
        streaming._host_fetch = lambda x: shapes.append(
            tuple(x.shape)) or fetch(x)
        streaming._host_flag = lambda x: reads.append(
            tuple(x.shape)) or flag(x)
        try:
            res, _ = streaming.streaming_bootstrap_filter(
                case["seed"], model, ys, case["N"], store_particles=False,
                **kw)
        finally:
            streaming._host_fetch, streaming._host_flag = fetch, flag
        return reads, shapes, _numpy(res.log_evidence)
    if case.get("spill"):
        res, store = streaming.streaming_bootstrap_filter(
            case["seed"], model, ys, case["N"], spill_path=case["spill"],
            **kw)
        if axis.index != 0:
            assert store is None
            return None
        store.finish()
        return np.fromfile(case["spill"], np.uint8)
    res, store = streaming.streaming_bootstrap_filter(
        case["seed"], model, ys, case["N"], resume=case.get("resume", False),
        store_particles=case.get("store", False), **kw)
    assert res.final_particles.dtype == model.state_dtype
    hist = None if store is None else (np.array(store.view()),
                                       store.start_step)
    return _numpy((res.log_evidence, res.ess, res.final_particles,
                   res.final_log_weights)) + (hist,)


def run_case(case, axis):
    import torch

    from cusmc_tpu_torch.parallel import resampling
    from cusmc_tpu_torch.parallel.filter import sharded_bootstrap_filter
    from cusmc_tpu_torch.parallel.mesh import make_streams, rank_seed
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    p = axis.index
    if case["kind"] == "stream":
        return stream_case(case, axis)
    if case["kind"] == "enkf":
        from cusmc_tpu_torch.parallel.enkf import \
            sharded_ensemble_kalman_filter

        model, ys = _model(case)
        draws = case.get("draws")
        res = sharded_ensemble_kalman_filter(
            case["seed"], model, ys, case["N"], axis, device="cpu",
            draws=None if draws is None else _tensors(draws[p]))
        return _numpy((res.final_ensemble, res.means, res.spread))
    if case["kind"] == "replicated":
        from cusmc_tpu_torch.parallel.mesh import Mesh
        from cusmc_tpu_torch.parallel.replicated import \
            replicated_sharded_filters

        model, ys = _model(case)
        mesh = Mesh(case["mesh"])
        res = replicated_sharded_filters(
            case["seed"], model, ys, case["N"], case["R"], mesh,
            resampler=case["resampler"], device="cpu")
        return _numpy((res.log_evidence, res.ess, res.final_particles,
                       res.final_log_weights)) + (
            mesh.axes["chains"].index, mesh.axes["particles"].index)
    if case["kind"] == "filter":
        model, ys = _model(case)
        res = sharded_bootstrap_filter(
            case["seed"], model, ys, case["N"],
            None if case.get("one_shard") else axis,
            resampler=case["resampler"],
            resampler_kwargs=case.get("kwargs"),
            ess_threshold=case.get("ess_threshold"),
            return_history=case.get("history", False), device="cpu")
        assert res.final_particles.dtype == getattr(model, "state_dtype",
                                                    torch.float32)
        return _numpy((res.log_evidence, res.ess, res.final_particles,
                       res.final_log_weights, res.ancestors, res.particles))
    if case["kind"] == "single":
        model, ys = _model(case)
        gen = torch.Generator().manual_seed(rank_seed(case["seed"], 0))
        op = (resampling.allgather_resample_op(
            case["resampler"], None, case["N"], case["N"])
            if case.get("custom") else None)
        res = bootstrap_filter(gen, model, ys, case["N"],
                               resampler=case["resampler"],
                               resampler_kwargs=case.get("kwargs"),
                               return_history=case.get("history", False),
                               resample_op=op, device="cpu")
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
    if case.get("bf16"):
        X = X.to(torch.bfloat16)
    if case.get("draws") is not None:
        draws = _tensors(case["draws"][p])
    else:
        draws = op.draw(make_streams(case["seed"], axis, "cpu"), w)
    kw = {} if case.get("pred", "absent") == "absent" else \
        {"pred": case["pred"]}
    calls = []
    ppermute = type(axis).ppermute
    if case.get("count"):
        def spy(self, x, perm):
            calls.append(len(perm))
            return ppermute(self, x, perm)
        type(axis).ppermute = spy
    try:
        out = op(X, w, draws, **kw)
    finally:
        type(axis).ppermute = ppermute
    assert out[0].dtype == X.dtype
    if case.get("batch"):  # [L, d] -> [d, L], as the packed ops return
        out = (out[0].T,) + tuple(out[1:])
    return _numpy(out) + ((len(calls),) if case.get("count") else ())


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
