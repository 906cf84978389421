"""Entry points: one filter step to compile and check, and a dry run of
every sharded program.

Counterpart of the JAX package's ``__graft_entry__.py``: ``entry``
(``:22-43``) and ``dryrun_multichip`` (``:46-148``). Ranks are processes
here, not devices: a JAX mesh of n devices in one process becomes a
process group of n ranks, one card a rank on the card (NCCL) or n
processes on the CPU (gloo). ``dryrun_multichip`` runs this rank's part
inside a group that is already initialised or that a launcher set up
(``torchrun --nproc-per-node n``); called alone, it starts its n ranks
itself, each a ``python`` process on a file store in a temporary
directory, and returns rank 0's results.

    python -m cusmc_tpu_torch.graft_entry [N] [--device cpu]

prints ``entry ok`` and ``dryrun_multichip ok``. N defaults to the
launcher's world size, else 1. On the card every rank needs a card of
its own: NCCL refuses two ranks on one card, and the dry run never falls
back to gloo there.
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cusmc_tpu_torch.device import resolve_device

ENTRY_PARTICLES = 4096
# Seconds each rank of a dry run that ``dryrun_multichip`` started may take.
RANK_TIMEOUT = 600


def _demo_model(dev: torch.device, d: int = 2, noise: str = "mvt"):
    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM

    return DLM.create(noise=noise, df=5.0 if noise == "mvt" else None,
                      dtype=torch.float32, device=dev,
                      **demo_model_params(d=d))


def entry(device=None) -> Tuple[Callable, tuple]:
    """(fn, example_args): one step of the bootstrap filter on the flagship
    MVT model (df = 5, d = 2, N = 4096) on ``device`` (None: the card):
    resample (metropolis, B = 10 roll sweeps) -> propagate -> reweight,
    the generic step of ``smc/particle_filter.py``.

    ``fn(x, logw, gen, t, y_t, draws=None) -> (x2, logw2, ess, lz)`` takes
    the packed state [d, N], log weights [N], the generator it draws
    from, the step and its observation [2]; ``draws`` (the roll walk's
    ``(shifts, u)`` and the propagation noise ``(z, chi-square draws)``)
    replaces the draws. On the card the step launches the roll walk's
    kernel once. ``example_args`` holds a standard normal state, zero log
    weights, a generator seeded 0, t = 1 and a zero observation; the
    generator advances with each call."""
    from cusmc_tpu_torch.parallel.mesh import Streams
    from cusmc_tpu_torch.smc.particle_filter import _step_factory, \
        packed_resample_op

    dev = resolve_device(device)
    model = _demo_model(dev)
    n = ENTRY_PARTICLES
    step = _step_factory(model.propagate_packed,
                         model.observation_logpdf_packed,
                         packed_resample_op("metropolis", n), None, n)

    def fn(x, logw, gen, t, y_t, draws=None):
        x2, logw2, ess, lz, _, _ = step(x, logw, y_t, Streams(gen, gen),
                                        draws, t)
        return x2, logw2, ess, lz

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((2, n), generator=gen, device=dev)  # packed [d, N]
    logw = torch.zeros((n,), device=dev)
    example_args = (x, logw, gen, 1, torch.zeros(2, device=dev))
    return fn, example_args


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _programs(n: int, dev: torch.device) -> dict:
    """This rank's part of every program, in ``__graft_entry__.py``'s
    order; the default group has ``n`` ranks."""
    from cusmc_tpu_torch.distributions import mvn_logpdf_cov
    from cusmc_tpu_torch.parallel import (
        Mesh,
        replicated_sharded_filters,
        sharded_bootstrap_filter,
        sharded_chees_sampler,
        sharded_ensemble_kalman_filter,
        sharded_mh_sampler,
        sharded_pt_sampler,
        sharded_stretch_sampler,
    )
    from cusmc_tpu_torch.smc.streaming import streaming_bootstrap_filter

    def seeded(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return gen

    out = {}
    model = _demo_model(dev)
    _, ys = model.simulate(seeded(0), 5)

    # 1. The particle-sharded filter, every sharded resampler family.
    axis = Mesh({"particles": n}).axes["particles"]
    for resampler in ("systematic", "metropolis", "residual"):
        res = sharded_bootstrap_filter(0, model, ys, 8 * n, axis,
                                       resampler=resampler)
        out[f"{resampler}/log_evidence"] = float(res.log_evidence)
        if resampler == "metropolis":
            out["metropolis/ess"] = _host(res.ess)
            out["metropolis/final_particles"] = _host(res.final_particles)
            out["metropolis/final_log_weights"] = _host(
                res.final_log_weights)

    # 1b. Sharded streaming: two chunks, the carry staying on the ranks.
    _, ys_s = model.simulate(seeded(5), 9)
    sres, _ = streaming_bootstrap_filter(
        0, model, ys_s, 8 * n, chunk_steps=4, resampler="systematic",
        axis=axis, store_particles=False)
    out["streaming/log_evidence"] = float(sres.log_evidence)

    # 2. The chain-sharded samplers, adaptation pooled over the ranks.
    chains = Mesh({"chains": n})
    d = 4
    zero, eye = torch.zeros(d, device=dev), torch.eye(d, device=dev)

    def log_prob(x):
        return mvn_logpdf_cov(x, zero, eye)

    init = torch.zeros((4 * n, d), device=dev)
    mh = sharded_mh_sampler(0, log_prob, init, 3, chains, adapt_rate=0.1)
    out["mh/accept_rate"] = float(mh.accept_rate)
    pt = sharded_pt_sampler(0, log_prob, init, 3, chains, num_rungs=3)
    out["pt/swap_rate"] = _host(pt.swap_rate)
    ch = sharded_chees_sampler(0, log_prob, init, 3, chains, max_leapfrog=8)
    out["chees/traj_length"] = float(ch.traj_length)
    # A nonzero ensemble: an all-zero one is a fixed point of the stretch
    # move. Each rank's W / P = 12 walkers meet the 2d + 2 floor.
    init_w = torch.randn((12 * n, d), generator=seeded(2), device=dev)
    st = sharded_stretch_sampler(0, log_prob, init_w, 3, chains)
    out["stretch/accept_rate"] = float(st.accept_rate)

    # 3. The ensemble-sharded EnKF.
    enkf = sharded_ensemble_kalman_filter(0, model, ys, 8 * n, axis)
    out["enkf/means"] = _host(enkf.means)

    # 4. A 2-D grid: replicates over "chains", particles over "particles".
    if n % 2 == 0 and n >= 4:
        grid = Mesh({"chains": 2, "particles": n // 2})
        rep = replicated_sharded_filters(0, model, ys, 8 * (n // 2), 4, grid)
        out["replicated/log_evidence"] = _host(rep.log_evidence)
    for name, value in out.items():  # each program's result, as JAX's asserts
        if not np.isfinite(np.asarray(value)).all():
            raise AssertionError(f"dryrun_multichip: {name} is not finite: "
                                 f"{value}")
    return out


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """Run every sharded program once at tiny shapes over ``n_ranks``
    ranks on ``device`` (None: the card): the particle-sharded filter
    (systematic, metropolis, residual; N = 8 a rank), sharded streaming
    (two chunks), the chain-sharded Metropolis, tempering, ChEES and
    stretch samplers, the sharded EnKF and, for an even ``n_ranks`` >= 4,
    replicated sharded filters on a 2 x n/2 grid. Each program's result is
    checked finite. Returns this rank's (rank 0's when this call started
    the ranks) dict of results: the log-evidences, the metropolis filter's
    ESS, final particles and log weights, the acceptance and swap rates,
    ChEES's trajectory length, the EnKF means and the replicates'
    log-evidences."""
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be positive, got {n_ranks}")
    dev = resolve_device(device)
    if dev.type == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(
            f"{n_ranks} ranks need {n_ranks} cards, and "
            f"{torch.cuda.device_count()} are visible: NCCL takes one card "
            "a rank")
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        from cusmc_tpu_torch.parallel import joined_group

        with joined_group(dev, n_ranks):
            return _programs(n_ranks, resolve_device(dev.type))
    return _start_ranks(n_ranks, dev.type)


def _start_ranks(n: int, device_type: str) -> dict:
    """Start ``n`` ranks of the dry run, each its own process, and return
    rank 0's results; every rank must exit 0 within RANK_TIMEOUT."""
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    if device_type == "cpu":  # one thread a rank: n ranks share the cores
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    code = "from cusmc_tpu_torch.graft_entry import _rank_main; _rank_main()"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(n),
             os.path.join(tmp, "store"), outs[r], device_type],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=root) for r in range(n)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=RANK_TIMEOUT)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for r, (proc, log) in enumerate(zip(procs, logs)):
            if proc.returncode != 0:
                raise RuntimeError(f"dry run rank {r} of {n} exited "
                                   f"{proc.returncode}:\n{log}")
        with open(outs[0], "rb") as f:
            return pickle.load(f)


def _rank_main() -> None:
    """One rank started by ``_start_ranks``: argv is RANK WORLD STORE OUT
    DEVICE_TYPE."""
    from cusmc_tpu_torch.parallel import initialize_distributed

    rank, world, store, out_path, device_type = sys.argv[1:6]
    if device_type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", int(world), int(rank),
                           backend="nccl" if device_type == "cuda"
                           else "gloo")
    try:
        out = _programs(int(world), resolve_device(device_type))
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cusmc_tpu_torch.graft_entry",
        description="One filter step, then the sharded programs' dry run.")
    parser.add_argument("n", nargs="?", type=int,
                        default=int(os.environ.get("WORLD_SIZE", 1)),
                        help="ranks of the dry run (default: the "
                             "launcher's world size, else 1)")
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    args = parser.parse_args(argv)
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise AssertionError("entry: the step is not finite")
    print("entry ok")
    dryrun_multichip(args.n, args.device)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
