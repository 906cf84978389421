"""PyTorch port, the particle-sharded filter (parallel/filter.py) on 1, 2
and 4 gloo ranks, mirroring tests/test_parallel.py: the Kalman oracle,
global ancestors across shards, the ESS-adaptive skip branch, diagnostics
replicated on every rank, and the one-rank filter against the
single-device filter; the same for a ``CustomSSM`` (the batch layout and
the all-gather op, ``cusmc_tpu/parallel/filter.py:80-85``), whose one-rank
run equals the single-device batch run with the same op, bitwise.

Each group size starts its ranks once (tests/_torch_parallel_worker.py)
and runs every case; the tests read the outputs.

Tolerances: the JAX tests' bands (final weighted mean within 6 Kalman
standard deviations, log-evidence within 5% of the Kalman value); the
replicated diagnostics and the one-rank equality exactly.
"""

import _torch_threads  # noqa: F401
import functools
import types

import numpy as np
import pytest
import torch

from _torch_parallel_worker import finish_group, start_group

from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.parallel import initialize_distributed, process_info, \
    sharded_bootstrap_filter
from cusmc_tpu_torch.parallel.mesh import ParticleAxis, make_streams, \
    rank_seed
from cusmc_tpu_torch.smc.kalman import kalman_filter

N, T = 4096, 101
KALMAN = ("systematic", "metropolis", "residual")
RUNS = ("stratified", "multinomial", "metropolis-binary",
        "metropolis-windowed")
ADAPTIVE = ("systematic", "residual", "metropolis")
SIZES = (2, 4)


def _resampler(tag):
    name, _, exchange = tag.partition("-")
    return name, ({"exchange": exchange} if exchange else None)


def _filter(cid, tag, n=N, steps=T, **kw):
    name, kwargs = _resampler(tag)
    return dict(id=cid, kind="filter", resampler=name, kwargs=kwargs, N=n,
                T=steps, seed=7, **kw)


def _cases():
    cases = [_filter(f"kalman-{r}", r) for r in KALMAN]
    cases += [_filter(f"run-{r}", r, steps=31) for r in RUNS]
    cases += [_filter(f"adaptive-{r}", r, steps=51, ess_threshold=0.5)
              for r in ADAPTIVE]
    cases.append(_filter("history", "systematic", n=1024, steps=51,
                         history=True))
    cases.append(_filter("custom-kalman", "systematic", custom=True))
    # Flat likelihood: the ESS stays ~N, so resampling never fires.
    cases.append(_filter("skip", "systematic", n=1024, steps=21,
                         history=True, ess_threshold=0.5,
                         params={"V": 100.0 * np.eye(2)}))
    return cases


def _join(results, cid):
    """(log-evidence and ESS of every rank, the joined final particles
    [N, d], log weights [N] and ancestors [T, N])."""
    parts = [r[cid] for r in results]
    lz = [float(p[0]) for p in parts]
    ess = [p[1] for p in parts]
    xf = np.concatenate([p[2] for p in parts], 0)
    lwf = np.concatenate([p[3] for p in parts], 0)
    anc = None if parts[0][4] is None else np.concatenate(
        [p[4] for p in parts], 1)
    return lz, ess, xf, lwf, anc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("groups")
    one = dict(resampler="metropolis", N=2048, T=51, seed=3, history=True)
    # Stratified draws its offsets from the rank stream, so a one-shard
    # run draws what the single-device run seeded with that stream draws.
    custom = dict(resampler="stratified", N=2048, T=51, seed=3, history=True,
                  custom=True)
    groups = {P: start_group(P, _cases(), tmp) for P in SIZES}
    groups[1] = start_group(1, [
        dict(id="sharded", kind="filter", **one),
        dict(id="single", kind="single", **one),
        dict(id="custom-sharded", kind="filter", **custom),
        dict(id="custom-single", kind="single", **custom)], tmp)
    out = {P: functools.partial(_join, finish_group(groups[P]))
           for P in SIZES}
    out[1] = finish_group(groups[1])[0]
    return out


@pytest.fixture(scope="module")
def kalman():
    p = demo_model_params()
    ys = load_y_sim()[:T]
    return kalman_filter(ys, **{k: p[k] for k in
                                ("F", "G", "V", "W", "m0", "C0")})


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("resampler", KALMAN + ("custom",))
def test_sharded_filter_matches_kalman(runs, kalman, P, resampler):
    km, kc, kll = kalman
    lz, ess, xf, lwf, _ = runs[P](f"{resampler}-kalman" if resampler ==
                                  "custom" else f"kalman-{resampler}")
    w = np.exp(lwf.astype(np.float64))
    assert abs(w.sum() - 1.0) < 1e-4
    fmean = (w[:, None] * xf).sum(0) / w.sum()
    sd = np.sqrt(kc[-1].diagonal())
    assert np.all(np.abs(fmean - km[-1]) < 6.0 * sd)
    assert abs(lz[0] - kll) < 0.05 * abs(kll)
    assert xf.shape == (N, 2)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("case", [f"kalman-{r}" for r in KALMAN]
                         + [f"run-{r}" for r in RUNS]
                         + [f"adaptive-{r}" for r in ADAPTIVE])
def test_diagnostics_replicated_and_finite(runs, P, case):
    lz, ess, xf, lwf, _ = runs[P](case)
    assert len(set(lz)) == 1 and np.isfinite(lz[0])
    for e in ess[1:]:
        np.testing.assert_array_equal(e, ess[0])
    assert np.isfinite(ess[0]).all() and (ess[0] <= N * (1 + 1e-5)).all()
    assert np.isfinite(xf).all() and np.isfinite(lwf).all()


@pytest.mark.parametrize("P", SIZES)
def test_sharded_history_and_global_ancestors(runs, P):
    _, _, _, _, a = runs[P]("history")
    n = 1024
    assert a.shape == (51, n) and a.dtype == np.int32
    assert (a >= 0).all() and (a < n).all()
    np.testing.assert_array_equal(a[0], np.arange(n))
    block = n // P
    assert (a[1:] // block != np.arange(n)[None, :] // block).any()


@pytest.mark.parametrize("P", SIZES)
def test_sharded_skip_branch_global_ancestry(runs, P):
    _, ess, _, _, a = runs[P]("skip")
    n = 1024
    assert (ess[0] > 0.5 * n).all()
    np.testing.assert_array_equal(a, np.broadcast_to(np.arange(n), (21, n)))


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("resampler", ADAPTIVE)
def test_sharded_adaptive_resampling(runs, P, resampler):
    lz, ess, _, _, _ = runs[P](f"adaptive-{resampler}")
    # Some steps resample (ESS restored near N), some do not.
    assert np.isfinite(lz[0])
    assert (ess[0] < 0.5 * N).any() and (ess[0][1:] > 0.9 * N).any()


@pytest.mark.parametrize("case", ["", "custom-"])
def test_one_rank_equals_single_device(runs, case):
    # A one-rank group runs the sharded metropolis filter (a CustomSSM:
    # the batch layout and the all-gather op): its resample draws,
    # initial cloud and noise come from the rank stream, so it equals the
    # single-device filter seeded with that stream's seed, bitwise.
    for got, want in zip(runs[1][f"{case}sharded"], runs[1][f"{case}single"]):
        np.testing.assert_array_equal(got, want)


def test_indivisible_particles_raise():
    model = DLM.create(device="cpu", **demo_model_params())
    axis = types.SimpleNamespace(index=0, size=4)
    with pytest.raises(ValueError):
        sharded_bootstrap_filter(0, model, load_y_sim()[:5], 1001, axis)


def test_streams_and_one_shard_without_a_group():
    seeds = {rank_seed(5, r) for r in range(64)}
    assert len(seeds) == 64 and 5 not in seeds
    s = make_streams(5, None, "cpu")
    assert s.common.initial_seed() == 5
    assert s.rank.initial_seed() == rank_seed(5, 0)
    # axis=None: one shard, every reduction the identity.
    model = DLM.create(device="cpu", **demo_model_params())
    res = sharded_bootstrap_filter(0, model, load_y_sim()[:11], 512,
                                   resampler="residual", return_history=True)
    assert res.ancestors.shape == (11, 512)
    assert bool(torch.isfinite(res.log_evidence))


def test_multihost_single_process_noops():
    initialize_distributed()  # no init method, one process: nothing
    initialize_distributed(world_size=1)
    info = process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert info["backend"] is None
    with pytest.raises(RuntimeError):
        ParticleAxis()
