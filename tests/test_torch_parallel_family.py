"""PyTorch port, the rest of the sharded family on 1, 2 and 4 gloo ranks:
the sharded filter and its ops on a bfloat16 state, the ensemble-sharded
EnKF, replicated sharded filters on a 2 x 2 grid of ranks, a disk spill
from a group of two, and the collectives of one ring exchange.

Each group size starts its ranks once (tests/_torch_parallel_worker.py)
and runs every case; the tests read the outputs. The JAX references run
under ``shard_map`` on the conftest's CPU devices, cut to P, with their
draws replayed from their keys and handed to the ranks.

Tolerances: the bfloat16 resample ops exactly against JAX's (data
movement and float32 comparisons on the same numbers; JAX promotes the
moved state to float32, whose values are the bfloat16 ones); the one-rank
bfloat16 filter bitwise against the run without collectives; the bfloat16
stream bitwise against the one-shot run; the spill byte for byte against
the history the same run gathers in memory; the EnKF against JAX at rtol
1e-5, atol 1e-5 (its [k, k] solve); the oracles at the JAX tests'
thresholds (tests/test_enkf.py, tests/test_replicated.py; the bfloat16
sharded filter on the MVN model within 5% of the Kalman log-evidence,
tests/test_parallel.py's band).
"""

import _torch_threads  # noqa: F401
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P_

from _torch_parallel_worker import finish_group, start_group
from _torch_replay import batch_noise, jax_model, roll_draws

from cusmc_tpu.parallel import make_mesh
from cusmc_tpu.parallel import resampling as jres
from cusmc_tpu.parallel.enkf import sharded_ensemble_kalman_filter as jsenkf
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.parallel.enkf import sharded_ensemble_kalman_filter
from cusmc_tpu_torch.parallel.replicated import replicated_sharded_filters
from cusmc_tpu_torch.smc.kalman import kalman_filter

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

AXIS = "particles"
F32 = jnp.float32
N, D, B = 4096, 2, 10
KEY = jax.random.key(21)
ORACLE_KEYS = ("F", "G", "V", "W", "m0", "C0")
RNG = np.random.default_rng(4)
# A bfloat16 state (values exact in bfloat16) and dyadic exp-space weights
# with a power-of-two total, so that every cumsum is exact in both
# packages.
XB = np.asarray(jnp.asarray(RNG.standard_normal((D, N)), jnp.bfloat16),
                np.float32)
WD = RNG.permutation(np.repeat(np.float32([1.0, 0.5, 0.25, 0.125]),
                               [N // 4, N // 4, N // 4, N // 4]))
ENKF_N, ENKF_T = 64, 8
HEAVY = 2 * (N // 4) + 7  # in block 2 of 4


def _jax_draws(name, P):
    """The JAX ops' draws for KEY, one entry per rank, in the port's
    layout (tests/test_torch_parallel_resampling.py's)."""
    L = N // P
    if name == "systematic":
        return [np.array(jax.random.uniform(KEY, (), F32))] * P
    if name == "global":
        qs, ss, us = [], [], [[] for _ in range(P)]
        for b in range(B):
            kq, ks, ku = jax.random.split(jax.random.fold_in(KEY, b), 3)
            qs.append(int(jax.random.randint(kq, (), 0, P, jnp.int32)))
            ss.append(int(jax.random.randint(ks, (), 0, L, jnp.int32)))
            for p in range(P):
                us[p].append(np.array(jax.random.uniform(
                    jax.random.fold_in(ku, p), (L,), F32)))
        return [(np.int32(qs), np.int32(ss), np.stack(us[p]))
                for p in range(P)]
    kq, kr, km = jax.random.split(KEY, 3)   # "windowed"
    q = np.int32(jax.random.randint(kq, (), 0, P, jnp.int32))
    r = np.int32(jax.random.randint(kr, (), 0, L, jnp.int32))
    out = []
    for p in range(P):
        shifts, u = roll_draws(jax.random.fold_in(km, p), L, B)
        out.append((q, r, (shifts.numpy(), u.numpy())))
    return out


def _enkf_draws(P):
    """Rank p's draws of JAX's sharded EnKF: the initial and each step's
    keys fold the shard index in (``cusmc_tpu/smc/enkf.py:82-95``)."""
    jm = jax_model("mvn")
    L = ENKF_N // P
    k_init, k_scan = jax.random.split(KEY)
    out = []
    for p in range(P):
        steps = []
        for t in range(1, ENKF_T):
            kt = jax.random.fold_in(jax.random.fold_in(k_scan, t), p)
            k_prop, k_obs = jax.random.split(kt)
            steps.append((batch_noise(k_prop, jm, (L, D)),
                          np.array(jax.random.normal(k_obs, (L, D), F32))))
        init = batch_noise(jax.random.fold_in(k_init, p), jm, (L, D))
        out.append({"init": tuple(v.numpy() for v in init),
                    "steps": [(tuple(v.numpy() for v in z), o)
                              for z, o in steps]})
    return out


def _op(cid, make, args=(), w=WD, **kwargs):
    return dict(id=cid, kind="op", make=make, args=args, w=w, X=XB,
                draws=kwargs.pop("draws", None), seed=3, kwargs=kwargs,
                bf16=kwargs.pop("bf16", True), count=kwargs.pop("count",
                                                                False))


def _filter(cid, resampler, **kw):
    return {**dict(id=cid, kind="filter", resampler=resampler, N=2048, T=51,
                   seed=5, noise="mvt", df=5.0, bf16=True), **kw}


def _stream(cid, **kw):
    return {**dict(id=cid, kind="stream", resampler="systematic", N=1024,
                   T=41, chunk=8, seed=2), **kw}


def _cases_one(tmp):
    cases = []
    for r in ("systematic", "residual", "metropolis"):
        cases.append(_filter(f"bf16-{r}", r, history=True))
        cases.append(_filter(f"bf16-{r}-none", r, history=True,
                             one_shard=True))
    cases.append(dict(_filter("bf16-single", "metropolis", history=True),
                      kind="single"))
    cases.append(_stream("spill", spill=str(tmp / "spill1.bin")))
    cases.append(_stream("memory", store=True))
    return cases


def _cases_two(tmp):
    P = 2
    cases = [
        _op("jax-systematic", "ring_cdf_resample_op", ("systematic",),
            draws=_jax_draws("systematic", P), weights="exp"),
        _op("jax-residual", "ring_cdf_resample_op", ("residual",),
            weights="exp"),
        _op("ag-residual", "allgather_resample_op", ("residual",),
            weights="exp", bf16=False) | {"X": XB.T.copy(), "batch": True},
        _op("jax-global", "roll_metropolis_sharded_op",
            draws=_jax_draws("global", P), weights="exp"),
        _op("jax-windowed", "roll_metropolis_sharded_op",
            draws=_jax_draws("windowed", P), weights="exp",
            exchange="windowed"),
        _op("binary", "roll_metropolis_sharded_op",
            draws=_jax_draws("global", P), weights="exp", exchange="binary"),
    ]
    T = 101
    for r in ("systematic", "residual", "metropolis"):
        cases.append(_filter(f"bf16-{r}", r, T=T, N=4096, noise="mvn",
                             df=None))
    cases.append(_stream("bf16-stream", bf16=True, store=True,
                         resampler="metropolis"))
    cases.append(dict(_filter("bf16-oneshot", "metropolis", T=41, N=1024,
                              history=True), seed=2, noise="mvn",
                      df=None))
    cases.append(dict(id="enkf-jax", kind="enkf", N=ENKF_N, T=ENKF_T,
                      seed=0, draws=_enkf_draws(P)))
    cases.append(dict(id="enkf-oracle", kind="enkf", N=4096, T=200,
                      seed=1))
    cases.append(_stream("spill", spill=str(tmp / "spill2.bin")))
    cases.append(_stream("memory", store=True))
    return cases


def _cases_four(tmp):
    cases = [dict(id="rep-metropolis", kind="replicated", N=2048, R=4,
                  T=101, seed=0, resampler="metropolis",
                  mesh={"chains": 2, "particles": 2}),
             dict(id="rep-systematic", kind="replicated", N=1024, R=2,
                  T=101, seed=0, resampler="systematic",
                  mesh={"chains": 2, "particles": 2})]
    far = np.full(N, np.float32(np.exp(-40.0)))
    far[HEAVY] = 1.0
    for K in (1, 2):
        for tag, w in (("healthy", WD), ("far", far)):
            cases.append(_op(f"count-{K}-{tag}", "ring_cdf_resample_op",
                             ("systematic",), w=w, weights="exp",
                             ring_window=K, with_stats=True, count=True,
                             bf16=False))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("family")
    groups = {1: start_group(1, _cases_one(tmp), tmp),
              2: start_group(2, _cases_two(tmp), tmp),
              4: start_group(4, _cases_four(tmp), tmp)}
    return {P: finish_group(g) for P, g in groups.items()}


def _merge_ops(results, cid):
    parts = [r[cid] for r in results]
    return [np.concatenate([p[i] for p in parts], axis=-1) for i in range(3)]


def _jax_run(op, P, w, batch=False):
    mesh = make_mesh({AXIS: P}, devices=jax.devices()[:P])
    xspec = P_(AXIS, None) if batch else P_(None, AXIS)
    fn = shard_map(lambda k, x, lw: op(k, x, lw), mesh=mesh,
                   in_specs=(P_(), xspec, P_(AXIS)),
                   out_specs=(xspec, P_(AXIS), P_(AXIS)), check_vma=False)
    x = jnp.asarray(XB, jnp.bfloat16)
    return [np.asarray(v, np.float32)
            for v in jax.jit(fn)(KEY, x.T if batch else x, jnp.asarray(w))]


# -- A1: the sharded filter on a bfloat16 state ----------------------------

@pytest.mark.parametrize("case", ["systematic", "global", "windowed"])
def test_bf16_ops_match_jax(runs, case):
    P = 2
    if case == "systematic":
        op = jres.ring_cdf_resample_op("systematic", AXIS, N, N // P,
                                       weights="exp")
    else:
        op = jres.roll_metropolis_sharded_op(AXIS, N, N // P, num_steps=B,
                                             exchange=case, weights="exp")
    x_ref, w_ref, a_ref = _jax_run(op, P, WD)
    x, w, a = _merge_ops(runs[P], f"jax-{case}")
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(x, x_ref)
    np.testing.assert_array_equal(w, w_ref)


def test_bf16_residual_and_binary_exchange(runs):
    # The residual ring equals the all-gather op on the same draws; the
    # binary exchange equals the global one bitwise, on a bfloat16 state.
    x, w, a = _merge_ops(runs[2], "jax-residual")
    x_ag, _, a_ag = _merge_ops(runs[2], "ag-residual")
    np.testing.assert_array_equal(a, a_ag)
    np.testing.assert_array_equal(x, XB[:, a])
    for g, b in zip(_merge_ops(runs[2], "jax-global"),
                    _merge_ops(runs[2], "binary")):
        np.testing.assert_array_equal(g, b)


@pytest.mark.parametrize("resampler", ["systematic", "residual",
                                       "metropolis"])
def test_bf16_one_rank_equals_the_run_without_collectives(runs, resampler):
    # The same ops and streams with no axis: the one-rank group's
    # collectives are the identity, bitwise, on a bfloat16 state too.
    got, want = (runs[1][0][f"bf16-{resampler}{s}"] for s in ("", "-none"))
    for g, u in zip(got, want):
        np.testing.assert_array_equal(g, u)
    if resampler == "metropolis":  # and the single-device filter
        for g, u in zip(got, runs[1][0]["bf16-single"]):
            np.testing.assert_array_equal(g, u)


@pytest.mark.parametrize("resampler", ["systematic", "residual",
                                       "metropolis"])
def test_bf16_sharded_filter_matches_kalman(runs, resampler):
    p = demo_model_params()
    ys = load_y_sim()[:101]
    _, _, kll = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})
    parts = [r[f"bf16-{resampler}"] for r in runs[2]]
    lz = [float(q[0]) for q in parts]
    assert lz[0] == lz[1] and np.isfinite(lz[0])
    np.testing.assert_array_equal(parts[0][1], parts[1][1])
    assert abs(lz[0] - kll) < 0.05 * abs(kll)
    assert all(np.isfinite(q[2]).all() for q in parts)


def test_bf16_sharded_stream_equals_one_shot(runs):
    for r in runs[2]:
        lz, ess, xf, lwf, (hist, start) = r["bf16-stream"]
        ref = r["bf16-oneshot"]
        np.testing.assert_array_equal(lz, ref[0])
        np.testing.assert_array_equal(ess, ref[1])
        np.testing.assert_array_equal(xf, ref[2])
        np.testing.assert_array_equal(lwf, ref[3])
        assert start == 0 and hist.shape == (41, 1024, 2)


# -- A2: the ensemble-sharded EnKF -----------------------------------------

def test_sharded_enkf_matches_jax(runs):
    jm = jax_model("mvn")
    mesh = make_mesh({AXIS: 2}, devices=jax.devices()[:2])
    ys = jnp.asarray(load_y_sim()[:ENKF_T], F32)
    ref = jsenkf(KEY, jm, ys, ENKF_N, mesh)
    parts = [r["enkf-jax"] for r in runs[2]]
    ens = np.concatenate([q[0] for q in parts], 0)
    np.testing.assert_allclose(ens, np.asarray(ref.final_ensemble),
                               rtol=1e-5, atol=1e-5)
    for q in parts:
        np.testing.assert_allclose(q[1], np.asarray(ref.means), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(q[2], np.asarray(ref.spread), rtol=1e-5,
                                   atol=1e-5)


def test_sharded_enkf_matches_kalman_oracle(runs):
    # tests/test_enkf.py::TestShardedEnKF at 2048 members a rank, on the
    # first 200 steps of the bundled trace.
    p = demo_model_params()
    km, _, _ = kalman_filter(load_y_sim()[:200],
                             **{k: p[k] for k in ORACLE_KEYS})
    parts = [r["enkf-oracle"] for r in runs[2]]
    means = parts[0][1]
    np.testing.assert_array_equal(means, parts[1][1])
    err = np.abs(means[5:] - km[5:]).mean()
    assert err / (np.abs(km[5:]).mean() + 1.0) < 0.05
    assert sum(q[0].shape[0] for q in parts) == 4096
    assert np.isfinite(parts[0][2][-1])


def test_sharded_enkf_divisibility_check():
    model = DLM.create(noise="mvn", device="cpu", **demo_model_params())
    axis = types.SimpleNamespace(index=0, size=2)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_ensemble_kalman_filter(0, model, load_y_sim()[:5], 1023,
                                       axis)


# -- A3: replicated sharded filters on a 2 x 2 grid ------------------------

def _replicates(results, cid):
    """log-evidence [R], ESS [R, T] and final particles [R, N, d] joined
    from the ranks' blocks by their (chain, particle) grid indices."""
    blocks = {(r[cid][4], r[cid][5]): r[cid] for r in results}
    chains = sorted({c for c, _ in blocks})
    lz = np.concatenate([blocks[c, 0][0] for c in chains])
    ess = np.concatenate([blocks[c, 0][1] for c in chains])
    xf = np.concatenate([np.concatenate([blocks[c, q][2] for q in (0, 1)],
                                        1) for c in chains])
    for (c, q), b in blocks.items():  # every particle rank agrees
        np.testing.assert_array_equal(b[0], blocks[c, 0][0])
    return lz, ess, xf


def test_replicates_agree_with_oracle(runs):
    p = demo_model_params()
    _, _, kll = kalman_filter(load_y_sim()[:101],
                              **{k: p[k] for k in ORACLE_KEYS})
    lz, ess, xf = _replicates(runs[4], "rep-metropolis")
    assert lz.shape == (4,)
    assert (np.abs(lz - kll) < 0.08 * abs(kll)).all()
    assert np.unique(lz).size == 4
    assert xf.shape == (4, 2048, 2)
    assert ess.shape == (4, 101)


def test_replicated_systematic_variant(runs):
    lz, _, xf = _replicates(runs[4], "rep-systematic")
    assert lz.shape == (2,) and np.isfinite(lz).all()
    assert xf.shape == (2, 1024, 2)


def test_replicated_divisibility_errors():
    model = DLM.create(noise="mvn", device="cpu", **demo_model_params())
    mesh = types.SimpleNamespace(shape={"chains": 2, "particles": 4})
    ys = load_y_sim()[:5]
    with pytest.raises(ValueError, match="replicates"):
        replicated_sharded_filters(0, model, ys, 1024, 3, mesh)
    with pytest.raises(ValueError, match="particles"):
        replicated_sharded_filters(0, model, ys, 1023, 2, mesh)


# -- A4: a disk spill from a group of two ----------------------------------

@pytest.mark.parametrize("P", [1, 2])
def test_spill_equals_the_gathered_history(runs, P):
    # Rank 0 writes the rows every rank gathers; the file holds, byte for
    # byte, the history the same run keeps in memory, as a one-rank group
    # spills it.
    ranks = runs[P]
    spilled = ranks[0]["spill"]
    hist, start = ranks[0]["memory"][4]
    assert start == 0
    assert spilled.tobytes() == np.ascontiguousarray(
        hist, np.float32).tobytes()
    assert all(r["spill"] is None for r in ranks[1:])


# -- A5: the collectives of one ring exchange ------------------------------

def _far_distance(a, P, K):
    """The dynamic forward ring's trip count F of the ring exchange, from
    the joined ancestors: the farthest forward distance in [K+1, P-K-1]
    that some rank's block range [a_min, a_max] covers, else K."""
    L = a.shape[0] // P
    rng = [(a[q * L:(q + 1) * L].min() // L, a[q * L:(q + 1) * L].max() // L)
           for q in range(P)]
    far = [t for t in range(K + 1, P - K)
           if any(lo <= (q + t) % P <= hi for q, (lo, hi) in enumerate(rng))]
    return max(far, default=K)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("tag", ["healthy", "far"])
def test_ring_ppermute_count_is_2k_plus_dynamic_rounds(runs, K, tag):
    # tests/test_parallel_resampling.py counts ppermute in the jaxpr (2K
    # static hops and the dynamic ring's body once). Here every call is
    # counted: 2K static hops and F - K dynamic ones when P > 2K + 1 (the
    # span-bounded exchange), else the full ring's P - 1; the same on
    # every rank.
    P = 4
    parts = [r[f"count-{K}-{tag}"] for r in runs[P]]
    a = np.concatenate([q[2] for q in parts])
    counts = {q[4] for q in parts}
    if P > 2 * K + 1:
        dynamic = _far_distance(a, P, K) - K
        assert counts == {2 * K + dynamic}
        assert dynamic == (1 if tag == "far" else 0)
        assert 2 * K + dynamic < P - 1 or tag == "far"
    else:
        assert counts == {P - 1}
    if tag == "far":
        assert (a == HEAVY).all()
