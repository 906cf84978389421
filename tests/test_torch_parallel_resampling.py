"""PyTorch port, the sharded resample ops (parallel/resampling.py) on 2 and
4 gloo ranks, mirroring tests/test_parallel_resampling.py.

Each group size starts its ranks once (tests/_torch_parallel_worker.py,
subprocesses that import torch and never jax) and runs every case; the
tests below read their outputs. The JAX references run here under
``shard_map`` on the conftest's CPU mesh cut to P devices, with the draws
replayed from their keys and handed to the ranks.

Tolerances: exact everywhere. Against JAX the weights are dyadic with a
power-of-two total (every cumsum exact in both packages), and JAX's sorted
and remainder positions are replaced by the port's (the same uniforms; the
two packages take their logs and cumsums in other float32 orders). The
exp-space and log-space Metropolis accept tests differ by rounding, so
they agree on > 99.9% of the ancestors, the JAX test's own bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P_

from _torch_parallel_worker import finish_group, start_group
from _torch_replay import TINY, roll_draws

from cusmc_tpu.parallel import make_mesh
from cusmc_tpu.parallel import resampling as jres
from cusmc_tpu.resampling import classic as jclassic
from cusmc_tpu_torch.parallel import resampling as port_res
from cusmc_tpu_torch.parallel.mesh import Streams
from cusmc_tpu_torch.resampling import classic

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

AXIS = "particles"
N, D, B = 4096, 2, 10
F32 = jnp.float32
NAMES = ("systematic", "stratified", "multinomial", "residual")
SIZES = (2, 4)


def _dyadic(rng):
    """Max-normalised weights in {1, 1/2, 1/4, 1/8} summing to N / 2."""
    n8, n4 = int(0.3 * N), N // 5
    n2 = 3 * N - 7 * n8 - 3 * n4
    w = np.repeat(np.float32([1.0, 0.5, 0.25, 0.125]),
                  [n8, n4, n2, N - n8 - n4 - n2])
    return rng.permutation(w)


RNG = np.random.default_rng(0)
X = RNG.standard_normal((D, N)).astype(np.float32)
W = _dyadic(RNG)
LOGW = RNG.standard_normal(N).astype(np.float32)
W_OF_LOGW = np.exp(LOGW - LOGW.max()).astype(np.float32)
HEAVY = 2 * (N // 4) + 7  # in block 2 of 4: beyond a K=1 window of block 0


def _far(n=N, heavy=HEAVY):
    w = np.full(n, np.float32(np.exp(-40.0)))
    w[heavy] = 1.0
    return w


KEY = jax.random.key(11)


def _jax_draws(name, P, key=KEY):
    """The JAX ops' draws for ``key``, one entry per rank, in the port's
    layout."""
    L = N // P
    if name == "systematic":
        return [np.array(jax.random.uniform(key, (), F32))] * P
    if name == "stratified":
        return [np.array(jax.random.uniform(jax.random.fold_in(key, p), (L,),
                                            F32)) for p in range(P)]
    if name == "multinomial":
        return [np.array(jax.random.uniform(jax.random.fold_in(key, p),
                                            (L + 1,), F32, minval=TINY))
                for p in range(P)]
    if name == "residual":
        return [np.array(jax.random.uniform(key, (N + 1,), F32,
                                            minval=TINY))] * P
    if name == "global":
        qs, ss, us = [], [], [[] for _ in range(P)]
        for b in range(B):
            kq, ks, ku = jax.random.split(jax.random.fold_in(key, b), 3)
            qs.append(int(jax.random.randint(kq, (), 0, P, jnp.int32)))
            ss.append(int(jax.random.randint(ks, (), 0, L, jnp.int32)))
            for p in range(P):
                us[p].append(np.array(jax.random.uniform(
                    jax.random.fold_in(ku, p), (L,), F32)))
        return [(np.int32(qs), np.int32(ss), np.stack(us[p]))
                for p in range(P)]
    kq, kr, km = jax.random.split(key, 3)
    q = np.int32(jax.random.randint(kq, (), 0, P, jnp.int32))
    r = np.int32(jax.random.randint(kr, (), 0, L, jnp.int32))
    out = []
    for p in range(P):
        shifts, u = roll_draws(jax.random.fold_in(km, p), L, B)
        out.append((q, r, (shifts.numpy(), u.numpy())))
    return out


def _op_case(cid, make, args=(), w=W, draws=None, seed=3, x=X, **kwargs):
    return dict(id=cid, kind="op", make=make, args=args, w=w, X=x,
                draws=draws, seed=seed, kwargs=kwargs)


def _cases(P):
    cases = []
    for name in NAMES:
        ring = functools.partial(_op_case, make="ring_cdf_resample_op",
                                 args=(name,))
        cases.append(ring(f"jax-{name}", draws=_jax_draws(name, P),
                          weights="exp"))
        cases.append(ring(f"ring-{name}", weights="exp"))
        cases.append(_op_case(f"ag-{name}", "allgather_resample_op",
                              (name,), x=X.T.copy(), weights="exp")
                     | {"batch": True})
        for K in (1, 3):
            for tag, w in (("healthy", W), ("far", _far())):
                cases.append(ring(f"ring-{name}-{K}-{tag}", w=w,
                                  weights="exp", ring_window=K,
                                  with_stats=True))
                cases.append(_op_case(
                    f"ag-{name}-{tag}", "allgather_resample_op", (name,),
                    w=w, x=X.T.copy(), weights="exp") | {"batch": True})
        cases.append(ring(f"exp-{name}", w=W_OF_LOGW, weights="exp"))
        cases.append(ring(f"log-{name}", w=LOGW, weights="log"))
    cases.append(_op_case("log-residual-prefix", "ring_cdf_resample_op",
                          ("residual",), w=2.5 * LOGW, weights="log"))
    gating = _op_case("gate-uniform", "ring_cdf_resample_op",
                      ("systematic",), w=np.ones(N, np.float32),
                      weights="exp", with_stats=True)
    conc = _far(heavy=0)
    cases += [gating, _op_case("gate-conc", "ring_cdf_resample_op",
                               ("systematic",), w=conc, weights="exp",
                               with_stats=True)]
    met = functools.partial(_op_case, make="roll_metropolis_sharded_op")
    cases.append(met("jax-global", draws=_jax_draws("global", P),
                     weights="exp"))
    cases.append(met("jax-windowed", draws=_jax_draws("windowed", P),
                     weights="exp", exchange="windowed"))
    for ex in ("global", "binary", "windowed"):
        cases.append(met(f"met-{ex}", weights="exp", exchange=ex))
        cases.append(met(f"met-{ex}-pred", weights="exp", exchange=ex)
                     | {"pred": True})
        cases.append(met(f"met-{ex}-skip", weights="exp", exchange=ex)
                     | {"pred": False})
    cases.append(_op_case("ag-metropolis", "allgather_resample_op",
                          ("metropolis",), x=X.T.copy(), weights="exp")
                 | {"batch": True})
    cases.append(met("met-exp", w=W_OF_LOGW, weights="exp", seed=9))
    cases.append(met("met-log", w=LOGW, weights="log", seed=9))
    for pred in (True, False):
        cases.append(_op_case(f"ring-pred-{pred}", "ring_cdf_resample_op",
                              ("systematic",), weights="exp")
                     | {"pred": pred})
    return cases


def _merge(results, cid):
    """The ranks' outputs of a case, joined along the particle axis."""
    parts = [r[cid] for r in results]
    out = [np.concatenate([p[i] for p in parts], axis=-1)
           for i in range(3)]
    if len(parts[0]) > 3:
        out.append([p[3] for p in parts])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("groups")
    groups = {P: start_group(P, _cases(P), tmp) for P in SIZES}
    return {P: functools.partial(_merge, finish_group(groups[P]))
            for P in SIZES}


def _jax_run(op, P, w, key=KEY, batch=False):
    mesh = make_mesh({AXIS: P}, devices=jax.devices()[:P])
    xspec = P_(AXIS, None) if batch else P_(None, AXIS)
    fn = shard_map(lambda k, x, lw: op(k, x, lw), mesh=mesh,
                   in_specs=(P_(), xspec, P_(AXIS)),
                   out_specs=(xspec, P_(AXIS), P_(AXIS)), check_vma=False)
    x = jnp.asarray(X.T) if batch else jnp.asarray(X)
    return [np.asarray(v) for v in jax.jit(fn)(key, x, jnp.asarray(w))]


def _replay_jax_positions(mp, name, P):
    """Hand JAX's sorted (multinomial) or remainder (residual) positions
    the port's values for the same uniforms."""
    draws = _jax_draws(name, P)
    if name == "multinomial":
        pos = jnp.asarray(np.stack([classic.sorted_from_uniforms(
            torch.from_numpy(d)).numpy() for d in draws]))
        mp.setattr(jclassic, "sorted_uniforms",
                   lambda key, n, dtype: pos[lax.axis_index(AXIS)])
    elif name == "residual":
        s = jnp.asarray(torch.cumsum(-torch.log(torch.from_numpy(draws[0])),
                                     0).numpy())
        mp.setattr(jclassic, "_residual_positions",
                   lambda key, n, n_det, dtype: s[:n] / jnp.take(
                       s, n - n_det))


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_ring_matches_jax(runs, P, name):
    with pytest.MonkeyPatch.context() as mp:
        _replay_jax_positions(mp, name, P)
        op = jres.ring_cdf_resample_op(name, AXIS, N, N // P, weights="exp")
        x_ref, w_ref, a_ref = _jax_run(op, P, W)
    x, w, a = runs[P](f"jax-{name}")
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(x, x_ref)
    np.testing.assert_array_equal(w, w_ref)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("exchange", ["global", "windowed"])
def test_metropolis_matches_jax(runs, P, exchange):
    op = jres.roll_metropolis_sharded_op(AXIS, N, N // P, num_steps=B,
                                         exchange=exchange, weights="exp")
    x_ref, w_ref, a_ref = _jax_run(op, P, W)
    x, w, a = runs[P](f"jax-{exchange}")
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(x, x_ref)
    np.testing.assert_array_equal(w, w_ref)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_ring_equals_allgather(runs, P, name):
    x, w, a = runs[P](f"ring-{name}")
    x_ag, w_ag, a_ag = runs[P](f"ag-{name}")
    np.testing.assert_array_equal(a, a_ag)
    np.testing.assert_array_equal(x, x_ag)
    np.testing.assert_array_equal(x, X[:, a])
    np.testing.assert_array_equal(w, np.ones(N, np.float32))


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_ring_windows_and_far_block_escape(runs, P, K, name):
    # K=1 at P=4 is span-bounded: the heavy particle of block 2 reaches
    # rank 0 only through the dynamic forward ring. K=3 is the full ring.
    for tag in ("healthy", "far"):
        x, _, a, mined = runs[P](f"ring-{name}-{K}-{tag}")
        x_ag, _, a_ag = runs[P](f"ag-{name}-{tag}")
        np.testing.assert_array_equal(a, a_ag)
        np.testing.assert_array_equal(x, x_ag)
        if tag == "far":
            assert (a == HEAVY).all()
            assert mined == [1] * P


@pytest.mark.parametrize("P", SIZES)
def test_ring_round_gating(runs, P):
    # Uniform weights: ancestors track the slots, spans ~ one block.
    x, _, a, mined = runs[P]("gate-uniform")
    assert max(mined) <= 2
    np.testing.assert_array_equal(x, X[:, a])
    # All mass on particle 0: exactly one mined round per rank.
    x, _, a, mined = runs[P]("gate-conc")
    assert mined == [1] * P and (a == 0).all()
    np.testing.assert_array_equal(x, X[:, a])


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("op", ["ring", "met-global", "met-binary",
                                "met-windowed"])
def test_pred_false_is_identity_and_true_unconditional(runs, P, op):
    if op == "ring":
        skip, keep, plain = "ring-pred-False", "ring-pred-True", \
            "ring-systematic"
    else:
        skip, keep, plain = f"{op}-skip", f"{op}-pred", op
    x, w, a = runs[P](skip)
    np.testing.assert_array_equal(x, X)
    np.testing.assert_array_equal(w, W)
    np.testing.assert_array_equal(a, np.arange(N))
    for g, u in zip(runs[P](keep), runs[P](plain)):
        np.testing.assert_array_equal(g, u)


@pytest.mark.parametrize("P", SIZES)
def test_binary_exchange_bitwise_equals_global(runs, P):
    for suffix in ("", "-pred"):
        for g, b in zip(runs[P](f"met-global{suffix}"),
                        runs[P](f"met-binary{suffix}")):
            np.testing.assert_array_equal(g, b)
    x, _, a = runs[P]("met-global")
    np.testing.assert_array_equal(x, X[:, a])
    assert (a != np.arange(N)).mean() > 0.5


@pytest.mark.parametrize("P", SIZES)
def test_sharded_residual_deterministic_prefix(runs, P):
    # The first n_det slots are the floor-count grid, key-independent:
    # equal to the single-device law; every count dominates its floor.
    x, _, a = runs[P]("log-residual-prefix")
    logw = torch.from_numpy(2.5 * LOGW)
    _, n_det, _ = classic._residual_parts(logw)
    n_det = int(n_det)
    assert 0 < n_det < N
    single = classic.residual_ancestors(torch.Generator().manual_seed(0),
                                        logw).numpy()
    np.testing.assert_array_equal(a[:n_det], single[:n_det])
    np.testing.assert_array_equal(x, X[:, a])
    floor = np.floor(N * torch.softmax(logw.double(), 0).numpy())
    assert (np.bincount(a, minlength=N) >= floor).all()


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_exp_ops_match_log_ops(runs, P, name):
    x_e, w_e, a_e = runs[P](f"exp-{name}")
    x_l, w_l, a_l = runs[P](f"log-{name}")
    np.testing.assert_array_equal(a_e, a_l)
    np.testing.assert_array_equal(x_e, x_l)
    np.testing.assert_array_equal(w_e, np.ones(N, np.float32))
    np.testing.assert_allclose(w_l, -np.log(N), rtol=1e-6)


@pytest.mark.parametrize("P", SIZES)
def test_exp_metropolis_matches_log(runs, P):
    _, _, a_e = runs[P]("met-exp")
    _, _, a_l = runs[P]("met-log")
    assert (a_e == a_l).mean() > 0.999


@pytest.mark.parametrize("P", SIZES)
def test_allgather_indexed_metropolis(runs, P):
    # Per-slot iid global proposals: states follow the ancestors, and the
    # offspring concentrate on the heavy weights.
    x, w, a = runs[P]("ag-metropolis")
    np.testing.assert_array_equal(x, X[:, a])
    np.testing.assert_array_equal(w, np.ones(N, np.float32))
    assert (a != np.arange(N)).mean() > 0.5
    assert W[a].mean() > W.mean()


def test_iid_multinomial_ancestors_one_shard():
    # make_sharded_ancestor_fn's multinomial draws iid (unsorted) uniforms:
    # the heavy particle's offspring count is Binomial(N, 0.9).
    w = np.full(N, np.float32(0.1 / (N - 1)))
    w[5] = 0.9
    fn = port_res.make_sharded_ancestor_fn("multinomial", None, N, N,
                                            weights="exp")
    gen = torch.Generator().manual_seed(0)
    streams = Streams(gen, gen)
    counts = []
    for _ in range(20):
        wt = torch.from_numpy(w)
        a = fn(wt, fn.draw(streams, wt)).numpy()
        counts.append(int((a == 5).sum()))
    assert not (np.diff(a.astype(np.int64)) >= 0).all()  # unsorted
    # Mean of 20 draws: sd sqrt(0.09 N / 20) ~ 4.3.
    assert abs(np.mean(counts) - 0.9 * N) < 20, counts
