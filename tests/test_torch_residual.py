"""PyTorch port, residual resampling: the remainder positions, the classic
ancestors, the packed resample and one filter step against JAX on replayed
uniforms; the law of the offspring counts; the residual filter against the
Kalman oracle; and the top remainder draw of each port residual.

JAX and torch take the log and the cumsum of the remainder spacings in
other float32 orders, so the positions agree at rtol 1e-5. The ancestor
comparisons are exact: the JAX function is handed the port's positions
(the partial sums of the same uniforms) in place of its own draw, and the
weights are dyadic with a power-of-two total, so every cumsum, floor and
remainder is exact in both packages. Where they are not handed the same
positions they would differ only at cdf ties. States and log-likelihoods
at rtol 1e-5 (atol 1e-6); the filter's log-evidence within the JAX tests'
2% band.

The top remainder draw: each port residual computes its JAX counterpart's
law. The classic ``residual_ancestors`` does not clamp
(``resampling/classic.py:173``), the single-device packed residual caps the
unit positions at 1 - 1e-6 (``particle_filter.py:445-446``), and the
sharded residual caps the value one ulp below the remainder total
(``parallel/resampling.py:224-227``). They differ only for a top order
statistic above 1 - 1e-6, tested on its own for each of the three.
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import TINY, jax_model, packed_noise, port_model, \
    to_torch

import cusmc_tpu_torch
from cusmc_tpu.resampling import classic as jclassic
from cusmc_tpu.smc import particle_filter as jpf
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.parallel import resampling as port_res
from cusmc_tpu_torch.resampling import classic
from cusmc_tpu_torch.smc import particle_filter as tpf
from cusmc_tpu_torch.smc.kalman import kalman_filter

N = 4096
F32 = jnp.float32


def _uniforms(key, n=N):
    return np.array(jax.random.uniform(key, (n + 1,), F32, minval=TINY))


def _spacing_sums(u):
    return torch.cumsum(-torch.log(torch.from_numpy(u)), 0).numpy()


def _replay_positions(monkeypatch, u):
    """Make JAX's ``_residual_positions`` return the port's positions for
    the uniforms ``u`` (the same partial sums, the same division)."""
    s = jnp.asarray(_spacing_sums(u))

    def positions(key, n, n_det, dtype):
        return s[:n] / jnp.take(s, n - n_det)

    monkeypatch.setattr(jclassic, "_residual_positions", positions)


def _dyadic(rng, n=N):
    """Weights in {1, 1/2, 1/4, 1/8}, shuffled, summing to exactly n / 2:
    n8, n4, n2, n1 of each with 8 n8 + 4 n4 + 2 n2 + n1 = 4 n (in
    eighths) and n8 + n4 + n2 + n1 = n."""
    n8 = int(rng.integers(int(0.28 * n), n // 3))
    n4 = n // 5
    n2 = 3 * n - 7 * n8 - 3 * n4
    n1 = n - n8 - n4 - n2
    assert min(n2, n1) > 0
    w = np.repeat(np.float32([1.0, 0.5, 0.25, 0.125]), [n8, n4, n2, n1])
    return rng.permutation(w)


@pytest.mark.parametrize("n_det", [0, 1000, 4095])
def test_residual_positions_given_jax_uniforms(n_det):
    key = jax.random.key(3)
    ref = jclassic._residual_positions(key, N, jnp.int32(n_det), F32)
    ours = classic.residual_positions_from_uniforms(
        torch.from_numpy(_uniforms(key)), torch.tensor(n_det))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)
    r = N - n_det
    assert bool(torch.all(ours[1:r] >= ours[:r - 1]))
    assert r == 0 or float(ours[r - 1]) < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_residual_ancestors_match_jax(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    logw = np.log(_dyadic(rng)).astype(np.float32)
    key = jax.random.key(seed)
    u = _uniforms(key)
    _replay_positions(monkeypatch, u)
    ref = np.asarray(jclassic.residual_ancestors(key, jnp.asarray(logw)))
    ours = classic.residual_ancestors(None, torch.from_numpy(logw),
                                      torch.from_numpy(u))
    _, n_det, _ = jclassic._residual_parts(jnp.asarray(logw))
    assert 0 < int(n_det) < N
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_residual_resample_packed_matches_jax(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    nw = 2.0 * _dyadic(rng)  # n w / sum w, exact
    X = rng.standard_normal((3, N)).astype(np.float32)
    key = jax.random.key(10 + seed)
    u = _uniforms(key)
    _replay_positions(monkeypatch, u)
    x_ref, a_ref = jpf._residual_resample_packed(key, jnp.asarray(X),
                                                 jnp.asarray(nw))
    x, a = tpf._residual_resample_packed(torch.from_numpy(X),
                                         torch.from_numpy(nw),
                                         torch.from_numpy(u))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    np.testing.assert_array_equal(x.numpy(), X[:, a.numpy()])


def test_residual_step_matches_jax(monkeypatch):
    jm = jax_model("mvt", 5.0)
    tm = port_model(jm)
    rng = np.random.default_rng(7)
    x = (0.1 * rng.standard_normal((2, N))).astype(np.float32)
    w = _dyadic(rng)  # max 1, sum 2048: N / sum w is exact
    y = np.array([0.05, -0.02], np.float32)
    key, t = jax.random.key(42), 7
    k_res, k_prop = jax.random.split(jax.random.fold_in(key, t))
    u = _uniforms(k_res)
    _replay_positions(monkeypatch, u)
    jstep = jpf._fast_exp_step_factory(
        jm.propagate_packed, jm.observation_logpdf_packed, N,
        jpf.packed_exp_resample_op("residual", N), None, None, True)
    (x_ref, w_ref, _), ((_, ll_ref, a_ref), ess_ref, lz_ref) = jstep(
        (jnp.asarray(x), jnp.asarray(w), key), (t, jnp.asarray(y)))
    step = tpf._fast_exp_step_factory(
        tm, N, tpf.packed_exp_resample_op("residual", N), None)
    x_new, w_new, ess, lz, ll, a = step(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
        draws=(torch.from_numpy(u), packed_noise(k_prop, jm, N)))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    for ours, ref in ((x_new, x_ref), (ll, ll_ref), (w_new, w_ref),
                      (ess, ess_ref), (lz, lz_ref)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def _clamp_case():
    """Remainders of 1/2 on particles 0..1199, 1 - 2^-12 on 1200 and 2^-12
    on 3995, none after it (total 601; 1e-6 of it is wider than the last
    bin); and uniforms whose top order statistic rounds to 1."""
    nw = np.ones(N, np.float32)
    nw[:1200:2] = 1.5
    nw[1:1200:2] = 0.5
    nw[1200] = np.float32(1.0 - 2.0 ** -12)
    nw[3995] = np.float32(1.0 + 2.0 ** -12)
    assert nw.sum(dtype=np.float64) == N
    return nw, _top_uniforms(N - int(np.floor(nw).sum()))


def _top_uniforms(r):
    """Uniforms whose R-th spacing is ~6e-8, so the top of the R order
    statistics rounds to 1 in float32."""
    u = np.random.default_rng(0).uniform(0.05, 0.95, N + 1).astype(np.float32)
    u[r] = np.float32(1.0 - 2.0 ** -24)
    return u


def _classic_clamp_case():
    """Log-weights whose softmax is exact in both packages: w in {1, 1/2,
    1/4} summing to N / 2, so n w / sum w is 2w and only the 1200 quarter
    weights, all below index 3000, keep a remainder (1/2 each). The last
    bin with remainder mass lies far below N - 1."""
    rng = np.random.default_rng(4)
    head = rng.permutation(np.repeat(np.float32([1.0, 0.5, 0.25]),
                                     [600, 1200, 1200]))
    w = np.concatenate([head, np.full(N - 3000, 0.5, np.float32)])
    assert w.sum(dtype=np.float64) == N / 2
    assert int(np.nonzero(w == 0.25)[0].max()) < 3000
    return np.log(w).astype(np.float32), _top_uniforms(600)


def _jax_sharded_residual(monkeypatch, w, u):
    """The JAX sharded residual ancestors on a one-device mesh, on the
    remainder positions of ``u``."""
    from jax.sharding import PartitionSpec

    from cusmc_tpu.parallel import make_mesh
    from cusmc_tpu.parallel import resampling as jres

    try:
        shard_map = jax.shard_map
    except AttributeError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    _replay_positions(monkeypatch, u)
    fn = jres.make_sorted_sharded_ancestor_fn("residual", "particles", N, N,
                                              weights="exp")
    mesh = make_mesh({"particles": 1}, devices=jax.devices()[:1])
    spec = PartitionSpec("particles")
    run = shard_map(fn, mesh=mesh, in_specs=(PartitionSpec(), spec),
                    out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(run)(jax.random.key(0), jnp.asarray(w)))


@pytest.mark.parametrize("form", ["classic", "packed", "sharded"])
def test_residual_clamp_keeps_the_top_order_statistic(monkeypatch, form):
    # Each port residual equals its JAX counterpart on a top order
    # statistic above 1 - 1e-6, where the three laws part.
    if form == "classic":
        logw, u = _classic_clamp_case()
        _, n_det, resid = classic._residual_parts(torch.from_numpy(logw))
        r = N - int(n_det)
        assert r == 600
        last = int(torch.nonzero(resid).max())
    else:
        nw, u = _clamp_case()
        r = N - int(np.floor(nw).sum())
        resid = nw - np.floor(nw)
        last = int(np.nonzero(resid)[0].max())
        assert last == 3995 and resid[last] < 1e-6 * resid.sum()
    top = classic.residual_positions_from_uniforms(
        torch.from_numpy(u), torch.tensor(N - r))[r - 1]
    assert float(top) > 1.0 - 1e-6
    if form == "classic":
        # No clamp: the top draw ranks past the last bin and is clipped to
        # N - 1, a particle with no remainder mass.
        ours = classic.residual_ancestors(None, torch.from_numpy(logw),
                                          torch.from_numpy(u)).numpy()
        _replay_positions(monkeypatch, u)
        ref = np.asarray(jclassic.residual_ancestors(jax.random.key(0),
                                                     jnp.asarray(logw)))
        assert int(ours[-1]) == N - 1 and last < N - 1
    elif form == "packed":
        # The fixed 1 - 1e-6 quantile moves the top draw into the bin
        # before the last one with remainder mass.
        X = np.arange(N, dtype=np.float32)[None]
        x, a = tpf._residual_resample_packed(torch.from_numpy(X),
                                             torch.from_numpy(nw),
                                             torch.from_numpy(u))
        _replay_positions(monkeypatch, u)
        x_ref, a_ref = jpf._residual_resample_packed(
            jax.random.key(0), jnp.asarray(X), jnp.asarray(nw))
        np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
        ours, ref = a.numpy(), np.asarray(a_ref)
        assert int(ours[-1]) == 1200
    else:
        # One ulp below the total: the top draw stays in the last bin with
        # remainder mass.
        fn = port_res.make_sorted_sharded_ancestor_fn("residual", None, N, N,
                                                      weights="exp")
        ours = fn(torch.from_numpy(nw), torch.from_numpy(u)).numpy()
        ref = _jax_sharded_residual(monkeypatch, nw, u)
        assert int(ours[-1]) == last
    np.testing.assert_array_equal(ours, ref)


def test_residual_offspring_law():
    # Counts = floor(N w_i) + multinomial(R, remainders / R).
    rng = np.random.default_rng(5)
    n, reps = 512, 400
    w = np.exp(1.5 * rng.standard_normal(n)).astype(np.float32)
    nw = (w * (n / w.sum())).astype(np.float32)
    floor = np.floor(nw)
    resid = np.maximum(nw - floor, 0.0)
    r = n - int(floor.sum())
    gen = torch.Generator().manual_seed(0)
    X = torch.zeros((1, n))
    extra = np.zeros(n)
    for _ in range(reps):
        u = classic.residual_draws(gen, n)
        _, a = tpf._residual_resample_packed(X, torch.from_numpy(nw), u)
        counts = np.bincount(a.numpy(), minlength=n)
        assert (counts >= floor).all() and counts.sum() == n
        extra += counts - floor
    expect = reps * r * resid / resid.sum()
    order = np.argsort(resid)
    got = extra[order].reshape(16, -1).sum(1)
    want = expect[order].reshape(16, -1).sum(1)
    # 16 buckets of ~reps * R / 16 draws: 5 sigma of a binomial count.
    assert np.all(np.abs(got - want) <= 5 * np.sqrt(want) + 1), (got, want)


def _posterior_mean(particles, obs_loglik):
    ll = obs_loglik.double().numpy()
    w = np.exp(ll - ll.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return (w[:, :, None] * particles.double().numpy()).sum(axis=1)


@pytest.mark.parametrize("ess_threshold", [None, 0.5])
def test_residual_run_matches_kalman_oracle(ess_threshold):
    p = demo_model_params()
    ys = load_y_sim()[:100]
    km, kc, loglik = kalman_filter(
        ys, **{k: p[k] for k in ("F", "G", "V", "W", "m0", "C0")})
    out = cusmc_tpu_torch.run(
        N, 2, ys.shape[0], ys, p["m0"], p["C0"], p["F"], p["G"], p["V"],
        p["W"], resampler="residual", distribution="mvn", key=0,
        ess_threshold=ess_threshold, return_diagnostics=True, device="cpu")
    pm = _posterior_mean(out["posterior_x"], out["obs_loglik"])
    err = np.abs(pm[5:] - km[5:])
    scale = np.sqrt(kc[5:].diagonal(axis1=1, axis2=2))
    assert np.mean(err < 4.0 * scale) > 0.99
    assert np.median(err / scale) < 0.5
    assert abs(float(out["log_evidence"]) - loglik) < 0.02 * abs(loglik)
    assert out["ancestors"].dtype == torch.int32
