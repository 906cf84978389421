"""PyTorch port, the smoothers and the forecast: ``rts_smoother``, FFBS and
its transition densities, genealogy smoothing and ``forecast``, against
``cusmc_tpu``'s.

Exact parity: ``rts_smoother`` at rtol 1e-10 in float64; the transition
densities (DLM MVN, MVT df=5, stochastic volatility) at rtol 1e-5; ``ffbs``
and ``forecast`` with JAX's Gumbel noise and normals replayed (T <= 5, N <=
128), the drawn indices exactly and the paths at rtol 1e-5; the genealogy
functions on one filter history handed to both packages, exactly.

Oracles, the JAX tests' thresholds (tests/test_ffbs.py,
tests/test_forecast.py, tests/test_models_smoothing_pmmh.py) at N <= 4096:
FFBS against the RTS smoother, the forecast against the Kalman
predictive, the traced smoothed means against the truth. Refusals: FFBS
without history, the per-dimension-chi MVT.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import F32, batch_noise, gumbel_draws, jax_model, \
    model_noise, normal_noise, port_model, to_torch

from cusmc_tpu.models.stochvol import StochasticVolatility as JSV
from cusmc_tpu.smc import kalman as jkalman
from cusmc_tpu.smc import smoothing as jsmoothing
from cusmc_tpu.smc.ffbs import ffbs as jffbs
from cusmc_tpu.smc.ffbs import transition_logpdf as jtransition
from cusmc_tpu.smc.forecast import forecast as jforecast
from cusmc_tpu.smc.particle_filter import FilterResult as JFilterResult
from cusmc_tpu_torch.io.data import demo_model_params
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.models.stochvol import StochasticVolatility
from cusmc_tpu_torch.ops.random import categorical
from cusmc_tpu_torch.smc import smoothing
from cusmc_tpu_torch.smc.ffbs import ffbs, transition_logpdf
from cusmc_tpu_torch.smc.forecast import forecast
from cusmc_tpu_torch.smc.kalman import kalman_filter, rts_smoother
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

N, T = 128, 5
ORACLE_KEYS = ("F", "G", "V", "W", "m0", "C0")


def _close(ours, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _jax_result(res):
    """The port's FilterResult as the JAX package's."""
    return JFilterResult(*(None if v is None else jnp.asarray(v.numpy())
                           for v in (res.final_particles,
                                     res.final_log_weights, res.ess,
                                     res.log_evidence, res.particles,
                                     res.obs_loglik, res.ancestors)))


@pytest.fixture(scope="module")
def short_run():
    model = DLM.create(noise="mvn", device="cpu", **demo_model_params())
    _, ys = model.simulate(torch.Generator().manual_seed(3), T)
    return model, bootstrap_filter(1, model, ys, N, resampler="systematic")


def test_rts_smoother_matches_jax():
    p = demo_model_params()
    model = DLM.create(noise="mvn", device="cpu", **p)
    _, ys = model.simulate(torch.Generator().manual_seed(0), 40)
    ys = ys.double().numpy()
    sm, sc = rts_smoother(ys, **{k: p[k] for k in ORACLE_KEYS})
    rsm, rsc = jkalman.rts_smoother(ys, **{k: p[k] for k in ORACLE_KEYS})
    np.testing.assert_allclose(sm, np.asarray(rsm), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(sc, np.asarray(rsc), rtol=1e-10, atol=1e-12)
    km, kc, _ = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})
    np.testing.assert_array_equal(sm[-1], km[-1])


@pytest.mark.parametrize("model", ["mvn", "mvt", "sv"])
def test_transition_logpdf_matches_jax(model):
    jm = JSV.create() if model == "sv" else jax_model(
        model, 5.0 if model == "mvt" else None)
    tm = port_model(jm)
    d = 1 if model == "sv" else 2
    rng = np.random.default_rng(0)
    x_next = rng.standard_normal((6, d)).astype(np.float32)
    x_prev = rng.standard_normal((9, d)).astype(np.float32)
    ref = jtransition(jm, jnp.asarray(x_next), jnp.asarray(x_prev))
    ours = transition_logpdf(tm, torch.from_numpy(x_next),
                             torch.from_numpy(x_prev))
    assert ours.shape == (6, 9)
    _close(ours.numpy(), ref, atol=1e-4)


def test_mvt_transition_matches_scipy():
    from scipy.stats import multivariate_t

    p = demo_model_params()
    model = DLM.create(noise="mvt", df=5.0, device="cpu", **p)
    rng = np.random.default_rng(0)
    x_next = rng.standard_normal((3, 2)).astype(np.float32)
    x_prev = rng.standard_normal((5, 2)).astype(np.float32)
    got = transition_logpdf(model, torch.from_numpy(x_next),
                            torch.from_numpy(x_prev)).numpy()
    for i in range(3):
        for j in range(5):
            want = multivariate_t(loc=p["G"] @ x_prev[j], shape=p["W"],
                                  df=5.0).logpdf(x_next[i])
            np.testing.assert_allclose(got[i, j], want, rtol=2e-4,
                                       atol=2e-4)


def test_categorical_draws_jax_indices():
    key = jax.random.key(4)
    logits = jax.random.normal(jax.random.key(5), (3, 50), F32)
    ref = jax.random.categorical(key, logits, axis=-1)
    ours = categorical(None, to_torch(logits), noise=gumbel_draws(key,
                                                                  (3, 50)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ref = jax.random.categorical(key, logits[0], shape=(7,))
    ours = categorical(None, to_torch(logits[0]), 7,
                       noise=gumbel_draws(key, (7, 50)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # Drawn in blocks, the law stays: one block a row here.
    import cusmc_tpu_torch.ops.random as trandom
    old, trandom.CATEGORICAL_BLOCK = trandom.CATEGORICAL_BLOCK, 50
    try:
        idx = categorical(torch.Generator().manual_seed(0),
                          torch.log(torch.tensor([0.7, 0.2, 0.1])), 4000)
    finally:
        trandom.CATEGORICAL_BLOCK = old
    freq = np.bincount(idx.numpy(), minlength=3) / 4000
    np.testing.assert_allclose(freq, [0.7, 0.2, 0.1], atol=0.03)


@pytest.mark.parametrize("model", ["mvn", "mvt"])
def test_ffbs_matches_jax(model):
    jm = jax_model(model, 5.0 if model == "mvt" else None)
    tm = port_model(jm)
    _, ys = tm.simulate(torch.Generator().manual_seed(1), T)
    res = bootstrap_filter(2, tm, ys, N, resampler="systematic")
    key = jax.random.key(31)
    ref = jffbs(key, jm, _jax_result(res), num_paths=16)
    k_last, k_scan = jax.random.split(key)
    draws = {"last": gumbel_draws(k_last, (16, N)),
             "steps": {t: gumbel_draws(jax.random.fold_in(k_scan, t),
                                       (16, N)) for t in range(T - 1)}}
    out = ffbs(0, tm, res, num_paths=16, draws=draws)
    assert out.shape == (T, 16, 2)
    _close(out.numpy(), ref)


def test_genealogy_matches_jax(short_run):
    _, res = short_run
    jres = _jax_result(res)
    np.testing.assert_array_equal(smoothing.ancestral_paths(res).numpy(),
                                  np.asarray(jsmoothing.ancestral_paths(jres)))
    np.testing.assert_array_equal(
        smoothing.unique_path_counts(res).numpy(),
        np.asarray(jsmoothing.unique_path_counts(jres)))
    _close(smoothing.smoothed_means(res).numpy(),
           jsmoothing.smoothed_means(jres))


@pytest.mark.parametrize("weights", ["given", "uniform", "subsample"])
def test_forecast_matches_jax(short_run, weights):
    model, res = short_run
    jm = jax_model("mvn")
    tm = port_model(jm)
    m = 32 if weights == "subsample" else None
    lw = None if weights != "given" else res.final_log_weights
    key = jax.random.key(32)
    ref = jforecast(key, jm, jnp.asarray(res.final_particles.numpy()),
                    None if lw is None else jnp.asarray(lw.numpy()), 3, m)
    k_anc, k_scan = jax.random.split(key)
    size = N if m is None else m
    anc = None
    if weights == "given":
        anc = gumbel_draws(k_anc, (size, N))
    elif weights == "subsample":
        anc = to_torch(jax.random.randint(k_anc, (m,), 0, N))
    steps = []
    for k in jax.random.split(k_scan, 3):
        kp, ko = jax.random.split(k)
        steps.append((batch_noise(kp, jm, (size, 2)),
                      batch_noise(ko, jm, (size, 2))))
    xs, ys = forecast(0, tm, res.final_particles, lw, 3, m,
                      draws={"anc": anc, "steps": steps})
    assert xs.shape == (3, size, 2) and ys.shape == (3, size, 2)
    _close(xs.numpy(), ref[0])
    _close(ys.numpy(), ref[1])


def test_forecast_sv_matches_jax():
    jm = JSV.create(mu=-1.0, phi=0.95, sigma=0.3)
    tm = port_model(jm)
    key = jax.random.key(2)
    x = jm.sample_initial(key, (64,))
    ref = jforecast(key, jm, x, None, horizon=5)
    k_anc, k_scan = jax.random.split(key)
    steps = []
    for k in jax.random.split(k_scan, 5):
        kp, ko = jax.random.split(k)
        steps.append((model_noise(kp, jm, (64, 1)),
                      normal_noise(ko, (64,))))
    xs, ys = forecast(0, tm, to_torch(x), None, 5,
                      draws={"anc": None, "steps": steps})
    assert xs.shape == (5, 64, 1) and np.isfinite(ys.numpy()).all()
    _close(xs.numpy(), ref[0])
    _close(ys.numpy(), ref[1])


# -- oracles ------------------------------------------------------------------

@pytest.fixture(scope="module")
def dlm_run():
    p = demo_model_params()
    model = DLM.create(noise="mvn", device="cpu", **p)
    xs, ys = model.simulate(torch.Generator().manual_seed(5), 121)
    res = bootstrap_filter(1, model, ys, 2048, resampler="systematic")
    return p, model, xs.numpy(), ys, res


def test_ffbs_matches_rts_smoother(dlm_run):
    # tests/test_ffbs.py:53-64.
    p, model, _, ys, res = dlm_run
    paths = ffbs(0, model, res, num_paths=256).numpy()
    sm, sc = rts_smoother(ys, **{k: p[k] for k in ORACLE_KEYS})
    sd = np.sqrt(sc.diagonal(axis1=1, axis2=2))
    err = np.abs(paths.mean(axis=1)[5:] - sm[5:])
    assert (err < 5.0 * sd[5:]).mean() > 0.99
    assert np.median(err / sd[5:]) < 0.6
    # tests/test_ffbs.py:67-79: FFBS keeps path diversity at t = 0.
    uniq_ffbs = len(np.unique(paths[0][:, 0].round(6)))
    uniq_gene = int(smoothing.unique_path_counts(res)[0])
    assert uniq_ffbs > 10 and uniq_ffbs >= min(uniq_gene, 50)


def test_genealogy_smoothing_tracks_truth(dlm_run):
    # tests/test_models_smoothing_pmmh.py:86-122.
    _, _, xs, _, res = dlm_run
    paths = smoothing.ancestral_paths(res).numpy()
    np.testing.assert_array_equal(paths[-1], res.particles[-1].numpy())
    t = paths.shape[0] // 2
    cloud = res.particles[t].numpy()
    assert np.isin(paths[t][:, 0].round(5), cloud[:, 0].round(5)).all()
    sm = smoothing.smoothed_means(res).numpy()
    assert np.sqrt(((sm[10:] - xs[10:]) ** 2).mean()) < 0.15
    uniq = smoothing.unique_path_counts(res).numpy()
    assert uniq[-1] == 2048 and (np.diff(uniq) >= 0).all()


def test_ffbs_sv_runs():
    sv = StochasticVolatility.create(device="cpu")
    xs, ys = sv.simulate(torch.Generator().manual_seed(2), 101)
    res = bootstrap_filter(3, sv, ys, 1024, resampler="systematic")
    paths = ffbs(4, sv, res, num_paths=64).numpy()
    assert paths.shape == (101, 64, 1)
    assert np.sqrt(((paths.mean(1)[:, 0] - xs.numpy()[:, 0]) ** 2).mean()) \
        < 1.0


def test_ffbs_refusals(short_run):
    model, res = short_run
    no_history = bootstrap_filter(0, model, torch.zeros(3, 2), 16,
                                  return_history=False)
    with pytest.raises(ValueError):
        ffbs(0, model, no_history)
    chi = DLM.create(noise="mvt", df=5.0, per_dim_chi=True, device="cpu",
                     **demo_model_params())
    with pytest.raises(NotImplementedError):
        transition_logpdf(chi, torch.zeros(2, 2), torch.zeros(2, 2))


def test_forecast_matches_kalman_predictive():
    # tests/test_forecast.py:28-59 at N = 4096.
    from cusmc_tpu_torch.io.data import load_y_sim

    p = demo_model_params()
    ys = load_y_sim()[:201]
    model = DLM.create(noise="mvn", device="cpu", **p)
    res = bootstrap_filter(7, model, ys, 4096, resampler="systematic",
                           return_history=False)
    xs, ysim = forecast(3, model, res.final_particles, res.final_log_weights,
                        horizon=10)
    km, kc, _ = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})
    G, F, W, V = (np.asarray(p[k], np.float64) for k in "GFWV")
    m, P = km[-1], kc[-1]
    xs, ysim = xs.double().numpy(), ysim.double().numpy()
    for t in range(10):
        m, P = G @ m, G @ P @ G.T + W
        se = np.sqrt(np.diag(P) / xs.shape[1])
        assert np.all(np.abs(xs[t].mean(0) - m) < 6 * se + 1e-3)
        assert np.allclose(np.cov(xs[t].T), P, rtol=0.15, atol=5e-3)
        se_y = np.sqrt(np.diag(F @ P @ F.T + V) / ysim.shape[1])
        assert np.all(np.abs(ysim[t].mean(0) - F @ m) < 8 * se_y + 1e-3)
        assert np.allclose(np.cov(ysim[t].T), F @ P @ F.T + V, rtol=0.15,
                           atol=5e-3)
