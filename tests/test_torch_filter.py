"""PyTorch port, the slice as a whole: one exp-space filter step against the
JAX step given JAX's replayed draws, ``run()`` against the Kalman oracle,
the Kalman filter itself, ``run()``'s output structure against
``cusmc_tpu.run``, and the port running where JAX cannot be imported.

Tolerances: one step at rtol 1e-5 (atol 1e-6 for values near zero) on
states, log-likelihoods, ESS and the evidence increment, ancestors exactly.
The carried weights are dyadic (k/8), so both packages' cumsums are exact
and the CDF search compares identical numbers. The filter-level bands are
the JAX tests' (tests/test_particle_filter.py:32-61), not tighter ones.
"""

import _torch_threads  # noqa: F401
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import jax_model, packed_noise, port_model, roll_draws, \
    to_torch

import cusmc_tpu
import cusmc_tpu_torch
from cusmc_tpu.io.data import demo_model_params as jax_demo_params
from cusmc_tpu.io.data import load_y_sim as jax_load_y_sim
from cusmc_tpu.resampling.classic import POSITION_FNS as JAX_POSITION_FNS
from cusmc_tpu.smc import kalman as jkalman
from cusmc_tpu.smc import particle_filter as jpf
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.base import CustomSSM
from cusmc_tpu_torch.smc import particle_filter as tpf
from cusmc_tpu_torch.smc.kalman import kalman_filter

N, B = 4096, 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_KEYS = ("F", "G", "V", "W", "m0", "C0")


def _carry(seed=0):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((2, N))).astype(np.float32)
    w = (rng.integers(0, 9, N) / 8.0).astype(np.float32)
    w[0] = 1.0
    return x, w


# Always-resample for both resamplers under MVN and MVT df=5; the
# ESS-adaptive step on one configuration, once resampling (threshold 1)
# and once skipping (threshold 0.01).
STEP_CASES = [(r, noise, df, None) for r in ("metropolis", "systematic")
              for noise, df in (("mvn", None), ("mvt", 5.0))] + [
    ("systematic", "mvn", None, 1.0), ("metropolis", "mvt", 5.0, 0.01)]


@pytest.mark.parametrize("resampler,noise,df,ess_threshold", STEP_CASES)
def test_one_step_matches_jax(resampler, noise, df, ess_threshold):
    jm = jax_model(noise, df)
    tm = port_model(jm)
    x, w = _carry()
    y = np.array([0.05, -0.02], np.float32)
    key, t = jax.random.key(42), 7

    jstep = jpf._fast_exp_step_factory(
        jm.propagate_packed, jm.observation_logpdf_packed, N,
        jpf.packed_exp_resample_op(resampler, N, num_steps=B),
        ess_threshold, None, True)
    (x_ref, w_ref, _), ((xh, ll_ref, a_ref), ess_ref, lz_ref) = jstep(
        (jnp.asarray(x), jnp.asarray(w), key),
        (t, jnp.asarray(y)))

    k_res, k_prop = jax.random.split(jax.random.fold_in(key, t))
    if resampler == "metropolis":
        res_draws = roll_draws(k_res, N, B)
    else:
        res_draws = to_torch(JAX_POSITION_FNS[resampler](k_res, N,
                                                         jnp.float32))
    draws = (res_draws, packed_noise(k_prop, jm, N))
    op = tpf.packed_exp_resample_op(resampler, N, num_steps=B)
    step = tpf._fast_exp_step_factory(tm, N, op, ess_threshold)
    x_new, w_new, ess, lz, ll, a = step(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
        draws=draws)

    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    for ours, ref in ((x_new, x_ref), (ll, ll_ref), (w_new, w_ref),
                      (ess, ess_ref), (lz, lz_ref)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def _posterior_mean(particles, obs_loglik):
    ll = obs_loglik.double().numpy()
    w = np.exp(ll - ll.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return (w[:, :, None] * particles.double().numpy()).sum(axis=1)


@pytest.fixture(scope="module")
def trace100():
    p = demo_model_params()
    ys = load_y_sim()[:100]
    means, covs, loglik = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})
    return p, ys, means, covs, loglik


@pytest.mark.parametrize("resampler", ["systematic", "metropolis"])
def test_run_matches_kalman_oracle(trace100, resampler):
    p, ys, km, kc, loglik = trace100
    out = cusmc_tpu_torch.run(
        N, 2, ys.shape[0], ys, p["m0"], p["C0"], p["F"], p["G"], p["V"],
        p["W"], resampler=resampler, distribution="mvn", key=0,
        return_diagnostics=True, device="cpu")
    pm = _posterior_mean(out["posterior_x"], out["obs_loglik"])
    err = np.abs(pm[5:] - km[5:])
    scale = np.sqrt(kc[5:].diagonal(axis1=1, axis2=2))
    assert np.mean(err < 4.0 * scale) > 0.99
    assert np.median(err / scale) < 0.5
    lz = float(out["log_evidence"])
    if resampler == "systematic":
        assert abs(lz - loglik) < 0.02 * abs(loglik)
    else:
        # Finite-B Metropolis sits below the Kalman logZ by more than 2%
        # over these 100 sharp-weight steps, in the JAX package too; hold
        # the port to the JAX package's own estimate at the same N.
        jout = cusmc_tpu.run(N, 2, ys.shape[0], ys, p["m0"], p["C0"],
                             p["F"], p["G"], p["V"], p["W"],
                             resampler="metropolis", distribution="mvn",
                             key=0)
        jlz = float(jout["log_evidence"])
        assert jlz < loglik and lz < loglik
        assert abs(lz - jlz) < 0.01 * abs(loglik)


def test_adaptive_run_tracks_kalman(trace100):
    p, ys, km, kc, loglik = trace100
    out = cusmc_tpu_torch.run(
        N, 2, ys.shape[0], ys, p["m0"], p["C0"], p["F"], p["G"], p["V"],
        p["W"], resampler="systematic", distribution="mvn", key=1,
        ess_threshold=0.5, return_diagnostics=True, device="cpu")
    resampled = (out["ancestors"][1:] !=
                 torch.arange(N, dtype=torch.int32)).any(dim=1)
    assert 0 < int(resampled.sum()) < ys.shape[0] - 1
    assert abs(float(out["log_evidence"]) - loglik) < 0.02 * abs(loglik)


def test_kalman_matches_jax():
    p = jax_demo_params()
    ys = jax_load_y_sim()[:301]
    ref_m, ref_c, ref_ll = jkalman.kalman_filter(
        ys, **{k: p[k] for k in ORACLE_KEYS})
    m, c, ll = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})
    np.testing.assert_allclose(m, np.asarray(ref_m), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(c, np.asarray(ref_c), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ll, float(ref_ll), rtol=1e-10)


def test_bundled_inputs_match_jax():
    np.testing.assert_array_equal(load_y_sim(), jax_load_y_sim())
    for d in (2, 4):
        for k, v in demo_model_params(d).items():
            np.testing.assert_array_equal(v, jax_demo_params(d)[k])


@pytest.mark.parametrize("resampler", ["metropolis", "stratified"])
def test_run_outputs_match_jax_structure(resampler, tmp_path):
    p = demo_model_params()
    ys = load_y_sim()[:20]
    args = (256, 2, 20, ys.T, p["m0"], p["C0"], p["F"], p["G"], p["V"],
            p["W"])
    kw = dict(df=5.0, resampler=resampler, distribution="mvt", key=3,
              return_diagnostics=True)
    ref = cusmc_tpu.run(*args, **kw)
    out = cusmc_tpu_torch.run(*args, device="cpu",
                              output_dir=str(tmp_path), **kw)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert tuple(out[k].shape) == tuple(np.shape(ref[k])), k
        assert str(out[k].dtype).replace("torch.", "") == \
            str(np.asarray(ref[k]).dtype), k
        assert bool(torch.isfinite(out[k].float()).all()), k
    assert sorted(os.listdir(tmp_path)) == ["x_t_N0.csv", "y_t.csv"]


def test_unported_options_raise():
    # What the port still refuses. Every option of bootstrap_filter is
    # ported (the batch layout, debug_checks and injected log-space ops
    # run since the generic step), so these are the refusals the JAX
    # package shares (tests/test_torch_generic_filter.py holds the two
    # packages to the same exception types), and two of the port's own:
    # an unknown engine (the JAX package runs it as the generic step) and
    # an axis given by name (a ParticleAxis is an object here).
    tm = port_model(jax_model("mvn"))
    ys = torch.zeros(5, 2)
    custom = CustomSSM.create(2, lambda p, g, s: torch.zeros(s + (2,)),
                              lambda p, g, x: x,
                              lambda p, y, x: torch.zeros(x.shape[0]))
    for model, kw, exc in (
            (tm, dict(engine="pallas"), ValueError),  # 64 < 2 tiles
            (tm, dict(engine="pallas", resampler="systematic",
                      debug_checks=True), ValueError),
            (tm, dict(layout="other"), ValueError),
            (tm, dict(layout="batch", resample_op_weights="exp",
                      resample_op=lambda *a: a), ValueError),
            (custom, dict(layout="packed"), ValueError),
            (tm, dict(resampler="nope"), KeyError),
            (tm, dict(engine="other"), ValueError),
            (tm, dict(axis_name="particles"), TypeError)):
        with pytest.raises(exc):
            tpf.bootstrap_filter(0, model, ys, 64, device="cpu", **kw)


def test_same_seed_same_result_and_generator_key():
    tm = port_model(jax_model("mvt", 5.0))
    ys = torch.from_numpy(load_y_sim()[:10].astype(np.float32))
    r1 = tpf.bootstrap_filter(5, tm, ys, 512)
    r2 = tpf.bootstrap_filter(torch.Generator().manual_seed(5), tm, ys, 512)
    assert torch.equal(r1.particles, r2.particles)
    assert float(r1.log_evidence) == float(r2.log_evidence)
    lean = tpf.bootstrap_filter(5, tm, ys, 512, return_history=False)
    assert lean.particles is None
    assert torch.equal(lean.final_particles, r1.final_particles)


def test_port_runs_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        import cusmc_tpu_torch
        import cusmc_tpu_torch.diagnostics
        import cusmc_tpu_torch.distributions.base
        import cusmc_tpu_torch.io
        import cusmc_tpu_torch.models.base
        import cusmc_tpu_torch.parallel
        import cusmc_tpu_torch.resampling
        import cusmc_tpu_torch.utils.debug
        import cusmc_tpu_torch.__main__
        import cusmc_tpu_torch.checkpoint
        import cusmc_tpu_torch.config
        import cusmc_tpu_torch.io.disk_store
        import cusmc_tpu_torch.io.native
        import cusmc_tpu_torch.io.native_store
        import cusmc_tpu_torch.smc.streaming
        import cusmc_tpu_torch.utils.rng
        import cusmc_tpu_torch.utils.timing
        import cusmc_tpu_torch.mcmc
        import cusmc_tpu_torch.diagnostics.mcmc
        import cusmc_tpu_torch.parallel.enkf
        import cusmc_tpu_torch.parallel.replicated
        from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
        p = demo_model_params()
        out = cusmc_tpu_torch.run(256, 2, 5, load_y_sim()[:5], p["m0"],
                                  p["C0"], p["F"], p["G"], p["V"], p["W"],
                                  df=5.0, distribution="mvt", key=0,
                                  device="cpu")
        assert out["posterior_x"].shape == (5, 256, 2)
        custom = cusmc_tpu_torch.CustomSSM.create(
            2, lambda p, g, s: torch.zeros(s + (2,)),
            lambda p, g, x: x + 0.01 * torch.randn(x.shape, generator=g),
            lambda p, y, x: -((y - x) ** 2).sum(-1))
        res = cusmc_tpu_torch.bootstrap_filter(0, custom, load_y_sim()[:5],
                                               64, device="cpu")
        assert res.particles.shape == (5, 64, 2)
        model = cusmc_tpu_torch.DLM.create(device="cpu", **p)
        res, store = cusmc_tpu_torch.smc.streaming.\
            streaming_bootstrap_filter(0, model, load_y_sim()[:9], 64,
                                       chunk_steps=4)
        assert store.view().shape == (9, 64, 2)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "cusmc_tpu", "flax")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
