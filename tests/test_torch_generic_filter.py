"""PyTorch port, the generic filter step: one log-space step against
``cusmc_tpu``'s ``_step_factory`` given JAX's replayed draws, in both
layouts, for every registry resampler and a custom registered key; the
fast metropolis path against the generic one on one seed; the batch
layout, a ``CustomSSM``, the generic packed residual and the custom key
against the Kalman oracle; the ESS-adaptive step against the log-space
oracle; time hooks; ``debug_checks``; and the engine and layout refusals
against the JAX package's.

Tolerances: one step at rtol 1e-5 (atol 1e-6) on states, log-likelihoods,
normalised log weights, ESS and the evidence increment, ancestors exactly.
The carried log weights are dyadic (``_torch_replay.dyadic_logw``), so
both packages' softmax and cdf are exact and the searches compare equal
numbers; the residual's remainder positions are the port's, handed to
JAX (its log and cumsum of the spacings round in another order). The
fast-against-generic run uses ``tests/test_particle_filter.py:117-141``'s
sizes and tolerances, the oracle runs the JAX tests' bands
(``tests/test_particle_filter.py:32-61, 219-246``).
"""

import _torch_threads  # noqa: F401
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import TINY, dyadic_logw, jax_model, metropolis_draws, \
    packed_noise, port_model, roll_draws, to_torch

from cusmc_tpu import resampling as jresampling
from cusmc_tpu.models.base import CustomSSM as JCustomSSM
from cusmc_tpu.resampling import classic as jclassic
from cusmc_tpu.resampling.metropolis import metropolis_ancestors as jma
from cusmc_tpu.smc import particle_filter as jpf
from cusmc_tpu_torch import resampling
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.base import CustomSSM, normalize_time_hook
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.resampling.metropolis import metropolis_ancestors
from cusmc_tpu_torch.smc import particle_filter as tpf
from cusmc_tpu_torch.smc.kalman import kalman_filter

N, B = 4096, 10
F32 = jnp.float32
CUSTOM = "metropolis_custom"
ORACLE_KEYS = ("F", "G", "V", "W", "m0", "C0")


@pytest.fixture
def custom_key(monkeypatch):
    """The indexed Metropolis resampler under a new registry key in both
    packages: the packed generic step runs it through take-columns."""
    monkeypatch.setitem(jresampling.RESAMPLERS, CUSTOM, jma)
    monkeypatch.setitem(resampling.RESAMPLERS, CUSTOM, metropolis_ancestors)
    return CUSTOM


def _batch_noise(key, jm, n):
    """The draws of the JAX batch ``DLM.propagate(key, x)``: z, and for
    MVT the chi-square variates of ``jax.random.gamma``
    (``distributions/mvt.py:119-131``: ``kz, kg = split(key)``)."""
    d = jm.state_dim
    if jm.noise != "mvt":
        return (to_torch(jax.random.normal(key, (n, d), F32)),)
    kz, kg = jax.random.split(key)
    z = jax.random.normal(kz, (n, d), F32)
    df = jnp.asarray(jm.df, F32)
    g = 2.0 * jax.random.gamma(kg, 0.5 * df, (n, 1), dtype=F32)
    return to_torch(z), to_torch(g)


def _replay_residual(monkeypatch, k_res):
    """The residual's N+1 uniforms; JAX's ``_residual_positions`` is made
    to return the port's positions for them."""
    u = np.array(jax.random.uniform(k_res, (N + 1,), F32, minval=TINY))
    s = jnp.asarray(torch.cumsum(-torch.log(torch.from_numpy(u)),
                                 0).numpy())
    monkeypatch.setattr(jclassic, "_residual_positions",
                        lambda key, n, n_det, dtype:
                        s[:n] / jnp.take(s, n - n_det))
    return torch.from_numpy(u)


def _res_draws(monkeypatch, layout, name, k_res):
    if name == "metropolis" and layout == "packed":
        return roll_draws(k_res, N, B)
    if name in ("metropolis", CUSTOM):
        j, u = metropolis_draws(k_res, N, B)
        return {"j": j, "u": u}
    if name == "residual":
        return _replay_residual(monkeypatch, k_res)
    if layout == "batch":  # systematic_ancestors: one offset
        return {"u": to_torch(jax.random.uniform(k_res, (), F32))}
    return to_torch(jclassic.POSITION_FNS[name](k_res, N, F32))


def _ops(layout, name):
    kw = {"num_steps": B} if name in ("metropolis", CUSTOM) else {}
    if layout == "packed":
        return (jpf.packed_resample_op(name, N, **kw),
                tpf.packed_resample_op(name, N, **kw))
    return (jpf.local_resample_op(jresampling.get_resampler(name, **kw), N),
            tpf.local_resample_op(resampling.get_resampler(name, **kw), N))


STEP_CASES = [(layout, name, noise, None)
              for layout, name in (("packed", "metropolis"),
                                   ("packed", "systematic"),
                                   ("packed", "stratified"),
                                   ("packed", "multinomial"),
                                   ("packed", "residual"),
                                   ("packed", CUSTOM),
                                   ("batch", "systematic"),
                                   ("batch", "metropolis"))
              for noise in ("mvn", "mvt")] + [
    ("packed", "systematic", "mvt", 1.0),   # ESS < N: resamples
    ("batch", "metropolis", "mvn", 0.01)]  # skips


@pytest.mark.parametrize("layout,name,noise,ess_threshold", STEP_CASES)
def test_one_generic_step_matches_jax(monkeypatch, custom_key, layout, name,
                                      noise, ess_threshold):
    jm = jax_model(noise, 5.0 if noise == "mvt" else None)
    tm = port_model(jm)
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((2, N))).astype(np.float32)
    if layout == "batch":
        x = np.ascontiguousarray(x.T)
    logw = dyadic_logw(rng, N)
    y = np.array([0.05, -0.02], np.float32)
    key, t = jax.random.key(42), 7
    k_res, k_prop = jax.random.split(jax.random.fold_in(key, t))
    res_draws = _res_draws(monkeypatch, layout, name, k_res)
    jop, top = _ops(layout, name)
    if layout == "packed":
        jfns = (jm.propagate_packed, jm.observation_logpdf_packed)
        tfns = (tm.propagate_packed, tm.observation_logpdf_packed)
        noise_draws = packed_noise(k_prop, jm, N)
    else:
        jfns = (jm.propagate, jm.observation_logpdf)
        tfns = (tm.propagate, tm.observation_logpdf)
        noise_draws = _batch_noise(k_prop, jm, N)

    jstep = jpf._step_factory(*jfns, jop, ess_threshold, N, None, True)
    (x_ref, lw_ref, _), ((_, ll_ref, a_ref), ess_ref, lz_ref) = jstep(
        (jnp.asarray(x), jnp.asarray(logw), key), (t, jnp.asarray(y)))
    step = tpf._step_factory(*tfns, top, ess_threshold, N)
    x_new, lw_new, ess, lz, ll, a = step(
        torch.from_numpy(x), torch.from_numpy(logw), torch.from_numpy(y),
        draws=(res_draws, noise_draws), t=t)

    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    if ess_threshold == 0.01:
        np.testing.assert_array_equal(a.numpy(), np.arange(N))
    for ours, ref in ((x_new, x_ref), (ll, ll_ref), (lw_new, lw_ref),
                      (ess, ess_ref), (lz, lz_ref)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_fast_metropolis_path_matches_generic():
    # tests/test_particle_filter.py:117-141: debug_checks=True takes the
    # generic step; both draw the same numbers from the same seed.
    model = DLM.create(noise="mvt", df=5.0, device="cpu",
                       **demo_model_params())
    _, ys = model.simulate(torch.Generator().manual_seed(4), 40)
    fast = tpf.bootstrap_filter(4, model, ys, 512, resampler="metropolis")
    slow = tpf.bootstrap_filter(4, model, ys, 512, resampler="metropolis",
                                debug_checks=True)
    np.testing.assert_array_equal(fast.ancestors.numpy(),
                                  slow.ancestors.numpy())
    np.testing.assert_allclose(fast.particles.numpy(),
                               slow.particles.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(fast.log_evidence),
                               float(slow.log_evidence), rtol=1e-4)
    np.testing.assert_allclose(fast.ess.numpy(), slow.ess.numpy(), rtol=1e-3)


def _wrapped(dlm):
    """The demo DLM as a ``CustomSSM`` (batch methods only)."""
    return CustomSSM.create(
        dlm.state_dim,
        lambda prm, gen, shape: prm["m"].sample_initial(gen, shape),
        lambda prm, gen, x: prm["m"].propagate(gen, x),
        lambda prm, y, x: prm["m"].observation_logpdf(y, x),
        params={"m": dlm})


@pytest.fixture(scope="module")
def trace():
    p = demo_model_params()
    ys = load_y_sim()[:100]
    means, covs, loglik = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})
    return p, ys, means, covs, loglik


def _posterior_mean(res):
    ll = res.obs_loglik.double().numpy()
    w = np.exp(ll - ll.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return (w[:, :, None] * res.particles.double().numpy()).sum(axis=1)


@pytest.mark.parametrize("case", ["batch systematic", "CustomSSM",
                                  "packed residual", CUSTOM])
def test_generic_runs_match_kalman_oracle(custom_key, trace, case):
    p, ys, km, kc, loglik = trace
    dlm = DLM.create(noise="mvn", device="cpu", **p)
    model, kw = {
        "batch systematic": (dlm, dict(layout="batch",
                                       resampler="systematic")),
        "CustomSSM": (_wrapped(dlm), dict(resampler="systematic")),
        "packed residual": (dlm, dict(resampler="residual",
                                      debug_checks=True)),
        CUSTOM: (dlm, dict(resampler=CUSTOM))}[case]
    res = tpf.bootstrap_filter(1, model, ys, N, device="cpu", **kw)
    packed = case in ("packed residual", CUSTOM)
    assert res.particles.shape == (100, N, 2)
    assert res.final_particles.shape == (N, 2)
    if not packed:  # batch results as drawn, [T, N, d]
        assert torch.equal(res.final_particles, res.particles[-1])
    pm = _posterior_mean(res)
    err = np.abs(pm[5:] - km[5:])
    scale = np.sqrt(kc[5:].diagonal(axis1=1, axis2=2))
    assert np.mean(err < 4.0 * scale) > 0.99
    assert np.median(err / scale) < 0.5
    if case != CUSTOM:  # finite-B Metropolis sits below the Kalman logZ
        assert abs(float(res.log_evidence) - loglik) < 0.02 * abs(loglik)


def test_adaptive_matches_log_oracle_realistic(trace):
    # tests/test_particle_filter.py:219-246 with the port's generic step
    # (debug_checks=True) as the log-space oracle of the exp-space one.
    p, ys, _, _, loglik = trace
    model = DLM.create(noise="mvn", device="cpu", **p)
    kw = dict(resampler="systematic", ess_threshold=0.5)
    res = tpf.bootstrap_filter(2, model, ys, 2048, **kw)
    ref = tpf.bootstrap_filter(2, model, ys, 2048, debug_checks=True, **kw)

    def fires(r):
        a = r.ancestors.numpy()
        return int((a != np.arange(2048)[None, :]).any(axis=1).sum())

    assert 0 < fires(ref) < ys.shape[0] - 1
    assert abs(fires(res) - fires(ref)) <= 5, (fires(res), fires(ref))
    for r in (res, ref):
        assert abs(float(r.log_evidence) - loglik) < 0.03 * abs(loglik)


class _TimeHooked:
    """The demo DLM with packed and batch hooks that take the step t and
    record it."""

    def __init__(self, dlm):
        self.dlm = dlm
        self.seen = {k: [] for k in ("propagate", "observation_logpdf",
                                     "propagate_packed",
                                     "observation_logpdf_packed")}
        self.state_dim = dlm.state_dim
        self.device = dlm.device

    def sample_initial(self, gen, shape):
        return self.dlm.sample_initial(gen, shape)

    def sample_initial_packed(self, gen, n):
        return self.dlm.sample_initial_packed(gen, n)

    def propagate(self, gen, x, t):
        self.seen["propagate"].append(t)
        return self.dlm.propagate(gen, x)

    def observation_logpdf(self, y, x, t):
        self.seen["observation_logpdf"].append(t)
        return self.dlm.observation_logpdf(y, x)

    def propagate_packed(self, gen, X, t):
        self.seen["propagate_packed"].append(t)
        return self.dlm.propagate_packed(gen, X)

    def observation_logpdf_packed(self, y, X, t):
        self.seen["observation_logpdf_packed"].append(t)
        return self.dlm.observation_logpdf_packed(y, X)


def test_time_hooks_receive_the_step():
    dlm = DLM.create(noise="mvn", device="cpu", **demo_model_params())
    ys = load_y_sim()[:9]
    steps = list(range(1, 9))
    for kw, hooks in ((dict(), ("propagate_packed",
                                "observation_logpdf_packed")),
                      (dict(debug_checks=True), ("propagate_packed",
                                                 "observation_logpdf_packed")),
                      (dict(layout="batch"), ("propagate",
                                              "observation_logpdf"))):
        model = _TimeHooked(dlm)
        res = tpf.bootstrap_filter(0, model, ys, 256, **kw)
        assert bool(torch.isfinite(res.log_evidence))
        for name, seen in model.seen.items():
            assert seen == (steps if name in hooks else []), (kw, name)
    # Time-invariant hooks draw what the DLM draws.
    ref = tpf.bootstrap_filter(0, dlm, ys, 256)
    assert torch.equal(tpf.bootstrap_filter(0, _TimeHooked(dlm), ys,
                                            256).particles, ref.particles)


def test_a_hook_without_a_readable_signature_raises():
    class Opaque:
        __signature__ = "unreadable"  # inspect.signature cannot parse it

        def __call__(self, gen, x):
            return x

    class Model:
        state_dim = 2
        propagate = Opaque()

        def sample_initial(self, gen, shape):
            return torch.zeros(shape + (2,))

        def observation_logpdf(self, y, x):
            return torch.zeros(x.shape[0])

    with pytest.raises((TypeError, ValueError)):
        inspect.signature(Opaque())
    with pytest.raises(TypeError, match="Opaque"):
        normalize_time_hook(Opaque(), "x")
    with pytest.raises(TypeError, match="Opaque"):
        tpf.bootstrap_filter(0, Model(), torch.zeros(3, 2), 8, device="cpu")


def test_debug_checks_print_the_weight_guard(capsys):
    dlm = DLM.create(noise="mvn", device="cpu", **demo_model_params())

    class NanAtThree:
        """The demo DLM in the batch layout, its likelihood NaN at t=3."""

        state_dim = 2
        sample_initial = dlm.sample_initial
        propagate = dlm.propagate

        def observation_logpdf(self, y, x, t):
            ll = dlm.observation_logpdf(y, x)
            return torch.full_like(ll, float("nan")) if t == 3 else ll

    model = NanAtThree()
    ys = load_y_sim()[:6]
    tpf.bootstrap_filter(0, model, ys, 128, device="cpu")
    assert capsys.readouterr().out == ""  # no guard without debug_checks
    tpf.bootstrap_filter(0, model, ys, 128, device="cpu", debug_checks=True)
    out = capsys.readouterr().out.splitlines()
    assert "weight guard: nan=True collapsed=False at t=3" in out[0]
    healthy = tpf.bootstrap_filter(0, dlm, ys, 128, debug_checks=True)
    assert bool(torch.isfinite(healthy.log_evidence))
    assert capsys.readouterr().out == ""


def _jax_custom(jm):
    return JCustomSSM.create(
        jm.state_dim, lambda prm, key, shape: jm.sample_initial(key, shape),
        lambda prm, key, x: jm.propagate(key, x),
        lambda prm, y, x: jm.observation_logpdf(y, x))


REFUSAL_CASES = [
    dict(engine="pallas", resampler="systematic", debug_checks=True),
    dict(engine="pallas", resampler="metropolis", debug_checks=True),
    dict(engine="pallas", resampler="metropolis", layout="batch"),
    dict(engine="pallas", ess_threshold=0.5),
    dict(layout="other"),
    dict(layout="packed", custom=True),
    dict(resample_op=lambda *a: a, resample_op_weights="exp"),
    dict(resampler="nope"),
    dict(layout="batch", resampler="residual"),
    dict(debug_checks=True, resampler="stratified"),
    dict(custom=True, resampler="multinomial"),
]


@pytest.mark.parametrize("kw", REFUSAL_CASES,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                 kw.items()
                                                 if k != "resample_op"))
def test_engine_and_layout_refusals_match_jax(kw):
    # The same call into both packages raises the same exception type, or
    # both run. The fused Metropolis step ignores debug_checks in both
    # (it runs); the fused CDF step refuses it.
    kw = dict(kw)
    custom = kw.pop("custom", False)
    jm = jax_model("mvn")
    ys = load_y_sim()[:4].astype(np.float32)
    n = 4096
    jmodel = _jax_custom(jm) if custom else jm
    tmodel = _wrapped(port_model(jm)) if custom else port_model(jm)

    def outcome(fn):
        try:
            fn()
        except Exception as err:  # noqa: BLE001 - compared across packages
            return type(err)
        return None

    jkw = dict(kw, pallas_interpret=True) if "engine" in kw else kw
    want = outcome(lambda: jpf.bootstrap_filter(
        jax.random.key(0), jmodel, jnp.asarray(ys), n, **jkw))
    got = outcome(lambda: tpf.bootstrap_filter(
        0, tmodel, torch.from_numpy(ys), n, device="cpu", **kw))
    assert got is want, (got, want)
