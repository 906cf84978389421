"""PyTorch port, the other model families: stochastic volatility, UNGM, the
structural builders and the CLGSSM, against ``cusmc_tpu``'s.

Exact parity, given JAX's replayed normals: every method of the stochastic
volatility model and UNGM and their ``simulate`` at rtol 1e-5 (atol 1e-6);
``combine``'s F, G, m0 and the factors of W, C0 and V bitwise; and
``bootstrap_filter`` on both models (the packed exp-space step, metropolis
and systematic; T = 8, and T = 5 for UNGM; N = 256) with the initial
cloud, the resample draws and the noise of every step replayed: ancestors
equal (systematic: but at a shown cdf tie, the two packages summing the
cdf in different float32 orders), states, log-likelihoods, ESS and
log-evidence at rtol 1e-5. The JAX UNGM filter runs op by op
(``jax.disable_jit``): compiled, XLA rewrites UNGM's arithmetic an ulp
away on about a quarter of the particles, and a Metropolis accept within
that rounding flips. Torch flushes subnormal floats to zero for the
replayed runs, as XLA on the CPU does.

Oracles, the JAX tests' at N <= 4096 (tests/test_models_smoothing_pmmh.py,
tests/test_ungm.py, tests/test_structural.py): the filtered log-volatility
against the truth, UNGM against the dense-grid filter (and the time hook
really used), the structural superposition against Kalman.
"""

import _torch_threads  # noqa: F401
import contextlib

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import F32, filter_step_keys, normal_noise, port_model, \
    roll_draws, to_torch

from cusmc_tpu.models import structural as jstructural
from cusmc_tpu.models.clgssm import CLGSSM as JCLGSSM
from cusmc_tpu.models.stochvol import StochasticVolatility as JSV
from cusmc_tpu.models.ungm import UNGM as JUNGM
from cusmc_tpu.resampling.classic import POSITION_FNS as JPOS
from cusmc_tpu.smc import particle_filter as jpf
from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.models import structural
from cusmc_tpu_torch.models.clgssm import CLGSSM, params_from_numpy
from cusmc_tpu_torch.models.stochvol import StochasticVolatility
from cusmc_tpu_torch.models.ungm import UNGM
from cusmc_tpu_torch.smc import particle_filter as tpf
from cusmc_tpu_torch.smc.kalman import kalman_filter

N = 256
RTOL, ATOL = 1e-5, 1e-6


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def sv_pair():
    jm = JSV.create(mu=-1.0, phi=0.9, sigma=0.4, beta=0.8)
    return jm, port_model(jm)


@pytest.fixture(scope="module")
def ungm_pair():
    jm = JUNGM.create(q=10.0, r=1.0)
    return jm, port_model(jm)


SV_METHODS = ["sample_initial", "propagate", "propagate_mean",
              "observation_logpdf", "sample_initial_packed",
              "propagate_packed", "observation_logpdf_packed",
              "sample_observation"]


@pytest.mark.parametrize("method", SV_METHODS)
def test_sv_method_matches_jax(sv_pair, method):
    jm, tm = sv_pair
    key = jax.random.key(3)
    rng = np.random.default_rng(1)
    x = (-1.0 + rng.standard_normal((N, 1))).astype(np.float32)
    y = np.array([0.7], np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if method == "sample_initial":
        ref = jm.sample_initial(key, (N,))
        ours = tm.sample_initial(None, (N,), noise=normal_noise(key, (N, 1)))
    elif method == "propagate":
        ref = jm.propagate(key, jx)
        ours = tm.propagate(None, tx, noise=normal_noise(key, (N, 1)))
    elif method == "propagate_mean":
        ref, ours = jm.propagate_mean(jx), tm.propagate_mean(tx)
    elif method == "observation_logpdf":
        ref = jm.observation_logpdf(jnp.asarray(y), jx)
        ours = tm.observation_logpdf(torch.from_numpy(y), tx)
    elif method == "sample_initial_packed":
        ref = jm.sample_initial_packed(key, N)
        ours = tm.sample_initial_packed(None, N,
                                        noise=normal_noise(key, (1, N)))
    elif method == "propagate_packed":
        ref = jm.propagate_packed(key, jx.T)
        ours = tm.propagate_packed(None, tx.T, noise=normal_noise(key, (1, N)))
    elif method == "observation_logpdf_packed":
        ref = jm.observation_logpdf_packed(jnp.asarray(y), jx.T)
        ours = tm.observation_logpdf_packed(torch.from_numpy(y), tx.T)
    else:
        ref = jm.sample_observation(key, jx)
        ours = tm.sample_observation(None, tx, noise=normal_noise(key, (N,)))
    assert tuple(ours.shape) == tuple(ref.shape)
    _close(ours.numpy(), ref)


def _sv_simulate_noise(key, num_steps):
    k0, key = jax.random.split(key)
    keys = jax.random.split(key, num_steps - 1)
    zx, zy = [], []
    for k in keys:
        kp, ko = jax.random.split(k)
        zx.append(jax.random.normal(kp, (1,), F32))
        zy.append(jax.random.normal(ko, (), F32))
    return (to_torch(jax.random.normal(k0, (1,), F32)),
            to_torch(jnp.stack(zx)), to_torch(jnp.stack(zy)))


def _ungm_simulate_noise(key, num_steps):
    k0, key = jax.random.split(key)
    keys = jax.random.split(key, num_steps - 1)
    zx, zy = [], []
    for k in keys:
        kp, ko = jax.random.split(k)
        zx.append(jax.random.normal(kp, (1, 1), F32)[0, 0])
        zy.append(jax.random.normal(ko, (), F32))
    return (to_torch(jax.random.normal(k0, (), F32)),
            to_torch(jnp.stack(zx)), to_torch(jnp.stack(zy)))


def test_sv_simulate_matches_jax(sv_pair):
    jm, tm = sv_pair
    key = jax.random.key(7)
    xs_ref, ys_ref = jm.simulate(key, 31)
    xs, ys = tm.simulate(None, 31, noise=_sv_simulate_noise(key, 31))
    assert xs.shape == (31, 1) and ys.shape == (31, 1)
    _close(xs.numpy(), xs_ref)
    _close(ys.numpy(), ys_ref)


UNGM_METHODS = ["sample_initial_packed", "propagate_packed",
                "propagate_packed t", "observation_logpdf_packed"]


@pytest.mark.parametrize("method", UNGM_METHODS)
def test_ungm_method_matches_jax(ungm_pair, method):
    jm, tm = ungm_pair
    key = jax.random.key(5)
    rng = np.random.default_rng(2)
    X = (5.0 * rng.standard_normal((1, N))).astype(np.float32)
    jX, tX = jnp.asarray(X), torch.from_numpy(X)
    noise = normal_noise(key, (1, N))
    if method == "sample_initial_packed":
        ref = jm.sample_initial_packed(key, N)
        ours = tm.sample_initial_packed(None, N, noise=noise)
    elif method == "propagate_packed":
        ref = jm.propagate_packed(key, jX)
        ours = tm.propagate_packed(None, tX, noise=noise)
    elif method == "propagate_packed t":
        ref = jm.propagate_packed(key, jX, 7)
        ours = tm.propagate_packed(None, tX, 7, noise=noise)
    else:
        y = np.array([3.1], np.float32)
        ref = jm.observation_logpdf_packed(jnp.asarray(y), jX)
        ours = tm.observation_logpdf_packed(torch.from_numpy(y), tX)
    _close(ours.numpy(), ref)


def test_ungm_simulate_matches_jax(ungm_pair):
    jm, tm = ungm_pair
    key = jax.random.key(7)
    with jax.disable_jit():  # op by op, as in _filter_parity below
        xs_ref, ys_ref = jm.simulate(key, 20)
    xs, ys = tm.simulate(None, 20, noise=_ungm_simulate_noise(key, 20))
    assert xs.shape == (20,) and ys.shape == (20, 1)
    assert np.isfinite(xs.numpy()).all() and np.isfinite(ys.numpy()).all()
    _close(xs.numpy(), xs_ref)
    _close(ys.numpy(), ys_ref)


# -- bootstrap_filter on the packed fast step, replayed -----------------

@pytest.fixture
def flush_denormal():
    """XLA on the CPU flushes subnormal floats to zero, torch does not: an
    exp-space weight 87-104 nats below the step's largest is subnormal in
    float32, and a Metropolis accept that compares one differs. The
    replayed runs flush them in torch too, for their duration."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _filter_parity(monkeypatch, jm, ys, resampler, t_hook=False, sweeps=10):
    key = jax.random.key(11)
    # Op by op: compiled XLA rewrites UNGM's drift and x^2 / 20 (an ulp
    # off on about a quarter of the particles), which flips Metropolis
    # accepts that sit within that rounding.
    with jax.disable_jit() if t_hook else contextlib.nullcontext():
        ref = jpf.bootstrap_filter(key, jm, jnp.asarray(ys), N,
                                   resampler=resampler,
                                   resampler_kwargs={"num_steps": sweeps})
    k_init, step_keys = filter_step_keys(key, ys.shape[0])
    res_draws, noises = [], []
    for k in step_keys:
        k_res, k_prop = jax.random.split(k)
        res_draws.append(roll_draws(k_res, N, sweeps)
                         if resampler == "metropolis"
                         else to_torch(JPOS[resampler](k_res, N, F32)))
        noises.append(normal_noise(k_prop, (1, N)))
    tm = port_model(jm)
    cls = type(tm)
    x0 = normal_noise(k_init, (1, N))
    rit, nit = iter(res_draws), iter(noises)
    monkeypatch.setattr(tm, "sample_initial_packed",
                        lambda gen, n: cls.sample_initial_packed(
                            tm, None, n, noise=x0))
    if t_hook:
        monkeypatch.setattr(tm, "propagate_packed",
                            lambda gen, X, t=None: cls.propagate_packed(
                                tm, None, X, t, noise=next(nit)))
    else:
        monkeypatch.setattr(tm, "propagate_packed",
                            lambda gen, X: cls.propagate_packed(
                                tm, None, X, noise=next(nit)))
    monkeypatch.setattr(tpf.ExpResampleOp, "draw",
                        lambda self, streams, w: next(rit))
    out = tpf.bootstrap_filter(0, tm, torch.from_numpy(ys), N,
                               resampler=resampler,
                               resampler_kwargs={"num_steps": sweeps})
    ours_a, ref_a = out.ancestors.numpy(), np.asarray(ref.ancestors)
    clean = np.ones(N, bool)
    ties = 0
    for t in range(1, ys.shape[0]):
        diff = np.nonzero(ours_a[t] != ref_a[t])[0]
        if resampler == "metropolis":
            np.testing.assert_array_equal(ours_a[t], ref_a[t])
        elif diff.size:
            ll = out.obs_loglik[t - 1].double().numpy()
            w = np.ones(N) if t == 1 else np.exp(ll - ll.max())
            cdf = np.cumsum(w)
            pos = res_draws[t - 1].double().numpy()[diff] * cdf[-1]
            for g, p in zip(diff, pos):
                lo, hi = sorted((ours_a[t][g], ref_a[t][g]))
                assert np.all(np.abs(cdf[lo:hi] - p) <= 1e-5 * cdf[-1])
            ties += diff.size
        clean = clean[ours_a[t]] & (ours_a[t] == ref_a[t])
        for ours, theirs in ((out.particles[t], ref.particles[t]),
                             (out.obs_loglik[t], ref.obs_loglik[t])):
            _close(ours.numpy()[clean], np.asarray(theirs)[clean])
    assert ties <= 2, ties
    if not ties:
        _close(out.ess.numpy(), ref.ess)
        _close(out.log_evidence.numpy(), ref.log_evidence)
        # XLA flushes an exp-space weight that is subnormal (its log-lik
        # more than log(tiny) ~ -87.3 below the step's largest) to zero,
        # and JAX's final log weight is then -inf; torch's exp keeps it.
        ours, theirs = (out.final_log_weights.numpy(),
                        np.asarray(ref.final_log_weights))
        flushed = np.isneginf(theirs) & ~np.isneginf(ours)
        ll = out.obs_loglik[-1].double().numpy()
        tiny = np.log(np.finfo(np.float32).tiny)
        assert np.all(ll[flushed] - ll.max() < tiny)
        _close(ours[~flushed], theirs[~flushed])


@pytest.mark.parametrize("resampler", ["metropolis", "systematic"])
def test_sv_bootstrap_filter_matches_jax(monkeypatch, flush_denormal,
                                         sv_pair, resampler):
    jm, _ = sv_pair
    _, ys = jm.simulate(jax.random.key(4), 8)
    _filter_parity(monkeypatch, jm, np.asarray(ys, np.float32), resampler)


@pytest.mark.parametrize("resampler", ["metropolis", "systematic"])
def test_ungm_bootstrap_filter_matches_jax(monkeypatch, flush_denormal,
                                           ungm_pair, resampler):
    # Op by op a JAX Metropolis sweep costs seconds: five steps of two
    # sweeps each.
    jm, _ = ungm_pair
    _, ys = jm.simulate(jax.random.key(4), 5)
    _filter_parity(monkeypatch, jm, np.asarray(ys, np.float32), resampler,
                   t_hook=True, sweeps=2)


# -- oracles --------------------------------------------------------------

@pytest.fixture(scope="module")
def sv_trace():
    model = StochasticVolatility.create(mu=-1.0, phi=0.9, sigma=0.4,
                                        beta=0.8, device="cpu")
    xs, ys = model.simulate(torch.Generator().manual_seed(7), 301)
    return model, xs.numpy(), ys


@pytest.mark.parametrize("layout", ["packed", "batch"])
def test_sv_filter_tracks_volatility(sv_trace, layout):
    # tests/test_models_smoothing_pmmh.py:31-44, N = 4096.
    model, xs, ys = sv_trace
    res = tpf.bootstrap_filter(1, model, ys, 4096, resampler="systematic",
                               layout=layout)
    ll = res.obs_loglik.double().numpy()
    w = np.exp(ll - ll.max(1, keepdims=True))
    w /= w.sum(1, keepdims=True)
    pm = (w[:, :, None] * res.particles.double().numpy()).sum(1)[:, 0]
    assert np.corrcoef(pm[10:], xs[10:, 0])[0, 1] > 0.6
    assert np.isfinite(float(res.log_evidence))


def test_sv_ess_adaptive(sv_trace):
    model, _, ys = sv_trace
    res = tpf.bootstrap_filter(1, model, ys, 1024, resampler="systematic",
                               ess_threshold=0.5)
    assert np.isfinite(res.ess.numpy()).all()


@pytest.fixture(scope="module")
def ungm_trace():
    model = UNGM.create(q=10.0, r=1.0, device="cpu")
    xs, ys = model.simulate(torch.Generator().manual_seed(7), 60)
    return model, ys.numpy()


def test_ungm_tracks_grid_oracle(ungm_trace):
    # tests/test_ungm.py:48-63 at N = 4096, against the dense-grid filter
    # of tests/test_ungm.py:16 that chip_smoke.py's phase 4g copies.
    model, ys = ungm_trace
    res = tpf.bootstrap_filter(2, model, ys, 4096, resampler="systematic")
    hist = res.particles.double().numpy()[..., 0]
    ll = res.obs_loglik.double().numpy()
    w = np.exp(ll - ll.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    err = np.abs((w * hist).sum(-1)[1:]
                 - chip_smoke.grid_filter(10.0, 1.0, 2.0, ys)[1:])
    assert np.median(err) < 0.5
    assert err.mean() < 1.5


def test_ungm_time_dependence_actually_used(ungm_trace):
    # tests/test_ungm.py:66-83: a propagate that ignores t is another
    # filter; the step must reach the hook.
    model, ys = ungm_trace
    seen = []

    class Frozen(UNGM):
        def propagate_packed(self, gen, X, t=None, noise=None):
            seen.append(t)
            return UNGM.propagate_packed(self, gen, X, 0.0, noise)

    frozen = Frozen(model.q, model.r, model.x0_std)
    res_t = tpf.bootstrap_filter(3, model, ys, 512, resampler="systematic",
                                 return_history=False)
    res_0 = tpf.bootstrap_filter(3, frozen, ys, 512, resampler="systematic",
                                 return_history=False)
    assert seen == list(range(1, ys.shape[0]))
    assert abs(float(res_t.log_evidence) - float(res_0.log_evidence)) > 1.0


def test_sv_band_holds_on_the_cpu():
    # chip_smoke.py phase 4g holds the bootstrap filter's log-evidence on
    # a T = 200 stochastic volatility trace to the APF's within
    # SV_APF_BAND at N = 2^20; here, at N = 2^14, the spread is wider.
    from cusmc_tpu_torch.smc.apf import auxiliary_filter

    sv = StochasticVolatility.create(device="cpu")
    _, ys = sv.simulate(torch.Generator().manual_seed(0), chip_smoke.AUX_T)
    n = 1 << 14
    lz_apf = float(auxiliary_filter(1, sv, ys, n,
                                    return_history=False).log_evidence)
    for resampler in ("metropolis", "systematic"):
        res = tpf.bootstrap_filter(2, sv, ys, n, resampler=resampler,
                                   return_history=False)
        assert abs(float(res.log_evidence) - lz_apf) < chip_smoke.SV_APF_BAND


# -- structural builders --------------------------------------------------

DLM_FIELDS = ("F", "G", "m0", "W_sqrt", "C0_sqrt", "V_chol")


@pytest.mark.parametrize("parts", [
    ("trend", "seasonal4"), ("trend", "seasonal12"), ("level",)])
def test_combine_matches_jax_bitwise(parts):
    def build(mod):
        return [{"trend": lambda: mod.local_linear_trend(),
                 "level": lambda: mod.local_level(level_var=0.02),
                 "seasonal4": lambda: mod.seasonal(4, seasonal_var=5e-3),
                 "seasonal12": lambda: mod.seasonal(12)}[p]()
                for p in parts]

    jm = jstructural.combine(build(jstructural), obs_var=0.25)
    tm = structural.combine(build(structural), obs_var=0.25, device="cpu")
    for name in DLM_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))


def test_combine_blocks_and_shapes():
    # tests/test_structural.py:22-36.
    model = structural.combine([structural.local_linear_trend(),
                                structural.seasonal(4)], obs_var=0.2,
                               device="cpu")
    G = model.G.double().numpy()
    assert G.shape == (5, 5) and model.F.shape == (1, 5)
    assert np.all(G[:2, 2:] == 0) and np.all(G[2:, :2] == 0)
    np.testing.assert_array_equal(G[:2, :2], [[1, 1], [0, 1]])
    np.testing.assert_array_equal(model.F.numpy()[0], [1, 0, 1, 0, 0])
    assert abs(float(model.V_chol[0, 0] ** 2) - 0.2) < 1e-6
    monthly = structural.combine([structural.local_linear_trend(),
                                  structural.seasonal(12)], device="cpu")
    assert (monthly.state_dim, monthly.obs_dim) == (13, 1)


def test_seasonal_rotation_sums_to_zero():
    s = 5
    G = structural.seasonal(s, seasonal_var=0.0).G
    x = np.asarray([1.7, -0.3, 0.9, -2.3])
    effects = []
    for _ in range(3 * s):
        effects.append(x[0])
        x = G @ x
    effects = np.asarray(effects)
    for start in range(s, 2 * s):
        assert abs(effects[start:start + s].sum()) < 1e-9
    np.testing.assert_allclose(effects[s:2 * s], effects[2 * s:3 * s],
                               atol=1e-9)


def test_combine_validations():
    with pytest.raises(ValueError):
        structural.combine([], device="cpu")
    with pytest.raises(ValueError):
        structural.seasonal(1)


def test_structural_filter_matches_kalman():
    # tests/test_structural.py:60-98 at N = 4096: the final filtered mean
    # within 6 sd, the log-evidence within 1% of Kalman.
    model = structural.combine(
        [structural.local_linear_trend(level_var=0.02, slope_var=2e-3),
         structural.seasonal(4, seasonal_var=5e-3)], obs_var=0.25,
        device="cpu")
    _, ys = model.simulate(torch.Generator().manual_seed(5), 120)
    res = tpf.bootstrap_filter(6, model, ys, 4096, resampler="systematic",
                               return_history=False)
    mats = structural.combine_matrices(
        [structural.local_linear_trend(level_var=0.02, slope_var=2e-3),
         structural.seasonal(4, seasonal_var=5e-3)], obs_var=0.25)
    km, kc, kll = kalman_filter(ys, **mats)
    w = torch.softmax(res.final_log_weights.double(), 0).numpy()
    fmean = (w[:, None] * res.final_particles.double().numpy()).sum(0)
    sd = np.sqrt(kc[-1].diagonal())
    assert np.all(np.abs(fmean - km[-1]) < 6 * sd + 1e-3)
    assert abs(float(res.log_evidence) - kll) < 0.01 * abs(kll)


def test_structural_mvt_noise_runs():
    model = structural.combine([structural.local_level()], obs_var=0.1,
                               noise="mvt", df=5.0, device="cpu")
    _, ys = model.simulate(torch.Generator().manual_seed(1), 30)
    res = tpf.bootstrap_filter(0, model, ys, 1024, return_history=False)
    assert bool(torch.isfinite(res.log_evidence))


# -- CLGSSM -----------------------------------------------------------------

def test_clgssm_create_and_params_from_numpy():
    rng = np.random.default_rng(0)
    F = rng.standard_normal((2, 3)).astype(np.float32)
    jm = JCLGSSM.create(
        nl_dim=1, lin_dim=3, obs_dim=2,
        sample_initial_nl=None, propagate_nl=None,
        Fmat=lambda p, u: p["F"], Gmat=None, Vcov=None, Wcov=None,
        m0=np.zeros(3), C0=np.eye(3), params={"F": jnp.asarray(F)})
    params = params_from_numpy(jm.params, "cpu")
    tm = CLGSSM.create(
        nl_dim=1, lin_dim=3, obs_dim=2, sample_initial_nl=None,
        propagate_nl=None, Fmat=lambda p, u: p["F"], Gmat=None, Vcov=None,
        Wcov=None, m0=np.asarray(jm.m0), C0=np.asarray(jm.C0),
        params=params, device="cpu")
    np.testing.assert_array_equal(tm.Fmat(torch.zeros(1)).numpy(), F)
    np.testing.assert_array_equal(tm.m0.numpy(), np.asarray(jm.m0))
    np.testing.assert_array_equal(tm.C0.numpy(), np.asarray(jm.C0))
    u = torch.zeros(1)
    assert tm.b(u).shape == (3,) and tm.c(u).shape == (2,)
    assert not tm.mats_constant
    assert tm.replace(mats_constant=True).mats_constant


def test_vmap_broadcasts_constant_callables():
    # The bench config's matrices ignore u: vmap(out_dims=0) must broadcast
    # them over the particles, and a u-dependent offset must be mapped.
    F = torch.randn(2, 3)
    tm = CLGSSM.create(
        nl_dim=1, lin_dim=3, obs_dim=2, sample_initial_nl=None,
        propagate_nl=None, Fmat=lambda p, u: p["F"], Gmat=None, Vcov=None,
        Wcov=None, c=lambda p, u: torch.stack([torch.sin(u[0]),
                                               torch.cos(u[0])]),
        m0=np.zeros(3), C0=np.eye(3), params={"F": F}, device="cpu")
    u = torch.linspace(-1.0, 1.0, 7)[:, None]
    Fs, cs, bs = torch.func.vmap(lambda ui: (tm.Fmat(ui), tm.c(ui),
                                             tm.b(ui)), out_dims=0)(u)
    assert Fs.shape == (7, 2, 3) and torch.equal(Fs[3], F)
    torch.testing.assert_close(cs[:, 0], torch.sin(u[:, 0]))
    assert bs.shape == (7, 3) and not bs.any()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize("build", [
    lambda: StochasticVolatility.create(),
    lambda: UNGM.create(),
    lambda: structural.combine([structural.local_level()]),
    lambda: CLGSSM.create(1, 1, 1, None, None, None, None, None, None,
                          np.zeros(1), np.eye(1)),
    lambda: params_from_numpy({"a": np.zeros(1)})],
    ids=["sv", "ungm", "combine", "clgssm", "params"])
def test_models_on_device_none_need_the_card(build):
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert resolve_device("cpu").type == "cpu"
