"""PyTorch port, the SMC samplers and parameter inference: the tempered SMC
sampler (four move kernels), SMC^2 and PMMH, against ``cusmc_tpu``'s.

Parity on replayed draws: each function runs in both packages with JAX's
key schedule replayed into the port's ``draws=`` (and, for SMC^2, into
its theta-vectorised callables, which read JAX's normals in the order the
port calls them); particles, weights, log-evidence, stage counts and
rates at rtol 1e-5 (atol 1e-5). The runs are small (N <= 256, a few
stages or steps), so no accept decision or resampled ancestor sits at a
rounding tie; PMMH's accept decisions are read from its chain. PMMH's
filter runs replay the JAX filter's draws through ``bootstrap_filter``'s
``draws=`` (the packed composed path, systematic).

Oracles, at the JAX tests' thresholds: tests/test_smc_sampler.py's nine
cases at their sizes; tests/test_smc2.py against the grid posterior of
tests/test_liu_west.py (the posterior case at N_theta = 64, N_x = 96
against the JAX test's 96 and 192: the inner categorical draws N_x^2
Gumbels a theta a step on the CPU), its evidence path and its
rejuvenation trigger; tests/test_models_smoothing_pmmh.py's observation
variance recovery at its size (N = 256, 150 steps).
"""

import _torch_threads  # noqa: F401
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import F32, fold_split, gumbel_draws, packed_noise, \
    registry_draws, to_torch

from cusmc_tpu.distributions import mvn_logpdf_cov as jmvn_cov
from cusmc_tpu.distributions import mvn_sample_cov as jmvn_sample
from cusmc_tpu.mcmc.pmmh import pmmh as jpmmh
from cusmc_tpu.models.dlm import DLM as JDLM
from cusmc_tpu.resampling.classic import POSITION_FNS as JAX_POSITION_FNS
from cusmc_tpu.smc.smc2 import smc2 as jsmc2
from cusmc_tpu.smc.smc_sampler import smc_sampler as jsmc_sampler
from cusmc_tpu_torch.distributions import mvn_logpdf_cov, mvn_sample_cov
from cusmc_tpu_torch.mcmc import pmmh
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.smc import smc2
from cusmc_tpu_torch.smc.kalman import kalman_filter
from cusmc_tpu_torch.smc.smc_sampler import smc_sampler

MU = [2.0, -1.0, 0.5]


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def shifted_gaussian(d=3, rho=None, port=True):
    """tests/test_smc_sampler.py:13-33's problem: prior N(0, 4 I), target
    N(mu, I) (or the rho-correlated covariance of its HMC case)."""
    mu = np.asarray(MU, np.float32)[:d]
    tcov = (np.eye(d) if rho is None else np.eye(d) * (1 - rho) + rho
            ).astype(np.float32)
    pcov = (4.0 * np.eye(d)).astype(np.float32)
    zero = np.zeros(d, np.float32)
    if not port:
        return (lambda x: jmvn_cov(x, jnp.asarray(zero), jnp.asarray(pcov)),
                lambda x: jmvn_cov(x, jnp.asarray(mu), jnp.asarray(tcov)),
                lambda k, s: jmvn_sample(k, jnp.asarray(zero),
                                         jnp.asarray(pcov), s))
    z, p, m, c = (torch.from_numpy(a) for a in (zero, pcov, mu, tcov))
    return (lambda x: mvn_logpdf_cov(x, z, p),
            lambda x: mvn_logpdf_cov(x, m, c),
            lambda g, s: mvn_sample_cov(g, z, p, s))


def _weighted_mean(res):
    w = torch.exp(res.log_weights.double())
    return (w[:, None] * res.particles.double()).sum(0).numpy()


# -- the tempered SMC sampler ------------------------------------------------

def _move_draws(kernel, key, c, d):
    """One move's draws of ``mh_step``/``mala_step`` (``kz, ku``) or
    ``hmc_step`` (``kp, kl, ku``, 5 leapfrog steps)."""
    if kernel == "hmc":
        kp, kl, ku = jax.random.split(key, 3)
        return (to_torch(jax.random.normal(kp, (c, d), F32)),
                int(jax.random.randint(kl, (), 1, 6)),
                to_torch(jax.random.uniform(ku, (c,), F32)))
    kz, ku = jax.random.split(key)
    return (to_torch(jax.random.normal(kz, (c, d), F32)),
            to_torch(jax.random.uniform(ku, (c,), F32)))


def sampler_draws(key, stages, kernel, n, d, waste_free, k_moves, x0):
    """``k_init, k_loop = split(key)``; per stage ``k_res, k_mh =
    split(fold_in(k_loop, stage))``, move j on ``fold_in(k_mh, j)``."""
    _, k_loop = jax.random.split(key)
    out = []
    roots = n // k_moves
    for stage in range(stages):
        k_res, k_mh = fold_split(k_loop, stage)
        if waste_free:
            res = gumbel_draws(k_res, (roots, n))
            c, moves = roots, k_moves - 1
        else:
            res = registry_draws("systematic", k_res, n)
            c, moves = n, k_moves
        out.append((res, [_move_draws(kernel, jax.random.fold_in(k_mh, j),
                                      c, d) for j in range(moves)]))
    return {"x0": x0, "stages": out}


SAMPLER_CASES = {"rwm": {}, "mala": dict(step_size=0.3),
                 "hmc": dict(step_size=0.25), "waste-free":
                 dict(waste_free=True, rejuvenation_steps=4, step_size=0.3)}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_smc_sampler_matches_jax(case):
    n, d = 256, 3
    kw = dict(SAMPLER_CASES[case])
    kernel = "rwm" if case == "waste-free" else case
    key = jax.random.key(41)
    jfns = shifted_gaussian(d, rho=0.9 if case == "hmc" else None,
                            port=False)
    ref = jsmc_sampler(key, *jfns, n, d, rejuvenation=kernel, **kw)
    k_init, _ = jax.random.split(key)
    x0 = to_torch(jfns[2](k_init, (n,)))
    draws = sampler_draws(key, int(ref.num_stages), kernel, n, d,
                          kw.get("waste_free", False),
                          kw.get("rejuvenation_steps", 5), x0)
    fns = shifted_gaussian(d, rho=0.9 if case == "hmc" else None)
    ours = smc_sampler(None, *fns, n, d, rejuvenation=kernel, device="cpu",
                       draws=draws, **kw)
    assert ours.num_stages == int(ref.num_stages) >= 2
    for f in ("particles", "log_weights", "log_evidence", "accept_rate"):
        _close(getattr(ours, f).numpy(), getattr(ref, f))


def test_smc_sampler_refusals():
    fns = shifted_gaussian(2)
    with pytest.raises(ValueError):
        smc_sampler(0, *fns, 64, 2, rejuvenation="nuts", device="cpu")
    # tests/test_smc_sampler.py::test_waste_free_divisibility
    with pytest.raises(ValueError, match="divisible"):
        smc_sampler(0, *fns, 100, 2, waste_free=True, rejuvenation_steps=7,
                    device="cpu")


@pytest.mark.parametrize("kernel", ["rwm", "mala"])
def test_smc_sampler_shifted_gaussian(kernel):
    # tests/test_smc_sampler.py::test_shifted_gaussian_target and
    # ::test_mala_rejuvenation.
    res = smc_sampler(0, *shifted_gaussian(), 4096, 3, rejuvenation=kernel,
                      step_size=0.3 if kernel == "mala" else 0.5,
                      device="cpu")
    assert res.num_stages >= 2
    np.testing.assert_allclose(_weighted_mean(res), MU, atol=0.12)
    assert abs(float(res.log_evidence)) < 0.12


def test_smc_sampler_hmc_on_a_correlated_target():
    res = smc_sampler(1, *shifted_gaussian(rho=0.9), 4096, 3,
                      rejuvenation="hmc", step_size=0.25, device="cpu")
    np.testing.assert_allclose(_weighted_mean(res), MU, atol=0.15)
    assert abs(float(res.log_evidence)) < 0.15
    assert float(res.accept_rate) > 0.5


@pytest.mark.parametrize("kernel", ["rwm", "mala", "hmc"])
def test_smc_sampler_waste_free(kernel):
    # The band is about two standard deviations of the weighted mean at
    # this size, in both packages (JAX's keys 0-3 spread its first
    # coordinate over 1.86-2.01, the port's seeds 0-5 over 1.80-2.09).
    res = smc_sampler(0, *shifted_gaussian(), 4096, 3, rejuvenation=kernel,
                      waste_free=True, rejuvenation_steps=8, step_size=0.3,
                      device="cpu")
    assert res.particles.shape == (4096, 3)
    np.testing.assert_allclose(_weighted_mean(res), MU, atol=0.15)
    assert abs(float(res.log_evidence)) < 0.15


def test_smc_sampler_evidence_stages_and_resamplers():
    d = 2
    eye, zero = torch.eye(d), torch.zeros(d)
    lp = lambda x: mvn_logpdf_cov(x, zero, eye)
    ps = lambda g, s: torch.randn(s + (d,), generator=g)
    # An unnormalised target, c N(0, I) with log c = 3: one stage.
    res = smc_sampler(3, lp, lambda x: 3.0 + lp(x), ps, 2048, d,
                      device="cpu")
    np.testing.assert_allclose(float(res.log_evidence), 3.0, atol=0.05)
    assert res.num_stages == 1
    # A hard anneal, N(0, 100 I) -> N(5, 0.01 I).
    mu = torch.full((d,), 5.0)
    res = smc_sampler(
        4, lambda x: mvn_logpdf_cov(x, zero, 100.0 * eye),
        lambda x: mvn_logpdf_cov(x, mu, 0.01 * eye),
        lambda g, s: mvn_sample_cov(g, zero, 100.0 * eye, s), 4096, d,
        rejuvenation_steps=10, step_size=0.1, device="cpu")
    assert res.num_stages > 3
    np.testing.assert_allclose(_weighted_mean(res), mu.numpy(), atol=0.1)
    assert abs(float(res.log_evidence)) < 0.5
    for name in ("systematic", "metropolis", "multinomial"):
        res = smc_sampler(5, lambda x: mvn_logpdf_cov(x, zero, 4.0 * eye),
                          lambda x: mvn_logpdf_cov(x, torch.ones(d), eye),
                          lambda g, s: 2.0 * torch.randn(s + (d,),
                                                         generator=g),
                          1024, d, resampler=name, device="cpu")
        assert math.isfinite(float(res.log_evidence))


# -- SMC^2 -------------------------------------------------------------------

G_TRUE, W_VAR, V_VAR = 0.8, 0.3, 0.5


def smc2_data(steps=200, seed=3):
    """tests/test_liu_west.py:23-30's AR(1) data."""
    rng = np.random.default_rng(seed)
    x, ys = 0.0, np.zeros((steps, 1), np.float32)
    for t in range(1, steps):
        x = G_TRUE * x + rng.normal(0, np.sqrt(W_VAR))
        ys[t, 0] = x + rng.normal(0, np.sqrt(V_VAR))
    return ys


def grid_posterior_mean(ys):
    """tests/test_liu_west.py:60-74: the exact posterior mean and sd of
    g from the Kalman likelihood on a grid times the prior."""
    gs = np.linspace(0.3, 1.1, 161)
    logp = np.array([float(kalman_filter(
        np.asarray(ys, np.float64), np.eye(1), [[g]], [[V_VAR]], [[W_VAR]],
        np.zeros(1), np.eye(1))[2]) - 0.5 * ((g - 0.5) / 0.2) ** 2
        for g in gs])
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = float((w * gs).sum())
    return mean, float(np.sqrt((w * gs ** 2).sum() - mean ** 2))


def smc2_fns(port, replay=None):
    """tests/test_smc2.py:15-38's model: one theta's callables (JAX), or
    the port's theta-vectorised ones; ``replay`` holds iterators of JAX's
    normals for the port's draws."""
    sw = np.sqrt(W_VAR).astype(np.float32)
    if not port:
        def sample_initial(key, n, theta):
            return jax.random.normal(key, (n, 1), jnp.float32)

        def propagate(key, x, theta):
            return theta[0] * x + sw * jax.random.normal(key, x.shape,
                                                         jnp.float32)

        def observation_logpdf(y, x, theta):
            r = y[0] - x[:, 0]
            return (-0.5 * r * r / V_VAR
                    - 0.5 * np.log(2.0 * np.pi * V_VAR)).astype(jnp.float32)

        def theta_prior_sample(key, n):
            return 0.5 + 0.2 * jax.random.normal(key, (n, 1), jnp.float32)

        def theta_prior_logpdf(theta):
            return -0.5 * ((theta[:, 0] - 0.5) / 0.2) ** 2
    else:
        def z(gen, shape, which):
            if replay is not None:
                return next(replay[which])
            return torch.randn(shape, generator=gen, device=gen.device)

        def sample_initial(gen, n, theta):
            return z(gen, (theta.shape[0], n, 1), "x0")

        def propagate(gen, x, theta):
            return theta[:, None, :1] * x + float(sw) * z(gen, x.shape,
                                                          "prop")

        def observation_logpdf(y, x, theta):
            r = y[0] - x[..., 0]
            return (-0.5 * r * r / V_VAR
                    - 0.5 * float(np.log(2.0 * np.pi * V_VAR)))

        def theta_prior_sample(gen, n):
            return 0.5 + 0.2 * z(gen, (n, 1), "theta")

        def theta_prior_logpdf(theta):
            return -0.5 * ((theta[:, 0] - 0.5) / 0.2) ** 2
    return (sample_initial, propagate, observation_logpdf,
            theta_prior_sample, theta_prior_logpdf)


def _inner_draws(keys, nx):
    """The inner steps of the filters keyed ``keys`` (one a theta): each
    splits ``k_res, k_prop``; the Gumbels [nt, nx, nx] of its categorical
    and the normals [nt, nx, 1] of its propagation."""
    g, z = [], []
    for k in keys:
        k_res, k_prop = jax.random.split(k)
        g.append(gumbel_draws(k_res, (nx, nx)))
        z.append(to_torch(jax.random.normal(k_prop, (nx, 1), F32)))
    return torch.stack(g), torch.stack(z)


def smc2_replay(key, ys, nt, nx, rejuvenated):
    """The port's draws and its callables' normals (in the port's call
    order) for JAX's ``smc2(key, ...)``: ``rejuvenated`` lists the steps
    whose theta ESS fell below the threshold."""
    k_th, k_init, k_scan = jax.random.split(key, 3)
    theta = [to_torch(jax.random.normal(k_th, (nt, 1), F32))]
    x0s = [torch.stack([to_torch(jax.random.normal(k, (nx, 1), F32))
                        for k in jax.random.split(k_init, nt)])]
    props, steps = [], []
    for t in range(1, ys.shape[0]):
        k_inner, k_res, k_prop, k_acc, k_rerun = jax.random.split(
            jax.random.fold_in(k_scan, t), 5)
        g, z = _inner_draws(jax.random.split(k_inner, nt), nx)
        props.append(z)
        step = {"inner": g}
        if t in rejuvenated:
            ks = jax.random.split(k_rerun, nt)
            x0s.append(torch.stack([to_torch(jax.random.normal(
                jax.random.fold_in(k, 0), (nx, 1), F32)) for k in ks]))
            rerun = []
            for s in range(1, t + 1):
                g_s, z_s = _inner_draws([jax.random.fold_in(k, s)
                                         for k in ks], nx)
                rerun.append(g_s)
                props.append(z_s)
            step.update(res=registry_draws("systematic", k_res, nt),
                        z=to_torch(jax.random.normal(k_prop, (nt, 1), F32)),
                        rerun=rerun,
                        u=to_torch(jax.random.uniform(k_acc, (nt,), F32)))
        steps.append(step)
    replay = {"theta": iter(theta), "x0": iter(x0s), "prop": iter(props)}
    return {"steps": steps}, replay


def test_smc2_matches_jax():
    nt, nx, steps = 8, 16, 12
    ys = smc2_data()[:steps]
    key = jax.random.key(42)
    ref = jsmc2(key, *smc2_fns(False), jnp.asarray(ys), nt, nx,
                ess_threshold=0.9)
    ess = np.asarray(ref.ess_path)
    rejuvenated = [t for t in range(1, steps) if ess[t] < 0.9 * nt]
    assert int(ref.num_rejuvenations) == len(rejuvenated) >= 2
    draws, replay = smc2_replay(key, ys, nt, nx, rejuvenated)
    ours = smc2(None, *smc2_fns(True, replay), ys, nt, nx,
                ess_threshold=0.9, device="cpu", draws=draws)
    assert ours.num_rejuvenations == len(rejuvenated)
    for f in ("thetas", "log_weights", "log_evidence", "log_evidence_path",
              "ess_path", "accept_rate"):
        _close(getattr(ours, f).numpy(), getattr(ref, f))


@pytest.fixture(scope="module")
def smc2_ys():
    return smc2_data()[:150]


def test_smc2_posterior_matches_grid_oracle(smc2_ys):
    res = smc2(0, *smc2_fns(True), smc2_ys, 64, 96, device="cpu")
    mean0, sd0 = grid_posterior_mean(smc2_ys)
    w = torch.softmax(res.log_weights.double(), 0).numpy()
    mean = float(w @ res.thetas.double().numpy()[:, 0])
    assert abs(mean - mean0) < 3.0 * sd0 + 0.03, (mean, mean0, sd0)
    assert res.num_rejuvenations >= 1
    assert 0.0 <= float(res.accept_rate) <= 1.0
    assert math.isfinite(float(res.log_evidence))


def test_smc2_evidence_path_and_trigger(smc2_ys):
    res = smc2(1, *smc2_fns(True), smc2_ys, 48, 96, device="cpu")
    path = res.log_evidence_path.numpy()
    assert path.shape == (150,) and path[0] == 0.0
    assert path[-1] == pytest.approx(float(res.log_evidence))
    assert np.isfinite(path).all()
    hi = smc2(2, *smc2_fns(True), smc2_ys[:60], 24, 48, ess_threshold=0.95,
              device="cpu")
    lo = smc2(2, *smc2_fns(True), smc2_ys[:60], 24, 48, ess_threshold=0.05,
              device="cpu")
    assert hi.num_rejuvenations > lo.num_rejuvenations


# -- PMMH --------------------------------------------------------------------

def pmmh_problem(steps=101, seed=11):
    """tests/test_models_smoothing_pmmh.py:118-140's 1-d DLM (G = 0.9, W =
    0.01, V = 0.04), its data drawn here with numpy."""
    rng = np.random.default_rng(seed)
    x, ys = rng.normal(), np.zeros((steps, 1), np.float32)
    for t in range(1, steps):
        x = 0.9 * x + rng.normal(0, 0.1)
        ys[t, 0] = x + rng.normal(0, 0.2)
    return ys


def pmmh_builder(port, device="cpu"):
    i1 = np.eye(1)
    if not port:
        return lambda th: JDLM.create(F=i1, G=0.9 * i1, m0=np.zeros(1),
                                      C0=i1, V=jnp.exp(th[0]) * jnp.eye(1),
                                      W=0.01 * i1, dtype=jnp.float32)
    f, g, m0, c0, w = (torch.tensor(a, dtype=torch.float32, device=device)
                       for a in (i1, 0.9 * i1, np.zeros(1), i1, 0.01 * i1))
    eye = torch.eye(1, device=device)
    return lambda th: DLM.create(F=f, G=g, m0=m0, C0=c0,
                                 V=torch.exp(th[0]) * eye, W=w,
                                 device=th.device)


def filter_draws(key, jm, n, steps):
    """``bootstrap_filter(key)``'s draws on the packed systematic path:
    the initial cloud, then per step the positions and the noise."""
    k_init, k_scan = jax.random.split(key)
    out = []
    for t in range(1, steps):
        k_res, k_prop = fold_split(k_scan, t)
        out.append((to_torch(JAX_POSITION_FNS["systematic"](k_res, n, F32)),
                    packed_noise(k_prop, jm, n)))
    return {"x0": to_torch(jm.sample_initial_packed(k_init, n)),
            "steps": out}


def test_pmmh_matches_jax():
    n, steps, T = 64, 8, 21
    ys = pmmh_problem(T)
    key = jax.random.key(43)
    jprior = lambda th: -0.5 * jnp.sum(th ** 2) / 9.0
    ref = jpmmh(key, pmmh_builder(False), jprior,
                jnp.asarray([0.0], F32), jnp.asarray(ys), n, steps,
                step_size=0.4)
    jm = pmmh_builder(False)(jnp.zeros(1, F32))  # the draws' shapes
    k_init, k_chain = jax.random.split(key)
    draws = {"init": filter_draws(k_init, jm, n, T), "steps": []}
    for t in range(steps):
        kp, kf, ku = fold_split(k_chain, t, 3)
        draws["steps"].append((to_torch(jax.random.normal(kp, (1,), F32)),
                               filter_draws(kf, jm, n, T),
                               to_torch(jax.random.uniform(ku, (), F32))))
    ours = pmmh(None, pmmh_builder(True),
                lambda th: -0.5 * torch.sum(th ** 2) / 9.0,
                torch.zeros(1), ys, n, steps, step_size=0.4, draws=draws)
    np.testing.assert_array_equal(
        np.diff(ours.thetas.numpy()[:, 0]) != 0,
        np.diff(np.asarray(ref.thetas)[:, 0]) != 0)
    for f in ("thetas", "log_evidences", "accept_rate", "final_theta"):
        _close(getattr(ours, f).numpy(), getattr(ref, f))
    assert 0.0 < float(ours.accept_rate) < 1.0


def test_pmmh_recovers_observation_scale():
    ys = pmmh_problem()
    res = pmmh(0, pmmh_builder(True), lambda th: -0.5 * torch.sum(th ** 2)
               / 9.0, torch.zeros(1), ys, 256, 150, step_size=0.4)
    assert 0.02 < float(res.accept_rate) < 0.9
    post = np.exp(res.thetas.numpy()[75:, 0])
    assert 0.3 * 0.04 < np.median(post) < 3.0 * 0.04, np.median(post)


def test_dlm_create_keeps_a_chain_tensor_in_pmmh(monkeypatch):
    # The builder's theta reaches DLM.create as a tensor and never
    # numpy, and the chain reads nothing back to the host.
    calls = []
    orig = np.asarray

    def spy(a, *args, **kw):
        if isinstance(a, torch.Tensor):
            calls.append(tuple(a.shape))
        return orig(a, *args, **kw)
    monkeypatch.setattr(np, "asarray", spy)
    reads = []
    for name in ("item", "__bool__", "__float__", "__int__", "tolist",
                 "numpy"):
        fn = getattr(torch.Tensor, name)

        def rspy(self, *a, _fn=fn, _name=name, **k):
            reads.append(_name)
            return _fn(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, rspy)
    ys = torch.from_numpy(pmmh_problem(11))
    pmmh(0, pmmh_builder(True), lambda th: -0.5 * torch.sum(th ** 2),
         torch.zeros(1), ys, 32, 4, step_size=0.4)
    monkeypatch.undo()
    assert calls == [] and reads == []
