"""PyTorch port, the auxiliary filters: the APF, conditional SMC and
particle Gibbs, Liu-West, the RBPF (both banks) and the EnKF, against
``cusmc_tpu``'s.

Exact parity on replayed draws (T <= 5, N <= 128): each filter is run in
both packages with JAX's key schedule replayed into the port's ``draws=``
(and into the user callables of Liu-West and the RBPF); states,
log-weights, ESS, means and log-evidence at rtol 1e-5 (atol 1e-6; the
EnKF's [k, k] solve at atol 1e-5), ancestors and traced indices exactly,
but at a shown cdf tie (the two packages sum the cdf in different float32
orders).

Oracles, the JAX tests' thresholds at N <= 4096: the APF against Kalman
(tests/test_apf.py), particle Gibbs against the RTS smoother
(tests/test_csmc.py; 30 sweeps against 120, so its bands widen by
sqrt(80 / 20) = 2), the RBPF reduced to Kalman and against a joint-state
bootstrap filter (tests/test_rbpf.py), the EnKF against Kalman
(tests/test_enkf.py), Liu-West against a Kalman grid (tests/test_liu_west
.py). Refusals; ``device=None`` needs the card; and no filter reads back
to the host but the RBPF's ESS decision, once a step.
"""

import _torch_threads  # noqa: F401
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import F32, assert_ancestors_or_ties, batch_noise, \
    fold_split, gumbel_draws, jax_model, model_noise, normal_noise, \
    port_model, registry_draws, to_torch

from cusmc_tpu.models.clgssm import CLGSSM as JCLGSSM
from cusmc_tpu.models.stochvol import StochasticVolatility as JSV
from cusmc_tpu.smc.apf import auxiliary_filter as japf
from cusmc_tpu.smc.csmc import conditional_smc as jcsmc
from cusmc_tpu.smc.csmc import particle_gibbs as jpg
from cusmc_tpu.smc.enkf import ensemble_kalman_filter as jenkf
from cusmc_tpu.smc.liu_west import liu_west_filter as jlw
from cusmc_tpu.smc.rbpf import rao_blackwell_filter as jrbpf
from cusmc_tpu_torch.io.data import demo_model_params
from cusmc_tpu_torch.models.base import CustomSSM
from cusmc_tpu_torch.models.clgssm import CLGSSM
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.smc import rbpf as trbpf
from cusmc_tpu_torch.smc.apf import auxiliary_filter
from cusmc_tpu_torch.smc.csmc import conditional_smc, particle_gibbs
from cusmc_tpu_torch.smc.enkf import ensemble_kalman_filter
from cusmc_tpu_torch.smc.kalman import kalman_filter, rts_smoother
from cusmc_tpu_torch.smc.liu_west import liu_west_filter
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter
from cusmc_tpu_torch.smc.rbpf import rao_blackwell_filter

N, T = 128, 5
ORACLE_KEYS = ("F", "G", "V", "W", "m0", "C0")


def _close(ours, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _trace(jm, steps=T, seed=9):
    _, ys = jm.simulate(jax.random.key(seed), steps)
    return np.asarray(ys, np.float32)


def _step_draws(key, jm, n, steps, resampler, shape):
    """Per step t: (registry draws of k_res, model noise of k_prop) with
    ``k_res, k_prop = split(fold_in(key, t))``."""
    out = []
    for t in range(1, steps):
        k_res, k_prop = fold_split(key, t)
        out.append((registry_draws(resampler, k_res, n),
                    model_noise(k_prop, jm, shape)))
    return out


def _history_parity(ours, ref, logws, draws, name, fields):
    """Ancestors equal or shown ties at each step (``logws[t-1]`` the
    weights they were drawn from), the fields equal at rtol 1e-5 on the
    slots descended from no tie."""
    n = ours.ancestors.shape[1]
    clean = np.ones(n, bool)
    for t in range(1, ours.ancestors.shape[0]):
        a, ra = ours.ancestors[t].numpy(), np.asarray(ref.ancestors[t])
        assert_ancestors_or_ties(a, ra, logws[t - 1], draws[t - 1][0], name)
        clean = clean[a] & (a == ra)
        for f in fields:
            _close(getattr(ours, f)[t].numpy()[clean],
                   np.asarray(getattr(ref, f)[t])[clean])
    return clean.all()


# -- APF ------------------------------------------------------------------

@pytest.mark.parametrize("model", ["dlm", "sv"])
def test_apf_matches_jax(model):
    jm = jax_model("mvn") if model == "dlm" else JSV.create()
    tm = port_model(jm)
    ys = _trace(jm)
    d = 2 if model == "dlm" else 1
    key = jax.random.key(21)
    ref = japf(key, jm, jnp.asarray(ys), N)
    k_init, k_scan = jax.random.split(key)
    draws = {"init": model_noise(k_init, jm, (N, d)),
             "steps": _step_draws(k_scan, jm, N, T, "systematic", (N, d))}
    out = auxiliary_filter(0, tm, ys, N, draws=draws)
    # The first-stage weights the ancestors were drawn from.
    logws, logw = [], torch.full((N,), -np.log(N))
    for t in range(1, T):
        look = (tm.lookahead_logpdf(torch.from_numpy(ys[t]),
                                    out.particles[t - 1])
                if model == "dlm" else tm.observation_logpdf(
                    torch.from_numpy(ys[t]),
                    tm.propagate_mean(out.particles[t - 1])))
        logws.append((logw + look).numpy())
        logw = torch.log_softmax(out.obs_loglik[t], 0)
    if _history_parity(out, ref, logws, draws["steps"], "systematic",
                       ("particles", "obs_loglik")):
        for f in ("ess", "log_evidence", "final_log_weights",
                  "final_particles"):
            _close(getattr(out, f).numpy(), getattr(ref, f))


@pytest.fixture(scope="module")
def informative():
    # tests/test_apf.py:17-29: V < W, where the lookahead pays.
    params = demo_model_params()
    params["V"] = 0.002 * np.eye(2)
    params["W"] = 0.01 * np.eye(2)
    model = DLM.create(noise="mvn", device="cpu", **params)
    _, ys = model.simulate(torch.Generator().manual_seed(9), 101)
    return params, model, ys


def test_apf_matches_kalman(informative):
    params, model, ys = informative
    res = auxiliary_filter(1, model, ys, 4096)
    _, _, kll = kalman_filter(ys, **{k: params[k] for k in ORACLE_KEYS})
    assert abs(float(res.log_evidence) - kll) < 0.05 * abs(kll)
    assert res.particles.shape == (101, 4096, 2)


def test_apf_requires_propagate_mean():
    model = CustomSSM.create(
        1, lambda p, g, s: torch.randn(s + (1,), generator=g),
        lambda p, g, x: x, lambda p, y, x: torch.zeros(x.shape[:-1]))
    with pytest.raises(ValueError, match="propagate_mean"):
        auxiliary_filter(0, model, torch.zeros(5, 1), 16, device="cpu")


# -- conditional SMC and particle Gibbs ------------------------------------

def _csmc_draws(key, jm, n, steps):
    k_init, k_scan, k_trace = jax.random.split(key, 3)
    return {"init": batch_noise(k_init, jm, (n, jm.state_dim)),
            "steps": _step_draws(k_scan, jm, n, steps, "multinomial",
                                 (n, jm.state_dim)),
            "trace": gumbel_draws(k_trace, (n,))}


def test_conditional_smc_matches_jax():
    jm = jax_model("mvn")
    tm = port_model(jm)
    ys = _trace(jm)
    ref_path = 0.5 * np.asarray(jm.simulate(jax.random.key(3), T)[0],
                                np.float32)
    key = jax.random.key(22)
    ref = jcsmc(key, jm, jnp.asarray(ys), jnp.asarray(ref_path), N)
    draws = _csmc_draws(key, jm, N, T)
    out = conditional_smc(0, tm, ys, ref_path, N, draws=draws)
    logws = [np.asarray(torch.log_softmax(out.obs_loglik[t - 1], 0))
             if t > 1 else np.full(N, -np.log(N)) for t in range(1, T)]
    assert _history_parity(out, ref, logws, draws["steps"], "multinomial",
                           ("particles", "obs_loglik"))
    np.testing.assert_array_equal(out.particles[:, 0].numpy(), ref_path)
    assert (out.ancestors[:, 0] == 0).all()
    for f in ("ess", "log_evidence", "sampled_path"):
        _close(getattr(out, f).numpy(), getattr(ref, f))


def test_particle_gibbs_matches_jax():
    jm = jax_model("mvn")
    tm = port_model(jm)
    ys = _trace(jm, steps=4)
    key = jax.random.key(23)
    ref = jpg(key, jm, jnp.asarray(ys), 64, 2)
    k_init, kk = jax.random.split(key)
    draws = (_csmc_draws(k_init, jm, 64, 4),
             [_csmc_draws(jax.random.fold_in(kk, i), jm, 64, 4)
              for i in range(2)])
    out = particle_gibbs(0, tm, ys, 64, 2, draws=draws)
    assert out.shape == (2, 4, 2)
    _close(out.numpy(), ref)


@pytest.fixture(scope="module")
def pg_setup():
    params = demo_model_params()
    model = DLM.create(noise="mvn", device="cpu", **params)
    _, ys = model.simulate(torch.Generator().manual_seed(13), 61)
    return params, model, ys


def test_particle_gibbs_matches_rts(pg_setup):
    # tests/test_csmc.py:38-51 with 30 sweeps (burn-in 10): 20 kept paths
    # against 80, so the bands widen by sqrt(80 / 20) = 2.
    params, model, ys = pg_setup
    paths = particle_gibbs(1, model, ys, 512, 30).numpy()[10:]
    sm, sc = rts_smoother(ys, **{k: params[k] for k in ORACLE_KEYS})
    sd = np.sqrt(sc.diagonal(axis1=1, axis2=2))
    err = np.abs(paths.mean(axis=0)[5:] - sm[5:])
    widen = np.sqrt(80 / 20)
    assert (err < 5.0 * widen * sd[5:]).mean() > 0.99
    assert np.median(err / sd[5:]) < 0.7 * widen


def test_particle_gibbs_paths_mix(pg_setup):
    _, model, ys = pg_setup
    paths = particle_gibbs(2, model, ys, 256, 10).numpy()
    assert paths.shape == (10, 61, 2)
    assert (np.abs(np.diff(paths, axis=0)).max(axis=(1, 2)) > 0).all()


# -- Liu-West ----------------------------------------------------------------

G_TRUE, W_VAR, V_VAR = 0.8, 0.3, 0.5


def _lw_fns(port, replay=None):
    """tests/test_liu_west.py:34-60's model; ``replay`` (port side) holds
    iterators of JAX's normals for the callables' draws."""
    sw = float(np.sqrt(np.float32(W_VAR)))
    if not port:
        def sample_initial(key, n, theta):
            return jax.random.normal(key, (n, 1), jnp.float32)

        def propagate(key, x, theta):
            return theta[:, :1] * x + np.float32(sw) * jax.random.normal(
                key, x.shape, jnp.float32)

        def propagate_mean(x, theta):
            return theta[:, :1] * x

        def observation_logpdf(y, x, theta):
            r = y[0] - x[:, 0]
            return (-0.5 * r * r / V_VAR
                    - 0.5 * np.log(2.0 * np.pi * V_VAR)).astype(jnp.float32)

        def theta_prior_sample(key, n):
            return 0.5 + 0.2 * jax.random.normal(key, (n, 1), jnp.float32)
    else:
        def z(gen, shape, which):
            if replay is not None:
                return next(replay[which])
            return torch.randn(shape, generator=gen)

        def sample_initial(gen, n, theta):
            return z(gen, (n, 1), "x0")

        def propagate(gen, x, theta):
            return theta[:, :1] * x + sw * z(gen, x.shape, "prop")

        def propagate_mean(x, theta):
            return theta[:, :1] * x

        def observation_logpdf(y, x, theta):
            r = y[0] - x[:, 0]
            return (-0.5 * r * r / V_VAR
                    - 0.5 * float(np.log(2.0 * np.pi * V_VAR)))

        def theta_prior_sample(gen, n):
            return 0.5 + 0.2 * z(gen, (n, 1), "theta")
    return (sample_initial, propagate, propagate_mean, observation_logpdf,
            theta_prior_sample)


def _lw_data(steps, seed=3):
    rng = np.random.default_rng(seed)
    x, ys = 0.0, np.zeros((steps, 1), np.float32)
    for t in range(1, steps):
        x = G_TRUE * x + rng.normal(0, np.sqrt(W_VAR))
        ys[t, 0] = x + rng.normal(0, np.sqrt(V_VAR))
    return ys


def test_liu_west_matches_jax():
    ys = _lw_data(T)
    key = jax.random.key(24)
    ref = jlw(key, *_lw_fns(False), jnp.asarray(ys), N, return_history=True)
    k_th, k_x, k_scan = jax.random.split(key, 3)
    steps, props = [], []
    for t in range(1, T):
        k_res, k_theta, k_prop = fold_split(k_scan, t, 3)
        steps.append((registry_draws("systematic", k_res, N),
                      normal_noise(k_theta, (N, 1))[0]))
        props.append(normal_noise(k_prop, (N, 1))[0])
    replay = {"theta": iter([normal_noise(k_th, (N, 1))[0]]),
              "x0": iter([normal_noise(k_x, (N, 1))[0]]),
              "prop": iter(props)}
    out = liu_west_filter(0, *_lw_fns(True, replay), ys, N,
                          return_history=True, device="cpu",
                          draws={"steps": steps})
    for f in ("thetas", "xs", "ess", "log_evidence", "theta_mean",
              "filtered_mean", "final_log_weights"):
        _close(getattr(out, f).numpy(), getattr(ref, f))


def test_liu_west_matches_grid_oracle():
    # tests/test_liu_west.py:63-100 at N = 4096.
    ys = _lw_data(300)
    res = liu_west_filter(1, *_lw_fns(True), ys, 4096, device="cpu")
    gs = np.linspace(0.3, 1.1, 161)
    logp = np.array([kalman_filter(ys, np.eye(1), [[g]], [[V_VAR]],
                                   [[W_VAR]], np.zeros(1), np.eye(1))[2]
                     - 0.5 * ((g - 0.5) / 0.2) ** 2 for g in gs])
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = float((w * gs).sum())
    sd = float(np.sqrt((w * gs ** 2).sum() - mean ** 2))
    assert abs(float(res.theta_mean[-1, 0]) - mean) < 3.0 * sd + 0.02
    tm = res.theta_mean[:, 0].numpy()
    assert abs(tm[0] - 0.5) < 0.02
    assert abs(tm[-1] - G_TRUE) < abs(tm[0] - G_TRUE)
    assert np.isfinite(float(res.log_evidence))


def test_liu_west_delta_validation():
    with pytest.raises(ValueError):
        liu_west_filter(0, *_lw_fns(True), torch.zeros(5, 1), 64,
                        delta=0.4, device="cpu")


# -- RBPF ------------------------------------------------------------------

D, K = 3, 2
RNG = np.random.default_rng(0)
G_NP = (0.9 * np.eye(D) + 0.05 * RNG.standard_normal((D, D))).astype(
    np.float32)
F_NP = RNG.standard_normal((K, D)).astype(np.float32)
W_NP = (0.3 * np.eye(D)).astype(np.float32)
V_NP = (0.5 * np.eye(K)).astype(np.float32)
M0, C0 = np.zeros(D, np.float32), np.eye(D, dtype=np.float32)
MATS = {"F": F_NP, "G": G_NP, "V": V_NP, "W": W_NP}


def _jax_offset_model(mats_constant):
    return JCLGSSM.create(
        nl_dim=1, lin_dim=D, obs_dim=K,
        sample_initial_nl=lambda p, key, n:
            0.1 * jax.random.normal(key, (n, 1), jnp.float32),
        propagate_nl=lambda p, key, u:
            u + 0.15 * jax.random.normal(key, u.shape, u.dtype),
        Fmat=lambda p, u: jnp.asarray(F_NP),
        Gmat=lambda p, u: jnp.asarray(G_NP),
        Vcov=lambda p, u: jnp.asarray(V_NP),
        Wcov=lambda p, u: jnp.asarray(W_NP),
        c=lambda p, u: jnp.stack([jnp.sin(u[0]), jnp.cos(u[0])]),
        m0=M0, C0=C0, mats_constant=mats_constant)


def _offset_model(mats_constant, replay=None, degenerate=False):
    """tests/test_rbpf.py:42-56 (``degenerate``: u frozen at zero, :29-39),
    the matrices in ``params``; ``replay`` an iterator of the nonlinear
    draws [u0 noise, step noises...] in place of the generator's."""
    def z(gen, shape):
        return next(replay) if replay is not None else torch.randn(
            shape, generator=gen)

    if degenerate:
        init = lambda p, g, n: torch.zeros((n, 1))  # noqa: E731
        prop = lambda p, g, u: u  # noqa: E731
        c = None
    else:
        init = lambda p, g, n: 0.1 * z(g, (n, 1))  # noqa: E731
        prop = lambda p, g, u: u + 0.15 * z(g, u.shape)  # noqa: E731
        c = lambda p, u: torch.stack([torch.sin(u[0]),  # noqa: E731
                                      torch.cos(u[0])])
    return CLGSSM.create(
        nl_dim=1, lin_dim=D, obs_dim=K, sample_initial_nl=init,
        propagate_nl=prop, Fmat=lambda p, u: p["F"],
        Gmat=lambda p, u: p["G"], Vcov=lambda p, u: p["V"],
        Wcov=lambda p, u: p["W"], c=c, m0=M0, C0=C0,
        params={k: torch.from_numpy(v) for k, v in MATS.items()},
        mats_constant=mats_constant, device="cpu")


@pytest.fixture(scope="module")
def rbpf_ys():
    rng = np.random.default_rng(7)
    out = rng.standard_normal((40, K)).astype(np.float32)
    out[0] = 0.0
    return out


@pytest.mark.parametrize("mats_constant", [True, False],
                         ids=["constant", "general"])
@pytest.mark.parametrize("ess_threshold", [0.5, None])
def test_rbpf_matches_jax(rbpf_ys, mats_constant, ess_threshold):
    ys = rbpf_ys[:T]
    key = jax.random.key(25)
    ref = jrbpf(key, _jax_offset_model(mats_constant), jnp.asarray(ys), N,
                ess_threshold=ess_threshold, return_history=True)
    k_init, k_scan = jax.random.split(key)
    noise, steps = [normal_noise(k_init, (N, 1))[0]], []
    for t in range(1, T):
        k_res, k_prop = fold_split(k_scan, t)
        steps.append(registry_draws("systematic", k_res, N))
        noise.append(normal_noise(k_prop, (N, 1))[0])
    out = rao_blackwell_filter(0, _offset_model(mats_constant, iter(noise)),
                               ys, N, ess_threshold=ess_threshold,
                               return_history=True, draws={"steps": steps})
    for f in ("nl_particles", "means", "ess", "log_evidence",
              "filtered_mean", "filtered_nl_mean", "final_cov",
              "final_log_weights"):
        _close(getattr(out, f).numpy(), getattr(ref, f), atol=1e-5)


@pytest.mark.parametrize("mats_constant", [False, True])
def test_rbpf_reduces_to_kalman(rbpf_ys, mats_constant):
    # tests/test_rbpf.py:132-143: with u frozen the RBPF is Kalman.
    res = rao_blackwell_filter(1, _offset_model(mats_constant,
                                                degenerate=True),
                               rbpf_ys, 8)
    m, _, ll = kalman_filter(rbpf_ys, F_NP, G_NP, V_NP, W_NP, M0, C0)
    np.testing.assert_allclose(float(res.log_evidence), ll, rtol=1e-4)
    np.testing.assert_allclose(res.filtered_mean[1:].numpy(), m[1:],
                               atol=1e-4)
    if mats_constant:
        np.testing.assert_allclose(res.ess.numpy(), 8.0, rtol=1e-5)


def _joint_bootstrap_model():
    """The offset model on the joint state (u, z): tests/test_rbpf.py:
    59-96."""
    Gt, Ft = torch.from_numpy(G_NP), torch.from_numpy(F_NP)
    w_chol = torch.linalg.cholesky(torch.from_numpy(W_NP))
    v_inv = torch.linalg.inv(torch.from_numpy(V_NP))
    v_logdet = float(np.linalg.slogdet(V_NP)[1])

    def init(p, gen, shape):
        u = 0.1 * torch.randn(shape + (1,), generator=gen)
        return torch.cat([u, torch.randn(shape + (D,), generator=gen)], -1)

    def prop(p, gen, x):
        u = x[..., :1] + 0.15 * torch.randn(x[..., :1].shape, generator=gen)
        z = x[..., 1:] @ Gt.T + torch.randn(x[..., 1:].shape,
                                            generator=gen) @ w_chol.T
        return torch.cat([u, z], -1)

    def obs(p, y, x):
        u, z = x[..., 0], x[..., 1:]
        r = y[None, :] - z @ Ft.T - torch.stack([torch.sin(u), torch.cos(u)],
                                                -1)
        quad = torch.einsum("nk,kl,nl->n", r, v_inv, r)
        return -0.5 * (quad + v_logdet + K * np.log(2.0 * np.pi))

    return CustomSSM.create(1 + D, init, prop, obs)


def test_rbpf_agrees_with_joint_bootstrap(rbpf_ys):
    # tests/test_rbpf.py:151-158 (bootstrap at N = 4096, not 16384).
    rb = rao_blackwell_filter(2, _offset_model(True), rbpf_ys, 1024)
    bf = bootstrap_filter(3, _joint_bootstrap_model(), rbpf_ys, 4096,
                          resampler="systematic", layout="batch",
                          return_history=False, device="cpu")
    assert abs(float(rb.log_evidence) - float(bf.log_evidence)) < 1.0


def test_rbpf_general_bank_shapes(rbpf_ys):
    # tests/test_rbpf.py:172-191.
    res = rao_blackwell_filter(4, _offset_model(False), rbpf_ys, 32,
                               return_history=True)
    c = res.final_cov.numpy()
    assert c.shape == (32, D, D)
    np.testing.assert_allclose(c, np.broadcast_to(c[0], c.shape), atol=1e-5)
    assert res.nl_particles.shape == (40, 32, 1)
    assert res.means.shape == (40, 32, D)
    res = rao_blackwell_filter(4, _offset_model(True), rbpf_ys, 64,
                               resampler="residual", ess_threshold=None)
    assert np.isfinite(float(res.log_evidence))


def test_rbpf_general_bank_step_matches_the_shared_one():
    # The general bank (vmapped matrices, batched library factor and
    # solves) on particles sharing one covariance gives the shared-
    # covariance step's means, covariance and log-likelihoods.
    gen = torch.Generator().manual_seed(0)
    u = torch.randn((64, 1), generator=gen)
    m = torch.randn((64, D), generator=gen)
    A = 0.3 * torch.randn((D, D), generator=gen)
    P = A @ A.T + 0.1 * torch.eye(D)
    y = torch.tensor([0.3, -0.2])
    m_g, P_g, ll_g = trbpf._kf_general(_offset_model(False), y, u, m,
                                       P.expand(64, D, D))
    m_c, P_c, ll_c = trbpf._kf_constant(_offset_model(True), y, u, m, P)
    _close(m_g.numpy(), m_c.numpy(), atol=1e-5)
    _close(P_g.numpy(), np.broadcast_to(P_c.numpy(), P_g.shape), atol=1e-5)
    _close(ll_g.numpy(), ll_c.numpy(), atol=1e-5)


# -- EnKF ------------------------------------------------------------------

class _OneRank:
    """A particle axis of one rank, whose collectives are the identity."""

    index, size = 0, 1

    def psum(self, x):
        return x

    def pmax(self, x):
        return x


@pytest.mark.parametrize("axis", [None, "one rank"])
def test_enkf_matches_jax(axis):
    jm = jax_model("mvn")
    tm = port_model(jm)
    ys = _trace(jm)
    key = jax.random.key(26)
    ref = jenkf(key, jm, jnp.asarray(ys), N)
    k_init, k_scan = jax.random.split(key)
    steps = []
    for t in range(1, T):
        k_prop, k_obs = fold_split(k_scan, t)
        steps.append((batch_noise(k_prop, jm, (N, 2)),
                      to_torch(jax.random.normal(k_obs, (N, 2), F32))))
    out = ensemble_kalman_filter(
        0, tm, ys, N, draws={"init": batch_noise(k_init, jm, (N, 2)),
                             "steps": steps},
        axis_name=None if axis is None else _OneRank())
    for f in ("final_ensemble", "means", "spread"):
        _close(getattr(out, f).numpy(), getattr(ref, f), atol=1e-5)


def test_enkf_matches_kalman_oracle():
    # tests/test_enkf.py:30-38 at N = 4096.
    p = demo_model_params()
    model = DLM.create(noise="mvn", device="cpu", **p)
    _, ys = model.simulate(torch.Generator().manual_seed(42), 200)
    km, kc, _ = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})
    res = ensemble_kalman_filter(1, model, ys, 4096)
    err = np.abs(res.means.numpy()[5:] - km[5:]).mean()
    assert err / (np.abs(km[5:]).mean() + 1.0) < 0.05
    r2 = ensemble_kalman_filter(1, model, ys[:50], 512, inflation=1.3)
    r1 = ensemble_kalman_filter(1, model, ys[:50], 512)
    assert float(r2.spread[-1]) > float(r1.spread[-1])


# -- devices and host reads ---------------------------------------------------

def _custom(dim=2):
    return CustomSSM.create(
        dim, lambda p, g, s: torch.randn(s + (dim,), generator=g),
        lambda p, g, x: x + 0.1 * torch.randn(x.shape, generator=g),
        lambda p, y, x: -0.5 * ((y - x) ** 2).sum(-1))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_entry_points_on_device_none_need_the_card():
    c, ys = _custom(), torch.zeros(4, 2)
    model = types.SimpleNamespace(  # a model without a device
        state_dim=2, sample_initial=c.sample_initial, propagate=c.propagate,
        observation_logpdf=c.observation_logpdf, propagate_mean=lambda x: x)
    for run in (lambda: auxiliary_filter(0, model, ys, 16),
                lambda: conditional_smc(0, model, ys, ys, 16),
                lambda: particle_gibbs(0, model, ys, 16, 1),
                lambda: liu_west_filter(0, *_lw_fns(True), ys[:, :1], 16)):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


@pytest.fixture
def no_host_reads(monkeypatch):
    """Python-level reads of a tensor's value raise; the RBPF's ESS
    decision is counted through its ``host_scalar``."""
    def refuse(*a, **k):
        raise AssertionError("a host read in the filter loop")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    reads = []
    monkeypatch.setattr(trbpf, "host_scalar",
                        lambda x: reads.append(1) or bool(x.numpy()))
    return reads


def test_only_the_rbpf_decision_reads_back(no_host_reads, informative):
    _, model, ys = informative
    ys = ys[:20]
    auxiliary_filter(0, model, ys, 256)
    conditional_smc(0, model, ys, torch.zeros(20, 2), 64)
    particle_gibbs(0, model, ys, 64, 2)
    ensemble_kalman_filter(0, model, ys, 256)
    liu_west_filter(0, *_lw_fns(True), ys[:, :1], 256, device="cpu")
    assert no_host_reads == []
    for mats_constant in (True, False):
        rao_blackwell_filter(0, _offset_model(mats_constant), ys, 64,
                             ess_threshold=None)
        assert no_host_reads == []
        rao_blackwell_filter(0, _offset_model(mats_constant), ys, 64)
        assert len(no_host_reads) == 19
        no_host_reads.clear()
