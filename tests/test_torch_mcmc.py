"""PyTorch port, MCMC part 1: random-walk and adaptive Metropolis, MALA and
HMC, against ``cusmc_tpu.mcmc``.

Parity on replayed draws: each sampler runs in both packages on the same
target and the same first positions, with JAX's per-sweep draws (its key
schedule: ``fold_in(key, t)`` split into the sweep's keys) handed to the
port's ``draws=``; positions, log-densities, gradients, samples, the
pooled acceptance and the final step size at rtol 1e-5 (atol 1e-5: the
two packages' float32 products and gradients differ in the last bits).
The sweeps are short (T <= 60, C <= 16), so that no accept decision sits
within that rounding of its threshold. With bfloat16 proposal noise JAX
runs op by op (``jax.disable_jit``): compiled XLA on the CPU rewrites the
scaling of the bfloat16 normals.

Oracles: the cases of tests/test_mcmc.py and tests/test_mala_adaptive.py
at their sizes and thresholds (moments of MVN and MVT targets, adaptation
toward each target acceptance, the learned covariance, the squared-jump
orderings, ``chol_every``), each run on the port's own draws.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import F32, to_torch

from cusmc_tpu.distributions import make_mvt_logprob as jmake_mvt
from cusmc_tpu.distributions import mvn_logpdf_cov as jmvn_cov
from cusmc_tpu.mcmc import adaptive_mh_sampler as jam
from cusmc_tpu.mcmc import hmc_sampler as jhmc
from cusmc_tpu.mcmc import mala_sampler as jmala
from cusmc_tpu.mcmc import metropolis_hastings_sampler as jmh
from cusmc_tpu_torch.distributions import make_mvn_logprob, \
    make_mvt_logprob, mvn_logpdf_cov, mvt_logpdf_cov
from cusmc_tpu_torch.mcmc import adaptive_mh_sampler, hmc_sampler, \
    mala_sampler, metropolis_hastings_sampler
from cusmc_tpu_torch.utils.linalg import chol_sqrt


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def correlated_gaussian(d=4, rho=0.8, seed=0, factored=True):
    """tests/test_mala_adaptive.py's target in both packages. The port's
    log-density is ``make_mvn_logprob`` (the factor computed once), or,
    with ``factored=False``, ``mvn_logpdf_cov`` as the JAX test calls it
    (the parity cases)."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(d).astype(np.float32)
    cov = (rho * np.ones((d, d)) + (1 - rho) * np.eye(d)).astype(np.float32)
    jlogp = lambda x: jmvn_cov(x, jnp.asarray(mu), jnp.asarray(cov))
    mu_t, cov_t = torch.from_numpy(mu), torch.from_numpy(cov)
    logp = (make_mvn_logprob(mu_t, cov_t) if factored
            else lambda x: mvn_logpdf_cov(x, mu_t, cov_t))
    return mu, cov, jlogp, logp


def mvt_target(d, df=8.0):
    """bench_mh.py's target: MVT, identity scale."""
    z = np.zeros(d, np.float32)
    eye = np.eye(d, dtype=np.float32)
    return (jmake_mvt(jnp.asarray(z), jnp.asarray(eye), df),
            make_mvt_logprob(torch.from_numpy(z), torch.from_numpy(eye), df))


def _init(c, d, seed=0):
    x = np.random.default_rng(seed).standard_normal((c, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _mh_draws(key, steps, c, d, noise_dtype=F32):
    """MH, adaptive MH and MALA: ``kz, ku = split(fold_in(key, t))``."""
    out = []
    for t in range(steps):
        kz, ku = jax.random.split(jax.random.fold_in(key, t))
        out.append((to_torch(jax.random.normal(kz, (c, d), noise_dtype)
                             .astype(F32)),
                    to_torch(jax.random.uniform(ku, (c,), F32))))
    return out


def _hmc_draws(key, steps, c, d, num_leapfrog, jitter=True):
    """HMC: ``kp, kl, ku = split(fold_in(key, t), 3)``."""
    out = []
    for t in range(steps):
        kp, kl, ku = jax.random.split(jax.random.fold_in(key, t), 3)
        length = (int(jax.random.randint(kl, (), 1, num_leapfrog + 1))
                  if jitter else None)
        out.append((to_torch(jax.random.normal(kp, (c, d), F32)), length,
                    to_torch(jax.random.uniform(ku, (c,), F32))))
    return out


def _check_state(ours, ref, fields):
    for f in fields:
        _close(getattr(ours.state, f).numpy(), getattr(ref.state, f))
    _close(ours.samples.numpy(), ref.samples)
    _close(float(ours.accept_rate), float(ref.accept_rate))
    _close(float(ours.step_size), float(ref.step_size))


# -- parity on replayed draws ----------------------------------------------

@pytest.mark.parametrize("variant", ["identity", "chol", "bf16-noise",
                                     "thin"])
def test_mh_matches_jax(variant):
    c, d, steps = 16, 4, 60
    key = jax.random.key(11)
    _, cov, jlogp, logp = correlated_gaussian(d, rho=0.5, factored=False)
    jx, x = _init(c, d)
    if variant == "bf16-noise":
        steps = 30
    kw = dict(step_size=0.6, num_adapt=20)
    jkw = dict(kw)
    if variant == "chol":
        jkw["proposal_chol"] = jnp.asarray(np.linalg.cholesky(cov))
        kw["proposal_chol"] = torch.from_numpy(np.linalg.cholesky(cov))
    if variant == "thin":
        kw["thin"] = jkw["thin"] = 7
    noise = F32
    if variant == "bf16-noise":
        noise = jnp.bfloat16
        jkw["noise_dtype"] = jnp.bfloat16
        kw["noise_dtype"] = torch.bfloat16
    if variant == "bf16-noise":
        # Compiled XLA on the CPU multiplies the scale into the bfloat16
        # normals before their cast to float32 (3 decimals off); run op by
        # op, JAX casts first, as its code says and the port does.
        with jax.disable_jit():
            ref = jmh(key, jlogp, jx, steps, **jkw)
    else:
        ref = jmh(key, jlogp, jx, steps, **jkw)
    ours = metropolis_hastings_sampler(
        None, logp, x, steps, draws=_mh_draws(key, steps, c, d, noise), **kw)
    _check_state(ours, ref, ("x", "logp", "log_step", "accept_count"))
    assert ours.samples.shape == ref.samples.shape


@pytest.mark.parametrize("chol_every", [1, 10])
def test_adaptive_mh_matches_jax(chol_every):
    c, d, steps = 16, 4, 40
    key = jax.random.key(12)
    _, _, jlogp, logp = correlated_gaussian(d, rho=0.7, seed=1,
                                            factored=False)
    jx, x = _init(c, d, 1)
    kw = dict(num_adapt=30, chol_every=chol_every)
    ref = jam(key, jlogp, jx, steps, **kw)
    ours = adaptive_mh_sampler(None, logp, x, steps,
                               draws=_mh_draws(key, steps, c, d), **kw)
    _check_state(ours, ref, ("x", "logp", "mean", "cov", "count",
                             "log_step", "accept_count"))
    _close(ours.proposal_cov.numpy(), ref.proposal_cov)


def test_mala_matches_jax():
    c, d, steps = 16, 6, 50
    key = jax.random.key(13)
    jlogp, logp = mvt_target(d)
    jx, x = _init(c, d, 2)
    ref = jmala(key, jlogp, jx, steps, step_size=0.5)
    ours = mala_sampler(None, logp, x, steps, step_size=0.5,
                        draws=_mh_draws(key, steps, c, d))
    _check_state(ours, ref, ("x", "logp", "grad", "log_step",
                             "accept_count"))


@pytest.mark.parametrize("jitter", [True, False])
def test_hmc_matches_jax(jitter):
    c, d, steps, L = 8, 5, 30, 6
    key = jax.random.key(14)
    jlogp, logp = mvt_target(d)
    jx, x = _init(c, d, 3)
    ref = jhmc(key, jlogp, jx, steps, num_leapfrog=L, step_size=0.3,
               jitter=jitter)
    ours = hmc_sampler(None, logp, x, steps, num_leapfrog=L, step_size=0.3,
                       jitter=jitter,
                       draws=_hmc_draws(key, steps, c, d, L, jitter))
    _check_state(ours, ref, ("x", "logp", "grad", "log_step",
                             "accept_count"))


def test_hmc_divergence_rejects():
    # A non-finite energy rejects even where log u < log alpha would
    # accept: a density that is +inf outside |x| <= 10, and a step that
    # always leaves that box, give log alpha = +inf.
    d = 3

    def logp(x):
        out = torch.where(x.abs().amax(-1) > 10.0,
                          torch.full_like(x[:, 0], float("inf")),
                          -0.5 * torch.sum(x * x, dim=-1))
        return out

    x = torch.ones((4, d))
    res = hmc_sampler(0, logp, x, 5, step_size=50.0, adapt_rate=0.0,
                      keep_samples=False)
    assert float(res.accept_rate) == 0.0
    assert torch.equal(res.state.x, x)


@pytest.mark.parametrize("factory", ["mvn", "mvt"])
def test_logprob_factories_are_differentiable(factory):
    # tests/test_mcmc.py::test_factory_grad_matches_direct: MALA and HMC
    # differentiate log_prob; autograd of the port's closure equals JAX's
    # gradient of the JAX closure, and the closure's value is unchanged.
    d = 6
    rng = np.random.default_rng(5)
    a = rng.standard_normal((d, d))
    cov = (a @ a.T + d * np.eye(d)).astype(np.float32)
    mu = rng.standard_normal(d).astype(np.float32)
    x = rng.standard_normal((8, d)).astype(np.float32)
    if factory == "mvn":
        from cusmc_tpu.distributions import make_mvn_logprob as jmake
        jf = jmake(jnp.asarray(mu), jnp.asarray(cov))
        tf = make_mvn_logprob(torch.from_numpy(mu), torch.from_numpy(cov))
    else:
        jf = jmake_mvt(jnp.asarray(mu), jnp.asarray(cov), 5.0)
        tf = make_mvt_logprob(torch.from_numpy(mu), torch.from_numpy(cov),
                              5.0)
    jg = jax.grad(lambda y: jf(y).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    val = tf(xt)
    (g,) = torch.autograd.grad(val.sum(), xt)
    _close(g.numpy(), jg, rtol=1e-4, atol=1e-5)
    _close(val.detach().numpy(), jf(jnp.asarray(x)), rtol=2e-5, atol=2e-4)


# -- the oracles of tests/test_mcmc.py -------------------------------------

def test_mh_mvn_target_moments():
    d, chains, steps = 4, 64, 4000
    rng = np.random.default_rng(0)
    mu = rng.standard_normal(d).astype(np.float32)
    a = rng.standard_normal((d, d))
    cov = (a @ a.T + d * np.eye(d)).astype(np.float32)
    mu_t, cov_t = torch.from_numpy(mu), torch.from_numpy(cov)
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(0))
    res = metropolis_hastings_sampler(
        0, lambda x: mvn_logpdf_cov(x, mu_t, cov_t), init, steps,
        proposal_chol=chol_sqrt(cov_t))
    samples = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.25)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=1.2, rtol=0.25)


def test_mh_adaptation_reaches_target_accept():
    d, chains, steps = 16, 32, 3000
    logp = make_mvn_logprob(torch.zeros(d), torch.eye(d))
    res = metropolis_hastings_sampler(0, logp, torch.zeros((chains, d)),
                                      steps, step_size=1e-3, adapt_rate=0.1)
    assert 0.1 < float(res.accept_rate) < 0.5
    assert float(res.step_size) > 0.01


@pytest.mark.parametrize("noise_dtype", [None, torch.bfloat16])
def test_mh_mvt_target_marginal_variance(noise_dtype):
    d, df, chains, steps = 16, 8.0, 64, 4000
    logp = lambda x: mvt_logpdf_cov(x, torch.zeros(d), torch.eye(d), df)
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(1))
    res = metropolis_hastings_sampler(0, logp, init, steps,
                                      proposal_chol=torch.eye(d),
                                      step_size=0.4, noise_dtype=noise_dtype)
    samples = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(samples.var(0).mean(), df / (df - 2.0),
                               rtol=0.2)


def test_mh_bf16_noise_moments():
    # tests/test_mcmc.py::TestBf16Noise: a float32 state, the moments
    # recovered with bfloat16 proposal noise.
    d, chains, steps = 4, 64, 4000
    rng = np.random.default_rng(6)
    mu = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    cov = torch.eye(d) * 2.0
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(2))
    res = metropolis_hastings_sampler(
        0, make_mvn_logprob(mu, cov), init, steps,
        proposal_chol=chol_sqrt(cov), noise_dtype=torch.bfloat16)
    assert res.state.x.dtype == torch.float32
    samples = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(samples.mean(0), mu.numpy(), atol=0.25)
    np.testing.assert_allclose(samples.var(0), 2.0, rtol=0.25)


def test_mh_no_samples_and_reproducible():
    d = 3
    logp = make_mvn_logprob(torch.zeros(d), torch.eye(d))
    r = metropolis_hastings_sampler(0, logp, torch.zeros((8, d)), 100,
                                    keep_samples=False)
    assert r.samples is None and r.state.x.shape == (8, d)
    init = torch.ones((4, d))
    r1 = metropolis_hastings_sampler(3, logp, init, 200)
    r2 = metropolis_hastings_sampler(torch.Generator().manual_seed(3), logp,
                                     init, 200)
    assert torch.equal(r1.state.x, r2.state.x)
    assert torch.equal(r1.samples, r2.samples)


# -- the oracles of tests/test_mala_adaptive.py ----------------------------

def test_mala_mvn_target_moments():
    d, chains, steps = 4, 64, 3000
    mu, cov, _, logp = correlated_gaussian(d)
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(4))
    res = mala_sampler(0, logp, init, steps)
    samples = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.15)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.35)


def test_mala_adaptation_hits_target():
    d, chains, steps = 8, 32, 2000
    _, _, _, logp = correlated_gaussian(d, rho=0.0)
    res = mala_sampler(0, logp, torch.zeros((chains, d)), steps,
                       step_size=1e-3, adapt_rate=0.1)
    assert 0.35 < float(res.accept_rate) < 0.85


def _sq_jump(s, steps):
    x = s.samples[steps // 2:].numpy()
    return float(np.mean(np.sum(np.diff(x, axis=0) ** 2, axis=-1)))


def test_mala_beats_rwm_mixing_on_narrow_target():
    d, chains, steps = 16, 16, 800
    _, _, _, logp = correlated_gaussian(d, rho=0.0)
    init = torch.zeros((chains, d))
    mala = mala_sampler(0, logp, init, steps)
    rwm = metropolis_hastings_sampler(0, logp, init, steps)
    assert _sq_jump(mala, steps) > _sq_jump(rwm, steps)


def test_am_learns_correlated_covariance():
    d, chains, steps = 4, 128, 3000
    mu, cov, _, logp = correlated_gaussian(d, rho=0.85, seed=1)
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(5))
    res = adaptive_mh_sampler(0, logp, init, steps)
    samples = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.2)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.4)
    learned = res.proposal_cov.numpy() / (2.38 ** 2 / d)
    corr = learned / np.sqrt(np.outer(np.diag(learned), np.diag(learned)))
    assert corr[0, 1] > 0.4


def test_am_acceptance_near_target():
    d, chains, steps = 8, 64, 2500
    _, _, _, logp = correlated_gaussian(d, rho=0.5, seed=2)
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(6))
    res = adaptive_mh_sampler(0, logp, init, steps)
    assert 0.1 < float(res.accept_rate) < 0.45


def test_am_freeze_after_adapt_and_no_samples():
    d = 2
    _, _, _, logp = correlated_gaussian(d, rho=0.0)
    res = adaptive_mh_sampler(0, logp, torch.zeros((8, d)), 400,
                              num_adapt=100)
    assert float(res.state.count) == pytest.approx(101 * 8)
    r1 = adaptive_mh_sampler(0, logp, torch.ones((4, d)), 120,
                             keep_samples=False)
    assert r1.samples is None


def test_hmc_mvn_target_moments():
    d, chains, steps = 8, 64, 1500
    mu, cov, _, logp = correlated_gaussian(d, rho=0.7, seed=4)
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(7))
    res = hmc_sampler(0, logp, init, steps)
    samples = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.15)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.4)
    assert 0.5 < float(res.accept_rate) <= 1.0


def test_hmc_beats_mala_squared_jump():
    d, chains, steps = 32, 16, 600
    _, _, _, logp = correlated_gaussian(d, rho=0.0, seed=5)
    init = torch.zeros((chains, d))
    hmc = hmc_sampler(0, logp, init, steps, num_leapfrog=16)
    mala = mala_sampler(0, logp, init, steps)
    assert _sq_jump(hmc, steps) > _sq_jump(mala, steps)


def test_hmc_reproducible_without_jitter():
    d = 3
    _, _, _, logp = correlated_gaussian(d)
    init = torch.ones((4, d))
    r1 = hmc_sampler(9, logp, init, 100, jitter=False)
    r2 = hmc_sampler(9, logp, init, 100, jitter=False)
    assert torch.equal(r1.state.x, r2.state.x)


def test_chol_every_moments():
    d, chains, steps = 3, 64, 3000
    rng = np.random.default_rng(11)
    mu = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    cov = torch.diag(torch.tensor([1.0, 4.0, 0.25]))
    logp = lambda x: mvn_logpdf_cov(x, mu, cov)
    init = mu + torch.randn((chains, d),
                            generator=torch.Generator().manual_seed(8))
    res = adaptive_mh_sampler(0, logp, init, steps, chol_every=25)
    samples = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(samples.mean(0), mu.numpy(), atol=0.3)
    np.testing.assert_allclose(samples.var(0), [1.0, 4.0, 0.25], rtol=0.35)
    assert 0.1 < float(res.accept_rate) < 0.45


def test_chol_every_stream_shape_and_indivisible_raises():
    d, chains = 2, 8
    logp = lambda x: -0.5 * torch.sum(x * x, dim=-1)
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(9))
    res = adaptive_mh_sampler(0, logp, init, 40, chol_every=10)
    assert res.samples.shape == (40, chains, d)
    assert torch.isfinite(torch.diff(res.samples, dim=0)).all()
    with pytest.raises(ValueError, match="multiple of"):
        adaptive_mh_sampler(0, logp, torch.zeros((4, 2)), 41, chol_every=10)


def test_samplers_read_nothing_back_in_the_loop(monkeypatch):
    # The sweep loop makes no host read: a spy on the ways a tensor
    # reaches the host sees none while the samplers run (the adaptive
    # sampler's factor, refreshed once a block, is not in this loop).
    d = 3
    logp = make_mvt_logprob(torch.zeros(d), torch.eye(d), 8.0)
    reads = []
    for name in ("item", "__bool__", "__float__", "__int__", "tolist",
                 "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    x = torch.zeros((4, d))
    metropolis_hastings_sampler(0, logp, x, 20, noise_dtype=torch.bfloat16)
    mala_sampler(0, logp, x, 20)
    hmc_sampler(0, logp, x, 10, num_leapfrog=4)
    monkeypatch.undo()
    assert reads == []
