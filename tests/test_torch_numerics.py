"""PyTorch port, numerics under the DLM: linalg, packed ops, the MVN/MVT
log-densities and the fixed-round samplers, each against the JAX function
on the same inputs (numpy arrays from a seed, or JAX's own replayed draws).

Tolerances: float32 results of the same arithmetic compare at rtol 1e-6
(one or two roundings may differ, e.g. a library log); log-densities at
rtol 1e-5 as the float32 quadform and normaliser are summed in another
order; an atol of 1e-6 covers values that cross zero.
"""

import _torch_threads  # noqa: F401
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from _torch_replay import chi2_integer_draws, fast_gamma_draws, to_torch

from cusmc_tpu.distributions import mvn as jmvn
from cusmc_tpu.distributions import mvt as jmvt
from cusmc_tpu.ops import packed as jpacked
from cusmc_tpu.ops import random as jrandom
from cusmc_tpu.utils import linalg as jlinalg
from cusmc_tpu_torch.distributions import mvn, mvt
from cusmc_tpu_torch.ops import packed, random as trandom
from cusmc_tpu_torch.utils import linalg


def _spd(rng, d):
    a = rng.standard_normal((d, d)).astype(np.float32)
    return (a @ a.T + d * np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("d", [2, 5])
def test_linalg_matches_jax(d):
    rng = np.random.default_rng(0)
    cov = _spd(rng, d)
    L = linalg.chol_sqrt(torch.from_numpy(cov)).numpy()
    np.testing.assert_allclose(L, np.asarray(jlinalg.chol_sqrt(
        jnp.asarray(cov, jnp.float32))), rtol=1e-5, atol=1e-6)
    for method in ("cholesky", "eigh"):
        Q = linalg.cov_sqrt(torch.from_numpy(cov), method).numpy()
        # eigh roots differ by column signs: compare Q Q^T with cov.
        np.testing.assert_allclose(Q @ Q.T, cov, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        linalg.cov_sqrt(torch.from_numpy(cov), "qr")
    b = rng.standard_normal((7, d)).astype(np.float32)
    np.testing.assert_allclose(
        linalg.tri_solve(torch.from_numpy(L), torch.from_numpy(b)).numpy(),
        np.asarray(jlinalg.tri_solve(jnp.asarray(L), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)


def test_matvec_quadform_match_jax():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 4)).astype(np.float32)
    X = rng.standard_normal((4, 1000)).astype(np.float32)
    Li = np.tril(rng.standard_normal((3, 3))).astype(np.float32)
    R = rng.standard_normal((3, 1000)).astype(np.float32)
    np.testing.assert_allclose(
        packed.matvec(torch.from_numpy(A), torch.from_numpy(X)).numpy(),
        np.asarray(jpacked.matvec(jnp.asarray(A), jnp.asarray(X))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        packed.quadform(torch.from_numpy(Li), torch.from_numpy(R)).numpy(),
        np.asarray(jpacked.quadform(jnp.asarray(Li), jnp.asarray(R))),
        rtol=1e-5, atol=1e-6)


def test_mvn_pdf_at_origin_is_one_over_two_pi():
    lp = mvn.mvn_logpdf(torch.zeros(2), 0.0, torch.eye(2))
    assert abs(math.exp(float(lp)) - 1.0 / (2.0 * math.pi)) < 1e-7


@pytest.mark.parametrize("family,df", [("mvn", None), ("mvt", 5.0),
                                       ("mvt", 4.5)])
def test_logpdf_matches_jax(family, df):
    rng = np.random.default_rng(2)
    d = 3
    L = np.linalg.cholesky(_spd(rng, d)).astype(np.float32)
    x = (3.0 * rng.standard_normal((500, d))).astype(np.float32)
    mean = rng.standard_normal(d).astype(np.float32)
    if family == "mvn":
        ours = mvn.mvn_logpdf(torch.from_numpy(x), torch.from_numpy(mean),
                              torch.from_numpy(L))
        ref = jmvn.mvn_logpdf(jnp.asarray(x), jnp.asarray(mean),
                              jnp.asarray(L))
    else:
        ours = mvt.mvt_logpdf(torch.from_numpy(x), torch.from_numpy(mean),
                              torch.from_numpy(L), df)
        ref = jmvt.mvt_logpdf(jnp.asarray(x), jnp.asarray(mean),
                              jnp.asarray(L), jnp.float32(df))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_mvt_normaliser_keeps_pi():
    # d=1, nu=1, Sigma=1 is the standard Cauchy: density 1/pi at 0.
    lp = mvt.mvt_logpdf(torch.zeros(1, 1), 0.0, torch.eye(1), 1.0)
    assert abs(math.exp(float(lp[0])) - 1.0 / math.pi) < 1e-6


@pytest.mark.parametrize("df", [1, 2, 5, 30])
def test_chi2_integer_df_transform_given_jax_draws(df):
    key = jax.random.key(df)
    shape = (1, 4096)
    ours = trandom.chi2_integer_df_transform(
        df, *chi2_integer_draws(key, df, shape))
    ref = jrandom.chi2_integer_df(key, df, shape, jnp.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("alpha", [0.7, 2.25, 2.5, 16.0])
def test_fast_gamma_transform_given_jax_draws(alpha):
    key = jax.random.key(7)
    shape = (1, 4096)
    ours = trandom.fast_gamma_transform(
        alpha, *fast_gamma_draws(key, alpha, shape))
    ref = jrandom.fast_gamma(key, alpha, shape, jnp.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


def test_chi2_validation():
    for bad in (0, 5.0, trandom.MAX_INTEGER_DF + 1):
        with pytest.raises(ValueError):
            trandom.chi2_integer_df(None, bad, (4,))


@pytest.mark.parametrize("alpha", [0.7, 2.5, 16.0])
def test_fast_gamma_ks(alpha):
    gen = torch.Generator().manual_seed(11)
    g = trandom.fast_gamma(gen, alpha, (100_000,)).double().numpy()
    assert (g > 0).all()
    stat, p = stats.kstest(g, "gamma", args=(alpha,))
    assert p > 1e-3, f"KS failed: stat={stat}, p={p}"


@pytest.mark.parametrize("df", [1, 2, 5, 30])
def test_chi2_integer_df_ks(df):
    gen = torch.Generator().manual_seed(12)
    c = trandom.chi2_integer_df(gen, df, (100_000,)).double().numpy()
    assert (c >= 0).all()
    np.testing.assert_allclose(c.mean(), df, rtol=0.03)
    stat, p = stats.kstest(c, "chi2", args=(df,))
    assert p > 1e-3, f"KS failed for df={df}: stat={stat}, p={p}"


@pytest.mark.parametrize("df", [5.0, 4.5])
def test_mvt_sample_marginal_ks(df):
    # One coordinate of MVT(0, I, df) is Student-t(df).
    gen = torch.Generator().manual_seed(13)
    x = mvt.mvt_sample(gen, torch.zeros(2), torch.eye(2), df, (50_000,))
    stat, p = stats.kstest(x[:, 0].double().numpy(), "t", args=(df,))
    assert p > 1e-3, f"KS failed: stat={stat}, p={p}"
    # The per-dimension chi-square (once refused here): with an identity
    # scale each coordinate is Student-t(df) on its own chi-square.
    xp = mvt.mvt_sample(gen, torch.zeros(2), torch.eye(2), df, (50_000,),
                        per_dim_chi=True)
    stat, p = stats.kstest(xp[:, 1].double().numpy(), "t", args=(df,))
    assert p > 1e-3, f"KS failed: stat={stat}, p={p}"


def test_per_dim_chi_variant_differs():
    # tests/test_distributions.py::test_per_dim_chi_variant_differs: the
    # reference's product-t keeps the marginal scale df / (df - 2).
    d, df = 2, 5.0
    gen = torch.Generator().manual_seed(14)
    xs = mvt.mvt_sample(gen, torch.zeros(d), torch.eye(d), df, (400_000,),
                        per_dim_chi=True)
    np.testing.assert_allclose(xs.double().var(0).numpy(),
                               df / (df - 2.0) * np.ones(d), rtol=0.05)
    # ... and its coordinates are uncorrelated but not independent: their
    # squares are, where the standard MVT's share one chi-square.
    sq = xs.double() ** 2
    shared = mvt.mvt_sample(gen, torch.zeros(d), torch.eye(d), df,
                            (400_000,)).double() ** 2
    lo = torch.log1p(sq)
    lo_shared = torch.log1p(shared)
    corr = float(torch.corrcoef(lo.T)[0, 1])
    corr_shared = float(torch.corrcoef(lo_shared.T)[0, 1])
    assert abs(corr) < 0.01 and corr_shared > 0.1, (corr, corr_shared)


def test_mvn_sample_given_draws_matches_jax():
    key = jax.random.key(3)
    scale = np.array([[1.0, 0.0], [0.5, 2.0]], np.float32)
    mean = np.array([1.0, -1.0], np.float32)
    z = jax.random.normal(key, (64, 2), jnp.float32)
    ref = jmvn.mvn_sample(key, jnp.asarray(mean), jnp.asarray(scale), (64,))
    ours = mvn.mvn_sample(None, torch.from_numpy(mean),
                          torch.from_numpy(scale), (64,), z=to_torch(z))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_log_normalize_and_ess_match_jax():
    from cusmc_tpu.diagnostics import metrics as jmetrics
    from cusmc_tpu_torch.diagnostics import metrics

    logw = (5.0 * np.random.default_rng(4).standard_normal(2048)).astype(
        np.float32)
    lw, lse = metrics.log_normalize(torch.from_numpy(logw))
    jlw, jlse = jmetrics.log_normalize(jnp.asarray(logw))
    np.testing.assert_allclose(lw.numpy(), np.asarray(jlw), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(lse), float(jlse), rtol=1e-6)
    np.testing.assert_allclose(
        float(metrics.effective_sample_size(torch.from_numpy(logw))),
        float(jmetrics.effective_sample_size(jnp.asarray(logw))), rtol=1e-5)
