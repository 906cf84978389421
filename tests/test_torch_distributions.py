"""PyTorch port, the distribution layer: mirrors tests/test_distributions.py
(the MVN normaliser at the origin, scipy's log-densities, sample moments,
the eigh square root, the product-t's marginal scale, the registry), and
holds ``make_mvn_logprob``, ``make_mvt_logprob``, the ``*_cov`` helpers and
``tri_inverse`` to the JAX functions on the same inputs.

``test_jit_through_pytree`` has no counterpart: the port's distributions
are plain dataclasses of tensors, and there is no ``jit`` to trace them
through.

Tolerances: the JAX tests' own (scipy at rtol/atol 2e-4, moments as
there); against the JAX functions in float32 at rtol 1e-5 (atol 1e-5 for
log-densities near zero).
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from _torch_replay import to_torch

from cusmc_tpu.distributions import make_mvn_logprob as j_make_mvn
from cusmc_tpu.distributions import make_mvt_logprob as j_make_mvt
from cusmc_tpu.distributions import mvn_logpdf_cov as j_mvn_logpdf_cov
from cusmc_tpu.distributions import mvn_sample_cov as j_mvn_sample_cov
from cusmc_tpu.distributions import mvt_logpdf_cov as j_mvt_logpdf_cov
from cusmc_tpu.utils.linalg import chol_sqrt as j_chol_sqrt
from cusmc_tpu.utils.linalg import tri_inverse as j_tri_inverse
from cusmc_tpu_torch.distributions import (
    MVN,
    MVT,
    make_distribution,
    make_mvn_logprob,
    make_mvt_logprob,
    mvn_logpdf_cov,
    mvn_sample,
    mvn_sample_cov,
    mvt_logpdf_cov,
    mvt_sample_cov,
)
from cusmc_tpu_torch.utils.linalg import chol_sqrt, eigh_sqrt, tri_inverse


def random_spd(rng, d):
    a = rng.standard_normal((d, d))
    return a @ a.T + d * np.eye(d)


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


class TestMVN:
    def test_standard_normal_at_origin(self):
        val = torch.exp(mvn_logpdf_cov(torch.zeros(2), torch.zeros(2),
                                       torch.eye(2)))
        assert np.isclose(float(val), 0.15915494, atol=1e-6)

    @pytest.mark.parametrize("d", [1, 2, 5, 16])
    def test_matches_scipy(self, d):
        rng = np.random.default_rng(d)
        mu = rng.standard_normal(d)
        cov = random_spd(rng, d)
        xs = rng.standard_normal((7, d))
        ours = mvn_logpdf_cov(t64(xs), t64(mu), t64(cov))
        ref = stats.multivariate_normal(mu, cov).logpdf(xs)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-4)

    def test_sample_moments(self):
        d = 3
        rng = np.random.default_rng(0)
        mu = rng.standard_normal(d)
        cov = random_spd(rng, d)
        xs = mvn_sample_cov(torch.Generator().manual_seed(0), t32(mu),
                            t32(cov), (200_000,)).numpy()
        np.testing.assert_allclose(xs.mean(0), mu, atol=0.05)
        np.testing.assert_allclose(np.cov(xs.T), cov, atol=0.15, rtol=0.05)

    def test_eigh_sqrt_equivalent(self):
        rng = np.random.default_rng(1)
        cov = t32(random_spd(rng, 4))
        q = eigh_sqrt(cov)
        np.testing.assert_allclose((q @ q.T).numpy(), cov.numpy(),
                                   rtol=1e-4, atol=1e-4)
        xs = mvn_sample_cov(torch.Generator().manual_seed(1),
                            torch.zeros(4), cov, (200_000,), method="eigh")
        np.testing.assert_allclose(np.cov(xs.numpy().T), cov.numpy(),
                                   atol=0.15, rtol=0.05)


class TestMVT:
    @pytest.mark.parametrize("d,df", [(1, 3.0), (2, 4.0), (8, 10.0)])
    def test_matches_scipy(self, d, df):
        rng = np.random.default_rng(d)
        mu = rng.standard_normal(d)
        cov = random_spd(rng, d)
        xs = rng.standard_normal((7, d))
        ours = mvt_logpdf_cov(t64(xs), t64(mu), t64(cov), df)
        ref = stats.multivariate_t(mu, cov, df=df).logpdf(xs)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-4)

    def test_sample_moments(self):
        d, df = 3, 8.0
        rng = np.random.default_rng(2)
        mu = rng.standard_normal(d)
        cov = random_spd(rng, d)
        xs = mvt_sample_cov(torch.Generator().manual_seed(2), t32(mu),
                            t32(cov), df, (400_000,)).numpy()
        np.testing.assert_allclose(xs.mean(0), mu, atol=0.05)
        np.testing.assert_allclose(np.cov(xs.T), df / (df - 2.0) * cov,
                                   atol=0.3, rtol=0.08)

    def test_per_dim_chi_variant_differs(self):
        d, df = 2, 5.0
        xs = mvt_sample_cov(torch.Generator().manual_seed(3), torch.zeros(d),
                            torch.eye(d), df, (400_000,), per_dim_chi=True)
        np.testing.assert_allclose(xs.numpy().var(0),
                                   df / (df - 2.0) * np.ones(d), rtol=0.05)


class TestRegistry:
    def test_make_and_dispatch(self):
        mvn = make_distribution("mvn", np.zeros(2), np.eye(2), device="cpu")
        mvt = make_distribution("mvt", np.zeros(2), np.eye(2), df=4.0,
                                device="cpu")
        assert isinstance(mvn, MVN) and isinstance(mvt, MVT)
        x = mvn.sample(torch.Generator().manual_seed(0), (5,))
        assert x.shape == (5, 2) and x.dtype == torch.float32
        assert mvn.log_prob(x).shape == (5,)
        assert mvt.log_prob(x).shape == (5,)
        assert mvt.sample(torch.Generator().manual_seed(1), (3,)).shape \
            == (3, 2)
        np.testing.assert_allclose(float(mvn.prob(torch.zeros(2))),
                                   1.0 / (2.0 * np.pi), rtol=1e-6)
        # A tensor argument keeps its device; None puts others on the card.
        assert make_distribution("mvn", torch.zeros(2),
                                 torch.eye(2)).mean.device.type == "cpu"

    def test_unknown_raises(self):
        with pytest.raises(KeyError):
            make_distribution("nope", np.zeros(2), np.eye(2), device="cpu")
        with pytest.raises(ValueError):
            make_distribution("mvt", np.zeros(2), np.eye(2), device="cpu")


@pytest.mark.parametrize("d", [2, 5, 16])
def test_closures_and_cov_helpers_match_jax(d):
    rng = np.random.default_rng(10 + d)
    mu = rng.standard_normal(d).astype(np.float32)
    cov = random_spd(rng, d).astype(np.float32)
    xs = rng.standard_normal((64, d)).astype(np.float32)
    x_t, mu_t, cov_t = t32(xs), t32(mu), t32(cov)
    x_j, mu_j, cov_j = jnp.asarray(xs), jnp.asarray(mu), jnp.asarray(cov)
    pairs = (
        (make_mvn_logprob(mu_t, cov_t)(x_t), j_make_mvn(mu_j, cov_j)(x_j)),
        (make_mvt_logprob(mu_t, cov_t, 5.0)(x_t),
         j_make_mvt(mu_j, cov_j, 5.0)(x_j)),
        (mvn_logpdf_cov(x_t, mu_t, cov_t), j_mvn_logpdf_cov(x_j, mu_j, cov_j)),
        (mvt_logpdf_cov(x_t, mu_t, cov_t, 5.0),
         j_mvt_logpdf_cov(x_j, mu_j, cov_j, 5.0)),
    )
    for ours, ref in pairs:
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    L = chol_sqrt(cov_t, jitter=0.5)
    np.testing.assert_allclose(L.numpy(), np.asarray(j_chol_sqrt(cov_j, 0.5)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tri_inverse(L).numpy(),
                               np.asarray(j_tri_inverse(jnp.asarray(
                                   L.numpy()))), rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError):
        make_mvn_logprob(mu_t, cov_t, precision="low")


def test_sample_cov_given_jax_normals():
    # mvn_sample_cov = mean + z @ scale.T: JAX's z, the same product.
    rng = np.random.default_rng(5)
    mu = rng.standard_normal(3).astype(np.float32)
    cov = random_spd(rng, 3).astype(np.float32)
    key = jax.random.key(8)
    ref = j_mvn_sample_cov(key, jnp.asarray(mu), jnp.asarray(cov), (100,))
    z = to_torch(jax.random.normal(key, (100, 3), jnp.float32))
    ours = mvn_sample(None, t32(mu), chol_sqrt(t32(cov)), (100,), z=z)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
