"""PyTorch port, the DLM: parameters carried across from JAX, and the packed
methods against the JAX model given JAX's own draws (replayed key
schedules), for MVN, MVT df=5 (the exact integer chi-square path) and MVT
df=4.5 (the fixed-round gamma path).

Tolerance: rtol 1e-5 on float32 states and log-densities (the same
arithmetic, with matmuls summed in another order); atol 1e-6 for values
near zero.
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import jax_model, packed_noise, port_model

from cusmc_tpu.io.data import demo_model_params
from cusmc_tpu_torch.models.base import supports_packed
from cusmc_tpu_torch.models.dlm import DLM

N = 4096
CASES = [("mvn", None), ("mvt", 5.0), ("mvt", 4.5)]
FIELDS = ("F", "G", "m0", "C0_sqrt", "W_sqrt", "V_chol", "V_chol_inv")


@pytest.mark.parametrize("noise,df", CASES)
def test_from_jax_arrays_round_trip(noise, df):
    jm = jax_model(noise, df)
    tm = port_model(jm)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    assert tm.noise == jm.noise and tm.df_int == jm.df_int
    assert supports_packed(tm)
    if df is not None:
        assert float(tm.df) == float(jm.df)


@pytest.mark.parametrize("noise,df", CASES)
def test_create_matches_jax_factors(noise, df):
    jm = jax_model(noise, df)
    tm = DLM.create(device="cpu", noise=noise, df=df, **demo_model_params())
    for name in FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-6, atol=1e-7)
    assert tm.df_int == jm.df_int


def test_df_int_dispatch_and_unported_options():
    p = demo_model_params()
    assert DLM.create(device="cpu", noise="mvt", df=5.0, **p).df_int == 5
    assert DLM.create(device="cpu", noise="mvt", df=4.5, **p).df_int is None
    assert DLM.create(device="cpu", noise="mvt", df=64.0, **p).df_int is None
    with pytest.raises(ValueError):
        DLM.create(device="cpu", noise="mvt", **p)
    # Mixed precision and the per-dimension chi-square, once refused here,
    # are ported (tests/test_torch_mixed_precision.py holds them to JAX).
    mixed = DLM.create(device="cpu", state_dtype=torch.bfloat16, **p)
    assert mixed.state_dtype == mixed.W_sqrt.dtype == torch.bfloat16
    assert mixed.V_chol.dtype == mixed.log_norm.dtype == torch.float32
    chi = DLM.create(device="cpu", noise="mvt", df=5.0, per_dim_chi=True, **p)
    assert chi.per_dim_chi and chi.df_int == 5
    noise = chi.packed_noise(torch.Generator().manual_seed(0), 16)
    assert tuple(noise[1][0].shape) == (2, 2, 16)   # (df // 2, d, n)
    assert tuple(noise[1][1].shape) == (2, 16)


@pytest.mark.parametrize("noise,df", CASES)
def test_observation_logpdf_packed_matches_jax(noise, df):
    jm = jax_model(noise, df)
    tm = port_model(jm)
    rng = np.random.default_rng(0)
    X = (0.1 * rng.standard_normal((2, N))).astype(np.float32)
    y = np.array([0.03, -0.02], np.float32)
    ref = jm.observation_logpdf_packed(jnp.asarray(y), jnp.asarray(X))
    ours = tm.observation_logpdf_packed(torch.from_numpy(y),
                                        torch.from_numpy(X))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("noise,df", CASES)
def test_propagate_and_initial_given_jax_draws(noise, df):
    jm = jax_model(noise, df)
    tm = port_model(jm)
    key = jax.random.key(5)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2, N)).astype(np.float32)

    ref = jm.propagate_packed(key, jnp.asarray(X))
    ours = tm.propagate_packed(None, torch.from_numpy(X),
                               packed_noise(key, jm, N))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)

    ref0 = jm.sample_initial_packed(key, N)
    ours0 = tm.sample_initial_packed(None, N, packed_noise(key, jm, N))
    np.testing.assert_allclose(ours0.numpy(), np.asarray(ref0), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("noise,df", CASES)
def test_packed_draws_have_the_transition_variance(noise, df):
    # x = L z sqrt(df / chi2): marginal variance df/(df-2) * W for MVT.
    tm = DLM.create(device="cpu", noise=noise, df=df, **demo_model_params())
    gen = torch.Generator().manual_seed(0)
    out = tm.propagate_packed(gen, torch.zeros(2, 200_000)).double()
    W = demo_model_params()["W"]
    scale = 1.0 if df is None else df / (df - 2.0)
    np.testing.assert_allclose(out.var(dim=1).numpy(), scale * np.diag(W),
                               rtol=0.06)


def test_simulate_shapes_and_first_row():
    tm = DLM.create(device="cpu", noise="mvt", df=5.0, **demo_model_params())
    xs, ys = tm.simulate(torch.Generator().manual_seed(0), 30)
    assert xs.shape == (30, 2) and ys.shape == (30, 2)
    assert torch.equal(ys[0], torch.zeros(2))
    assert bool(torch.isfinite(xs).all()) and bool(torch.isfinite(ys).all())
    # Observations track the latent path within the observation noise.
    assert float((ys[1:] - xs[1:]).abs().max()) < 1.0
