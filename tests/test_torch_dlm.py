"""PyTorch port, the DLM: parameters carried across from JAX, and the packed
methods against the JAX model given JAX's own draws (replayed key
schedules), for MVN, MVT df=5 (the exact integer chi-square path) and MVT
df=4.5 (the fixed-round gamma path).

Tolerance: rtol 1e-5 on float32 states and log-densities (the same
arithmetic, with matmuls summed in another order); atol 1e-6 for values
near zero.

``DLM.create`` from tensors (a PMMH builder's theta): bitwise the model
built from the same numbers as numpy, no tensor routed through
``np.asarray`` (a spy), and a tensor that requires grad accepted; the
other builders (stochastic volatility, UNGM, the CLGSSM's parameters and
prior) likewise.
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


MODEL_BUFFERS = FIELDS + ("F_f32", "G_f32", "W_sqrt_f32", "log_norm")


@pytest.mark.parametrize("noise,df,state_dtype",
                         [("mvn", None, None), ("mvt", 5.0, None),
                          ("mvt", 4.5, torch.bfloat16)])
def test_create_from_tensors_is_bitwise_the_numpy_model(monkeypatch, noise,
                                                        df, state_dtype):
    # A tensor argument (a PMMH builder's theta on the card, here on the
    # CPU) is factored where it lies, never through numpy, and the model
    # is bitwise the one built from the same numbers as numpy.
    p = {k: np.asarray(v, np.float32) for k, v in demo_model_params().items()}
    want = DLM.create(device="cpu", noise=noise, df=df,
                      state_dtype=state_dtype, **p)
    seen = []
    orig = np.asarray

    def spy(a, *args, **kw):
        if isinstance(a, torch.Tensor):
            seen.append(tuple(a.shape))
        return orig(a, *args, **kw)
    monkeypatch.setattr(np, "asarray", spy)
    got = DLM.create(device="cpu", noise=noise,
                     df=None if df is None else torch.tensor(df),
                     state_dtype=state_dtype,
                     **{k: torch.from_numpy(v) for k, v in p.items()})
    monkeypatch.undo()
    assert seen == []
    for name in MODEL_BUFFERS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.df_int, got.df_value) == (want.df_int, want.df_value)
    if df is not None:
        assert torch.equal(got.df, want.df)


def test_create_takes_tensors_that_numpy_refuses():
    # Before the repair these raised ("Can't call numpy() on Tensor that
    # requires grad"); the model keeps the graph back to the parameter.
    p = demo_model_params()
    log_v = torch.zeros((), requires_grad=True)
    m = DLM.create(device="cpu", F=p["F"], G=p["G"], m0=p["m0"], C0=p["C0"],
                   V=torch.exp(log_v) * torch.from_numpy(
                       np.asarray(p["V"], np.float32)), W=p["W"])
    want = DLM.create(device="cpu", **p)
    for name in MODEL_BUFFERS:
        torch.testing.assert_close(getattr(m, name).detach(),
                                   getattr(want, name), rtol=0, atol=0)
    (g,) = torch.autograd.grad(m.log_norm, log_v)
    assert float(g) == pytest.approx(-1.0, rel=1e-6)  # -k/2, k = 2


def test_create_non_pd_covariance_raises_on_the_cpu():
    # On the CPU the factor checks its info flag and raises; on the card
    # it gives NaN instead (tests/test_torch_cuda.py).
    p = demo_model_params()
    with pytest.raises(torch.linalg.LinAlgError):
        DLM.create(device="cpu", **{**p, "V": -np.eye(2)})


def test_other_builders_take_tensors(monkeypatch):
    from cusmc_tpu_torch.models.clgssm import CLGSSM, params_from_numpy
    from cusmc_tpu_torch.models.stochvol import StochasticVolatility
    from cusmc_tpu_torch.models.ungm import UNGM

    calls = []
    orig = np.asarray

    def spy(a, *args, **kw):
        if isinstance(a, torch.Tensor):
            calls.append(tuple(a.shape))
        return orig(a, *args, **kw)
    monkeypatch.setattr(np, "asarray", spy)
    th = torch.tensor([0.9, 0.25], requires_grad=True)
    sv = StochasticVolatility.create(mu=-1.0, phi=th[0], sigma=th[1],
                                     device="cpu")
    want = StochasticVolatility.create(mu=-1.0, phi=0.9, sigma=0.25,
                                       device="cpu")
    for name in ("mu", "phi", "sigma", "beta"):
        assert torch.equal(getattr(sv, name).detach(), getattr(want, name))
    assert sv.phi.requires_grad
    un = UNGM.create(q=torch.tensor(10.0), r=th[1], device="cpu")
    assert float(un.q) == 10.0
    assert float(un.r.detach()) == pytest.approx(0.25)
    params = params_from_numpy({"a": torch.tensor([1.0, 2.0]),
                                "b": np.ones(2)}, device="cpu")
    assert params["a"].dtype == torch.float32
    assert params["b"].dtype == torch.float64
    model = CLGSSM.create(1, 1, 1, None, None, None, None, None, None,
                          m0=torch.zeros(1), C0=torch.eye(1),
                          device="cpu")
    assert torch.equal(model.C0, torch.eye(1))
    monkeypatch.undo()
    assert calls == []


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
