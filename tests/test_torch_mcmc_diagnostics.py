"""PyTorch port, the MCMC diagnostics against ``cusmc_tpu.diagnostics``.

Parity: split R-hat, the multi-chain ESS, rank-normalised R-hat, tail ESS
and the summary on the same float32 samples as the JAX functions, at rtol
1e-5 (the ESS through its float32 FFT autocovariance at rtol 1e-4: the
two packages' FFTs round differently, and the Geyer sum adds up to T/2
of their lags). Then the cases of tests/test_mcmc_diagnostics.py at their
thresholds: calibration on iid draws, AR(1) chains with a closed-form ESS,
unmixed and drifting chains, heavy tails, a scale disagreement, and the
port's MH sampler's own output.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cusmc_tpu import diagnostics as jdiag
from cusmc_tpu_torch.diagnostics import (
    effective_sample_size_chains,
    ess_tail,
    mcmc_summary,
    rank_normalized_rhat,
    split_rhat,
)


def _both(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _samples(case, seed=0):
    rng = np.random.default_rng(seed)
    if case == "iid":
        return rng.standard_normal((400, 4, 3))
    if case == "ar1":
        e = rng.standard_normal((301, 6, 2))
        x = np.zeros_like(e)
        for i in range(1, e.shape[0]):
            x[i] = 0.8 * x[i - 1] + 0.6 * e[i]
        return x
    if case == "cauchy":
        return rng.standard_cauchy((500, 4))
    s = rng.standard_normal((300, 4, 2))   # "unmixed"
    s[:, 0] += 3.0
    s[:, 1, 1] *= 4.0
    return s


@pytest.mark.parametrize("case", ["iid", "ar1", "cauchy", "unmixed"])
@pytest.mark.parametrize("fn", ["split_rhat", "effective_sample_size_chains",
                                "rank_normalized_rhat", "ess_tail"])
def test_diagnostic_matches_jax(case, fn):
    j, t = _both(_samples(case))
    rtol = 1e-4 if "ess" in fn else 1e-5
    ours = globals()[fn](t)
    ref = jax.jit(getattr(jdiag, fn))(j)
    assert tuple(ours.shape) == tuple(ref.shape)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol,
                               atol=1e-6)


def test_summary_matches_jax():
    j, t = _both(_samples("ar1", 3))
    ours = mcmc_summary(t)
    ref = jax.jit(jdiag.mcmc_summary)(j)
    assert set(ours) == set(ref)
    for k in ours:
        rtol = 1e-4 if "ess" in k else 1e-5
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)


# -- the cases of tests/test_mcmc_diagnostics.py ---------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_rhat_iid_near_one():
    s = _t(np.random.default_rng(0).standard_normal((2000, 8)))
    assert 0.99 < float(split_rhat(s)) < 1.01


def test_rhat_unmixed_chains_flagged():
    s = np.random.default_rng(1).standard_normal((1000, 4))
    s[:, 0] += 5.0
    assert float(split_rhat(_t(s))) > 1.5


def test_rhat_within_chain_drift_flagged():
    rng = np.random.default_rng(2)
    t = np.linspace(-3, 3, 2000)[:, None]
    s = t + 0.1 * rng.standard_normal((2000, 4))
    assert float(split_rhat(_t(s))) > 1.5


def test_rhat_vector_dims():
    s = _t(np.random.default_rng(3).standard_normal((500, 4, 3)))
    assert split_rhat(s).shape == (3,)


def test_ess_iid_near_total():
    t, c = 2000, 8
    s = _t(np.random.default_rng(4).standard_normal((t, c)))
    ess = float(effective_sample_size_chains(s))
    assert 0.5 * t * c < ess <= 1.5 * t * c


@pytest.mark.parametrize("phi", [0.5, 0.9])
def test_ess_ar1_matches_theory(phi):
    rng = np.random.default_rng(5)
    t, c = 4000, 8
    e = rng.standard_normal((t, c))
    x = np.zeros((t, c))
    for i in range(1, t):
        x[i] = phi * x[i - 1] + np.sqrt(1 - phi * phi) * e[i]
    ess = float(effective_sample_size_chains(_t(x)))
    expect = t * c * (1 - phi) / (1 + phi)
    assert 0.5 * expect < ess < 2.0 * expect


def test_summary_shapes_and_bounds():
    s = _t(np.random.default_rng(6).standard_normal((400, 4, 2)))
    out = mcmc_summary(s)
    assert out["mean"].shape == (2,) and out["ess_tail"].shape == (2,)
    assert bool(torch.all(out["rhat"] < 1.05))
    assert bool(torch.all(out["ess"] > 100))
    assert bool(torch.all(out["ess_per_draw"] <= 1.5))
    assert bool(torch.all(out["ess_tail"] > 50))


def test_sampler_integration():
    from cusmc_tpu_torch.mcmc import metropolis_hastings_sampler

    logp = lambda x: -0.5 * torch.sum(x * x, dim=-1)
    init = torch.randn((16, 2), generator=torch.Generator().manual_seed(0))
    r = metropolis_hastings_sampler(0, logp, init, 1000, step_size=1.2)
    out = mcmc_summary(r.samples[200:])
    assert bool(torch.all(out["rhat"] < 1.1))
    assert bool(torch.all(out["ess"] < 1000 * 16))
    assert bool(torch.all(out["ess"] > 50))


def test_heavy_tail_robustness():
    s = _t(np.random.default_rng(7).standard_cauchy((2000, 8)))
    assert 0.99 < float(rank_normalized_rhat(s)) < 1.02


def test_scale_disagreement_flagged():
    s = np.random.default_rng(8).standard_normal((2000, 4))
    s[:, 0] *= 6.0
    assert float(split_rhat(_t(s))) < 1.1
    assert float(rank_normalized_rhat(_t(s))) > 1.2


def test_tail_ess_iid():
    t, c = 2000, 8
    s = _t(np.random.default_rng(9).standard_normal((t, c)))
    e = float(ess_tail(s))
    assert 0.3 * t * c < e <= 1.6 * t * c
