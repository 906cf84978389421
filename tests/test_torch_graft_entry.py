"""PyTorch port, the graft entry (``cusmc_tpu_torch/graft_entry.py``) and
``ops.fast_chi2``.

``entry(device="cpu")``'s step against ``__graft_entry__.entry()``'s
``fn`` on the same inputs (JAX's example state and zero log weights, and
dyadic log weights), the draws replayed from JAX's key (``roll_draws``,
``packed_noise``): states, log weights, ESS and the evidence increment at
rtol 1e-5, the ancestors equal (recorded from both packages' resample
ops).

``dryrun_multichip(n, device="cpu")`` at n = 1, 2 and 4 under gloo, each
group started once for the file (the call starts its own ranks): every
returned number finite, the 2-D grid's program only at n = 4, and at
n = 1 the metropolis filter's results bitwise those of the single-device
filter seeded with the rank stream's seed. Without a card the default
device raises (the card's cases, more ranks than cards and the entry's
one roll walk launch, are in ``tests/test_torch_cuda.py``).

``fast_chi2`` against the JAX package's on replayed draws (rtol 1e-5),
and its mean and variance within 5 standard errors of df and 2 df.
"""

import _torch_threads  # noqa: F401
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import dyadic_logw, fast_gamma_draws, packed_noise, \
    roll_draws

import __graft_entry__ as jentry
from cusmc_tpu.ops import fast_chi2 as jfast_chi2
from cusmc_tpu.smc import particle_filter as jpf
from cusmc_tpu_torch import graft_entry
from cusmc_tpu_torch.io.data import demo_model_params
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.ops import fast_chi2
from cusmc_tpu_torch.parallel.mesh import rank_seed
from cusmc_tpu_torch.smc import particle_filter as tpf

N = graft_entry.ENTRY_PARTICLES
B = 10
RANKS = (1, 2, 4)


class _Recorded:
    """A resample op whose ancestors (the third output) are kept."""

    def __init__(self, op, kept):
        self.op, self.kept = op, kept

    def draw(self, *args):
        return self.op.draw(*args)

    def __call__(self, *args):
        out = self.op(*args)
        self.kept.append(np.asarray(out[2]))
        return out


def _recording(monkeypatch, module, kept):
    make = module.packed_resample_op
    monkeypatch.setattr(module, "packed_resample_op",
                        lambda *a, **k: _Recorded(make(*a, **k), kept))


@pytest.mark.parametrize("weights", ["example", "dyadic"])
def test_entry_step_matches_jax(monkeypatch, weights):
    kept_j, kept_t = [], []
    _recording(monkeypatch, jpf, kept_j)
    _recording(monkeypatch, tpf, kept_t)
    jfn, (jx, jlogw, key, jt, jy) = jentry.entry()
    fn, (x, logw, gen, t, y) = graft_entry.entry(device="cpu")
    assert x.shape == tuple(jx.shape) and logw.shape == tuple(jlogw.shape)
    assert t == int(jt) and torch.equal(y, torch.zeros(2))
    assert torch.equal(logw, torch.zeros(N))
    if weights == "dyadic":
        jlogw = jnp.asarray(dyadic_logw(np.random.default_rng(5), N))
    x_np, logw_np = np.array(jx), np.array(jlogw)

    ref = jfn(jx, jlogw, key, jt, jy)
    k_res, k_prop = jax.random.split(jax.random.fold_in(key, t))
    draws = (roll_draws(k_res, N, B),
             packed_noise(k_prop, jentry._demo_model(), N))
    ours = fn(torch.from_numpy(x_np), torch.from_numpy(logw_np), gen, t, y,
              draws=draws)

    np.testing.assert_array_equal(kept_t[0], kept_j[0])
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def dryruns():
    return {n: graft_entry.dryrun_multichip(n, device="cpu") for n in RANKS}


FILTER_KEYS = ("systematic/log_evidence", "metropolis/log_evidence",
               "residual/log_evidence", "streaming/log_evidence",
               "mh/accept_rate", "pt/swap_rate", "chees/traj_length",
               "stretch/accept_rate", "enkf/means")


@pytest.mark.parametrize("n", RANKS)
def test_dryrun_multichip_under_gloo(dryruns, n):
    out = dryruns[n]
    for key in FILTER_KEYS:
        assert key in out, key
    for key, value in out.items():
        assert np.isfinite(np.asarray(value)).all(), (key, value)
    assert out["pt/swap_rate"].shape == (2,)
    assert out["enkf/means"].shape == (5, 2)
    assert 0.0 <= out["mh/accept_rate"] <= 1.0
    assert out["metropolis/final_particles"].shape == (8, 2)
    # The 2-D grid (chains x particles) needs an even n >= 4.
    assert ("replicated/log_evidence" in out) == (n == 4)
    if n == 4:  # rank 0 holds 2 of the 4 replicates
        assert out["replicated/log_evidence"].shape == (2,)


def test_dryrun_one_rank_metropolis_equals_single_device(dryruns):
    # A one-rank group's sharded metropolis filter draws its resample
    # draws, initial cloud and noise from the rank stream: bitwise the
    # single-device filter seeded with that stream's seed.
    out = dryruns[1]
    model = DLM.create(noise="mvt", df=5.0, device="cpu",
                       **demo_model_params())
    _, ys = model.simulate(torch.Generator().manual_seed(0), 5)
    res = tpf.bootstrap_filter(
        torch.Generator().manual_seed(rank_seed(0, 0)), model, ys, 8,
        resampler="metropolis")
    assert out["metropolis/log_evidence"] == float(res.log_evidence)
    np.testing.assert_array_equal(out["metropolis/ess"], res.ess.numpy())
    np.testing.assert_array_equal(out["metropolis/final_particles"],
                                  res.final_particles.numpy())
    np.testing.assert_array_equal(out["metropolis/final_log_weights"],
                                  res.final_log_weights.numpy())


def test_dryrun_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()


def test_dryrun_refuses_no_ranks():
    with pytest.raises(ValueError, match="positive"):
        graft_entry.dryrun_multichip(0, device="cpu")


@pytest.mark.parametrize("df", [7.5, 1.2, 5.0])
def test_fast_chi2_matches_jax_on_replayed_draws(df):
    key, shape = jax.random.key(3), (4, 1000)
    ref = np.asarray(jfast_chi2(key, df, shape, jnp.float32))
    alpha = float(np.float32(0.5) * np.float32(df))
    got = fast_chi2(None, df, shape, draws=fast_gamma_draws(key, alpha,
                                                            shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("df", [0.8, 3.0, 7.5])
def test_fast_chi2_moments(df):
    n = 400_000
    x = fast_chi2(torch.Generator().manual_seed(11), df, (n,)).double()
    mean_se = math.sqrt(2.0 * df / n)
    var_se = 2.0 * df * math.sqrt((2.0 + 12.0 / df) / n)
    assert abs(float(x.mean()) - df) < 5.0 * mean_se
    assert abs(float(x.var()) - 2.0 * df) < 5.0 * var_se
