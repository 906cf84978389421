"""PyTorch port, mixed precision (``DLM.create(state_dtype=torch.bfloat16)``)
against the JAX package on the CPU.

- The bfloat16 normal law: ``jax.random.normal`` builds a bfloat16 normal
  from 8-bit words (``jax.random.uniform`` keeps the top 7 bits, since the
  type has 7 mantissa bits), so it takes 128 values; the port's transform
  of the same words is bitwise JAX's.
- The composed packed step, given JAX's draws: bitwise equal bfloat16
  states (XLA and torch both round each bfloat16 operation, and take a
  bfloat16 product in float32 rounded once); log-likelihoods at rtol 1e-5,
  atol 1e-5 (float32 products summed in another order).
- The roll walk and the search-and-apply on a bfloat16 state: the float32
  run's ancestors, and the gathered values bitwise ``X[:, a]``.
- The fused Metropolis step's plain version against the JAX kernel in
  interpret mode (zero bits, ``s`` replayed): ancestors exactly; states
  bitwise but for a 1-ulp bfloat16 difference where the float32 value
  before rounding lies within 1e-6 relative of the rounding boundary (the
  two packages sum the d products in other orders); ``ll`` at rtol 1e-4,
  atol 1e-4 on the particles whose states agree (a state one ulp apart
  moves its residual).
- The filter on both engines: the checks of
  ``tests/test_particle_filter.py:143-176`` (log-evidence within 2% of the
  Kalman value, posterior means within 4 sd on more than 99% of the
  steps), the dtypes, and a whole short systematic run against JAX's with
  the draws replayed.
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import filter_step_keys, fused_step_draws, jax_model, \
    packed_noise, port_model, roll_draws, to_torch, zero_bits

from cusmc_tpu.ops.fused_step import fused_filter_step as jax_fused_step
from cusmc_tpu.resampling import rolls as jrolls
from cusmc_tpu.resampling.classic import POSITION_FNS as JAX_POSITION_FNS
from cusmc_tpu.smc import particle_filter as jpf
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.ops import fused_step as fs
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply
from cusmc_tpu_torch.ops.random import bf16_normal_table, normal
from cusmc_tpu_torch.parallel import sharded_bootstrap_filter
from cusmc_tpu_torch.resampling.rolls import roll_metropolis_sweeps_expspace
from cusmc_tpu_torch.smc import particle_filter as tpf
from cusmc_tpu_torch.smc.kalman import kalman_filter

BF16 = jnp.bfloat16
N = 4096
ORACLE_KEYS = ("F", "G", "V", "W", "m0", "C0")
FIELDS = ("F", "G", "m0", "C0_sqrt", "W_sqrt", "V_chol", "V_chol_inv")
CASES = [("mvn", None), ("mvt", 5.0), ("mvt", 4.5)]


def _bits16(t):
    """A bfloat16 tensor's 16-bit words, for bitwise comparison."""
    return t.view(torch.int16).numpy()


def _np_bits16(a):
    return np.asarray(a).view(np.int16)


# -- the bfloat16 normal law -------------------------------------------------

def test_bf16_normal_law_is_jax_on_every_level():
    key = jax.random.key(3)
    shape = (4, 1 << 14)
    # JAX's bfloat16 normal of each 8-bit word is the table's entry at the
    # word's top 7 bits, the level the port draws.
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint8))
    ref = jax.random.normal(key, shape, BF16)
    ours = bf16_normal_table()[torch.from_numpy(bits.astype(np.int64) >> 1)]
    np.testing.assert_array_equal(_bits16(ours), _np_bits16(ref))
    # Every one of the 128 levels: the table is JAX's 128 values in order.
    levels = np.unique(np.asarray(ref).astype(np.float32))
    assert levels.size == 128
    np.testing.assert_array_equal(bf16_normal_table().float().numpy(),
                                  levels)


def test_bf16_normal_draws_take_only_the_128_values():
    z = normal(torch.Generator().manual_seed(0), (1 << 20,), torch.bfloat16)
    assert z.dtype == torch.bfloat16
    values = torch.unique(z.float())
    assert values.numel() == 128
    assert torch.equal(values, bf16_normal_table().float())
    assert float(z.float().abs().max()) == 2.890625
    # The law's own moments (its 128 levels, uniformly), within 5 standard
    # errors of a sample of 2^20.
    table = bf16_normal_table().double()
    mean, var = float(table.mean()), float(table.var(unbiased=False))
    se = (var / z.numel()) ** 0.5
    assert abs(float(z.double().mean()) - mean) < 5 * se
    assert abs(float(z.double().var()) - var) < 0.01 * var


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 16])
@pytest.mark.parametrize("noise,df", CASES)
def test_create_bf16_matches_jax_factors_bitwise(noise, df, d):
    jm = jax_model(noise, df, d=d, state_dtype=BF16)
    tm = DLM.create(device="cpu", noise=noise, df=df,
                    state_dtype=torch.bfloat16,
                    **demo_model_params(d))
    for name in FIELDS:
        ours, ref = getattr(tm, name), np.asarray(getattr(jm, name))
        assert str(ours.dtype).split(".")[-1] == ref.dtype.name, name
        np.testing.assert_array_equal(ours.float().numpy(),
                                      ref.astype(np.float32))
    assert tm.G.dtype == tm.F.dtype == tm.W_sqrt.dtype == torch.bfloat16
    assert tm.V_chol.dtype == torch.float32
    assert tm.state_dtype == torch.bfloat16
    assert tm.df_int == jm.df_int
    carried = port_model(jm)
    for name in FIELDS:
        assert torch.equal(getattr(carried, name), getattr(tm, name)), name


@pytest.mark.parametrize("d", [2, 16])
@pytest.mark.parametrize("noise,df", CASES)
def test_composed_packed_step_is_jax_bitwise(noise, df, d):
    jm = jax_model(noise, df, d=d, state_dtype=BF16)
    tm = port_model(jm)
    key = jax.random.key(5)
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((d, N)).astype(np.float32), BF16)
    ref = jm.propagate_packed(key, X)
    ours = tm.propagate_packed(None, to_torch(X), packed_noise(key, jm, N))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits16(ours), _np_bits16(ref))
    ref0 = jm.sample_initial_packed(key, N)
    ours0 = tm.sample_initial_packed(None, N, packed_noise(key, jm, N))
    np.testing.assert_array_equal(_bits16(ours0), _np_bits16(ref0))
    y = (0.03 * rng.standard_normal(d)).astype(np.float32)
    ll_ref = jm.observation_logpdf_packed(jnp.asarray(y), ref)
    ll = tm.observation_logpdf_packed(torch.from_numpy(y), to_torch(ref))
    assert ll.dtype == torch.float32
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("state_dtype", [None, BF16])
@pytest.mark.parametrize("df", [5.0, 4.5])
def test_per_dim_chi_packed_step_matches_jax(df, state_dtype):
    jm = jax_model("mvt", df, state_dtype=state_dtype, per_dim_chi=True)
    tm = port_model(jm)
    assert tm.per_dim_chi
    key = jax.random.key(8)
    X = jnp.asarray(np.random.default_rng(2).standard_normal((2, N)),
                    state_dtype or jnp.float32)
    ref = jm.propagate_packed(key, X)
    noise = packed_noise(key, jm, N)
    assert tuple((noise[1][0] if noise[1][0] is not None
                  else noise[1][1]).shape[-2:]) == (2, N)
    ours = tm.propagate_packed(None, to_torch(X), noise)
    if state_dtype is None:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(_bits16(ours), _np_bits16(ref))


# -- the resample kernels' plain versions on a bfloat16 state ---------------

def test_roll_walk_on_a_bf16_state():
    rng = np.random.default_rng(4)
    ll = -25.0 * rng.standard_normal(N) ** 2
    w = torch.from_numpy(np.exp(ll - ll.max()).astype(np.float32))
    X32 = torch.from_numpy(rng.standard_normal((2, N)).astype(np.float32))
    X = X32.to(torch.bfloat16)
    key = jax.random.key(9)
    shifts, u = roll_draws(key, N, 10)
    y, a = roll_metropolis_sweeps_expspace(w, shifts, u, X)
    y32, a32 = roll_metropolis_sweeps_expspace(w, shifts, u, X32)
    assert y.dtype == torch.bfloat16
    assert torch.equal(a, a32)
    assert torch.equal(y, X[:, a.long()])
    assert bool((a != torch.arange(N, dtype=torch.int32)).any())
    # JAX's roll sweeps on the same bfloat16 state and draws.
    y_ref, a_ref = jrolls.roll_metropolis_sweeps_expspace(
        key, jnp.asarray(X32.numpy(), BF16), jnp.asarray(w.numpy()), 10)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(_bits16(y), _np_bits16(y_ref))


@pytest.mark.parametrize("local", [False, True])
def test_search_and_apply_on_a_bf16_state(local):
    rng = np.random.default_rng(5)
    w = rng.uniform(size=N).astype(np.float32)
    cdf = torch.cumsum(torch.from_numpy(w), 0)
    pos = (torch.arange(N, dtype=torch.float32) + 0.37) / N * cdf[-1]
    X32 = torch.from_numpy(rng.standard_normal((3, N)).astype(np.float32))
    base = N // 4 if local else None
    if local:
        pos, X32 = pos[N // 4:N // 2], X32[:, N // 4:N // 2]
    X = X32.to(torch.bfloat16)
    y, a = inverse_cdf_apply(cdf, pos, X, local_base=base)
    y32, a32 = inverse_cdf_apply(cdf, pos, X32, local_base=base)
    assert y.dtype == torch.bfloat16
    assert torch.equal(a, a32)
    rel = (a.long() - (base or 0)).clamp(0, X.shape[1] - 1)
    assert torch.equal(y, X[:, rel])


# -- the fused Metropolis step ----------------------------------------------

def _fused_inputs(d, seed=0, n=1024):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32)
    logw = (2.0 * rng.standard_normal(n)).astype(np.float32)
    logw -= logw.max()
    y = (0.1 * rng.standard_normal(d)).astype(np.float32)
    G = (0.9 * np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(
        np.float32)
    Q = (0.1 * np.eye(d) + 0.01 * rng.standard_normal((d, d))).astype(
        np.float32)
    F = np.eye(d, dtype=np.float32)
    Li = (np.eye(d) / 0.3).astype(np.float32)
    return X, logw, y, G, Q, F, Li


def _boundary_mismatches(x, x_ref, x_pre, rtol):
    """The states that differ, each exactly 1 bfloat16 ulp from the
    reference and with its float32 value before rounding within ``rtol``
    (relative) of the boundary between the two; returns their mask."""
    diff = x != x_ref
    if bool(diff.any()):
        ulps = (x.view(torch.int16).int() - x_ref.view(torch.int16).int())
        assert int(ulps.abs()[diff].max()) == 1
        mid = (x.float()[diff] + x_ref.float()[diff]) / 2
        dist = (x_pre[diff] - mid).abs() / mid.abs()
        assert float(dist.max()) <= rtol, float(dist.max())
    return diff


@pytest.mark.parametrize("d", [2, 16])
@pytest.mark.parametrize("noise,df,df_int", [("mvn", None, None),
                                             ("mvt", 5.0, 5),
                                             ("mvt", 5.5, None)])
def test_bf16_fused_step_matches_jax_kernel_with_zero_bits(d, noise, df,
                                                           df_int):
    n, tile = 1024, 256
    X, logw, y, G, Q, F, Li = _fused_inputs(d, n=n)
    Xb, Gb, Qb, Fb = (jnp.asarray(a, BF16) for a in (X, G, Q, F))
    key = jax.random.key(11)
    xr, llr, ar = jax_fused_step(
        key, Xb, jnp.asarray(logw), jnp.asarray(y), Gb, Qb, Fb,
        jnp.asarray(Li), None if df is None else jnp.float32(df),
        jnp.float32(-1.25), noise=noise, num_sweeps=10, tile=tile,
        interpret=True, df_int=df_int)
    draws = fused_step_draws(key, n, tile)
    args = (to_torch(Xb), torch.from_numpy(logw), torch.from_numpy(y),
            to_torch(Gb), to_torch(Qb), to_torch(Fb), torch.from_numpy(Li),
            df, -1.25, draws)
    kw = dict(noise=noise, num_sweeps=10, tile=tile, df_int=df_int,
              bits=zero_bits)
    x, ll, a, x_pre = fs.fused_filter_step_plain(*args, **kw,
                                                 pre_rounding=True)
    assert x.dtype == torch.bfloat16 and ll.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    diff = _boundary_mismatches(x, to_torch(xr), x_pre, 1e-6)
    same = ~diff.any(dim=0)
    np.testing.assert_allclose(ll.numpy()[same.numpy()],
                               np.asarray(llr)[same.numpy()], rtol=1e-4,
                               atol=1e-4)
    # The ancestors are the float32 step's on the same draws.
    _, _, a32 = fs.fused_filter_step_plain(
        *map(torch.from_numpy, (X, logw, y, G, Q, F, Li)), df, -1.25,
        draws, **kw)
    assert torch.equal(a, a32)


def test_bf16_fused_step_refuses_odd_d_as_jax_does():
    X, logw, y, G, Q, F, Li = _fused_inputs(3, n=1024)
    key = jax.random.key(1)
    with pytest.raises(ValueError, match="even d"):
        jax_fused_step(key, *(jnp.asarray(a, BF16) for a in (X,)),
                       jnp.asarray(logw), jnp.asarray(y),
                       *(jnp.asarray(a, BF16) for a in (G, Q, F)),
                       jnp.asarray(Li), None, jnp.float32(0.0), tile=256,
                       interpret=True)
    with pytest.raises(ValueError, match="even d"):
        fs.fused_filter_step(
            torch.from_numpy(X).to(torch.bfloat16), torch.from_numpy(logw),
            torch.from_numpy(y),
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (G, Q, F)),
            torch.from_numpy(Li), None, 0.0, fused_step_draws(key, 1024, 256),
            tile=256)


@pytest.mark.parametrize("d,state_dtype,per_dim_chi", [
    (2, BF16, False), (3, BF16, False), (16, BF16, False),
    (2, None, True), (2, BF16, True)])
def test_fused_eligibility_agrees_with_jax(d, state_dtype, per_dim_chi):
    jm = jax_model("mvt", 5.0, d=d, state_dtype=state_dtype,
                   per_dim_chi=per_dim_chi)
    tm = port_model(jm)
    for n, tile in ((4096, 512), (8192, 1024)):
        assert tpf._pallas_eligible(tm, n, tile) == \
            jpf._pallas_eligible(jm, n, tile)
        assert not tpf._fused_cdf_eligible(tm, n) or state_dtype is None
    assert fs.auto_tile(1 << 20, 128, 2) == 1024
    assert fs.auto_tile(1 << 20, 128, 4) == 512


# -- the filter ---------------------------------------------------------------

def _posterior_mean(result):
    ll = result.obs_loglik.double().numpy()
    w = np.exp(ll - ll.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return (w[:, :, None] * result.particles.double().numpy()).sum(axis=1)


@pytest.fixture(scope="module")
def demo301():
    p = demo_model_params()
    ys = load_y_sim()[:301]
    means, covs, loglik = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})
    return p, ys, means, covs, loglik


def _tracks_kalman(result, km, kc):
    pm = _posterior_mean(result)
    err = np.abs(pm[5:] - km[5:])
    scale = np.sqrt(kc[5:].diagonal(axis1=1, axis2=2))
    return np.mean(err < 4.0 * scale)


def test_bf16_filter_matches_the_kalman_oracle(demo301):
    # tests/test_particle_filter.py::test_mixed_precision_state_dtype.
    p, ys, km, kc, loglik = demo301
    model = DLM.create(device="cpu", noise="mvn",
                       state_dtype=torch.bfloat16, **p)
    res = tpf.bootstrap_filter(0, model, ys, 8192, resampler="systematic")
    assert res.particles.dtype == res.final_particles.dtype == torch.bfloat16
    for t in (res.obs_loglik, res.final_log_weights, res.ess,
              res.log_evidence):
        assert t.dtype == torch.float32
    assert abs(float(res.log_evidence) - loglik) < 0.02 * abs(loglik)
    assert _tracks_kalman(res, km, kc) > 0.99
    mvt = DLM.create(device="cpu", noise="mvt", df=5.0,
                     state_dtype=torch.bfloat16, **p)
    r = tpf.bootstrap_filter(0, mvt, ys[:50], 1024, resampler="metropolis",
                             return_history=False)
    assert r.final_particles.dtype == torch.bfloat16
    assert np.isfinite(float(r.log_evidence))


# The fused Metropolis step's log-evidence band on the trace of
# test_bf16_filter_paths_track_the_kalman_oracle (T = 101, N = 4096, B =
# 10), as logZ - Kalman: mean and sd of 24 seeds (0-23) of the port's
# bfloat16 pallas engine on the CPU. JAX's kernel draws zero bits in
# interpret mode, so its law cannot be sampled here; the plain version is
# held to that kernel step by step above. The
# float32 engine sat at -15.10 (sd 1.54): finite-B windowed Metropolis sits
# below Kalman over these sharp-weight steps, and bfloat16 adds about a nat.
PALLAS_METROPOLIS_BAND = (-16.25, 1.76)


@pytest.fixture(scope="module")
def jax_metropolis_logz(demo301):
    """logZ of JAX's bfloat16 Metropolis (xla) on the first 101 steps of
    the demo trace at N = 4096, seeds 0-11."""
    ys = jnp.asarray(demo301[1][:101])
    jm = jax_model("mvn", state_dtype=BF16)
    run = jax.jit(lambda k: jpf.bootstrap_filter(
        k, jm, ys, N, resampler="metropolis", engine="xla",
        return_history=False).log_evidence)
    return np.array([float(run(jax.random.key(s))) for s in range(12)])


@pytest.mark.parametrize("resampler,engine", [
    ("stratified", "xla"), ("multinomial", "xla"), ("residual", "xla"),
    ("metropolis", "xla"), ("metropolis", "pallas")])
def test_bf16_filter_paths_track_the_kalman_oracle(demo301, resampler,
                                                   engine, request):
    p, ys, km, kc, loglik = demo301
    ys = ys[:101]
    km, kc = km[:101], kc[:101]
    loglik = kalman_filter(ys, **{k: p[k] for k in ORACLE_KEYS})[2]
    model = DLM.create(device="cpu", noise="mvn",
                       state_dtype=torch.bfloat16, **p)
    res = tpf.bootstrap_filter(1, model, ys, N, resampler=resampler,
                               engine=engine)
    assert res.particles.dtype == torch.bfloat16
    assert res.obs_loglik.dtype == torch.float32
    assert _tracks_kalman(res, km, kc) > 0.99
    lz = float(res.log_evidence)
    if resampler != "metropolis":
        assert abs(lz - loglik) < 0.02 * abs(loglik)
    elif engine == "xla":
        # Against JAX's own bfloat16 runs (the roll walk's law): within 4
        # sd of their mean, the sd widened for the mean's error.
        ref = request.getfixturevalue("jax_metropolis_logz")
        sd = ref.std(ddof=1) * np.sqrt(1.0 + 1.0 / ref.size)
        assert abs(lz - ref.mean()) < 4.0 * sd, (lz, ref.mean(), sd)
    else:
        mean, sd = PALLAS_METROPOLIS_BAND
        assert abs(lz - loglik - mean) < 4.0 * sd, lz - loglik


def test_bf16_engines_refuse_as_jax_does():
    ys = torch.from_numpy(load_y_sim()[:4].astype(np.float32))
    jm = jax_model("mvn", state_dtype=BF16)
    tm = port_model(jm)
    with pytest.raises(ValueError):
        jpf.bootstrap_filter(jax.random.key(0), jm, jnp.asarray(ys.numpy()),
                             4096, resampler="systematic", engine="pallas",
                             pallas_interpret=True)
    for resampler in ("systematic", "stratified"):
        with pytest.raises(ValueError, match="float32 DLM"):
            tpf.bootstrap_filter(0, tm, ys, 4096, resampler=resampler,
                                 engine="pallas")
    odd = DLM.create(device="cpu", state_dtype=torch.bfloat16,
                     **demo_model_params(3))
    with pytest.raises(ValueError, match="bfloat16 state"):
        tpf.bootstrap_filter(0, odd, torch.zeros(4, 3), 4096,
                             engine="pallas")
    chi = DLM.create(device="cpu", noise="mvt", df=5.0, per_dim_chi=True,
                     **demo_model_params())
    with pytest.raises(ValueError):
        tpf.bootstrap_filter(0, chi, ys, 4096, engine="pallas")


def test_sharded_filter_refuses_a_bf16_model():
    ys = torch.from_numpy(load_y_sim()[:4].astype(np.float32))
    model = DLM.create(device="cpu", state_dtype=torch.bfloat16,
                       **demo_model_params())
    for resampler in ("systematic", "metropolis"):
        with pytest.raises(NotImplementedError, match="bfloat16"):
            sharded_bootstrap_filter(0, model, ys, 4096, resampler=resampler)


def _tie_check(t, diff, pos_t, w, ours_a, ref_a):
    """Each slot in ``diff`` is a cdf tie: its position lies within 1e-5
    of the total on every cdf boundary between the two ancestors (the two
    packages sum the float32 cdf in other orders)."""
    cdf = torch.cumsum(w.float(), 0).double().numpy()
    for g in diff:
        p_ = float(pos_t[g]) * cdf[-1]
        lo, hi = sorted((ours_a[g], ref_a[g]))
        assert np.all(np.abs(cdf[lo:hi] - p_) <= 1e-5 * cdf[-1]), \
            f"step {t} slot {g}: ancestors {lo} / {hi} off a tie"


def test_bf16_systematic_run_matches_jax(monkeypatch):
    # A whole run, T = 20, N = 4096, the port replaying JAX's draws, against
    # JAX run op by op (jax.disable_jit): compiled, XLA fuses the bfloat16
    # sum G x + W z into the reweight's product and reweights from the sum
    # before its rounding, while it stores the rounded state (ROADMAP
    # section 3); op by op, JAX reweights the stored state, as its fused
    # kernel and the port do. The two packages sum the cdf in other float32
    # orders, so an ancestor may differ where a position sits on a cdf
    # boundary within that rounding; each such slot is shown to be a tie.
    n, steps = N, 20
    jm = jax_model("mvn", state_dtype=BF16)
    tm = port_model(jm)
    ys = load_y_sim()[:steps].astype(np.float32)
    key = jax.random.key(5)
    with jax.disable_jit():
        ref = jpf.bootstrap_filter(key, jm, jnp.asarray(ys), n,
                                   resampler="systematic", engine="xla")
    k_init, step_keys = filter_step_keys(key, steps)
    x0 = to_torch(jm.sample_initial_packed(k_init, n))
    pos, noise = [], []
    for k in step_keys:
        k_res, k_prop = jax.random.split(k)
        pos.append(to_torch(JAX_POSITION_FNS["systematic"](k_res, n,
                                                           jnp.float32)))
        noise.append(packed_noise(k_prop, jm, n))
    ref_a, ref_x = np.asarray(ref.ancestors), to_torch(ref.particles)
    ref_ll = np.asarray(ref.obs_loglik).astype(np.float64)

    # Every step, from JAX's state and weights: a tie gives its slot
    # another state, whose weight moves the total and so every later
    # position of a free run, so each step starts from JAX's carry. The
    # log-evidence increment may then differ only through the tie slots:
    # by at most log(1 + eps), eps their larger weight over the agreeing
    # slots' total (float32 rounding: 1e-5 a step).
    op = tpf.packed_exp_resample_op("systematic", n)
    step = tpf._fast_exp_step_factory(tm, n, op, None)
    ties, lz_sum, lz_slack = 0, 0.0, 0.0
    for t in range(1, steps):
        ll_prev = torch.from_numpy(ref_ll[t - 1]).float()
        w = (torch.ones(n) if t == 1 else
             torch.exp(ll_prev - ll_prev.max()))
        x, _, ess, lz, ll, a = step(ref_x[t - 1].T.contiguous(), w,
                                    torch.from_numpy(ys[t]),
                                    draws=(pos[t - 1], noise[t - 1]))
        a = a.numpy()
        diff = np.nonzero(a != ref_a[t])[0]
        _tie_check(t, diff, pos[t - 1], w, a, ref_a[t])
        assert diff.size <= 1e-3 * n, diff.size
        ties += diff.size
        clean = a == ref_a[t]
        np.testing.assert_array_equal(_bits16(x.T.contiguous())[clean],
                                      _bits16(ref_x[t])[clean])
        np.testing.assert_allclose(ll.numpy()[clean], ref_ll[t][clean],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(ess), float(ref.ess[t]), rtol=1e-5)
        m = max(float(ll.max()), ref_ll[t].max())
        w_ours, w_ref = np.exp(ll.double().numpy() - m), np.exp(ref_ll[t] - m)
        eps = np.maximum(w_ours, w_ref)[~clean].sum() / w_ref[clean].sum()
        lz_ref = m + np.log(w_ref.sum()) - np.log(n)
        assert abs(float(lz) - lz_ref) <= np.log1p(eps) + 1e-5, t
        lz_sum += float(lz)
        lz_slack += np.log1p(eps) + 1e-5
    assert ties <= 1e-3 * n * (steps - 1), ties
    assert abs(lz_sum - float(ref.log_evidence)) <= lz_slack

    # The filter's own loop, free running: JAX's run exactly up to its
    # first tie, after which the two clouds part (each slot descends from
    # the other package's weights). Its log-evidence then stays within 4
    # sd of the difference of two runs (sd 1.1 nats over 40 seeds of the
    # port at this N and T, so 4 sqrt(2) 1.1 = 6.3 nats).
    pos_it, noise_it = iter(pos), iter(noise)
    monkeypatch.setitem(tpf.POSITION_FNS, "systematic",
                        lambda *a: next(pos_it))
    monkeypatch.setattr(tm, "sample_initial_packed", lambda gen, m: x0)
    monkeypatch.setattr(tm, "packed_noise", lambda gen, m: next(noise_it))
    out = tpf.bootstrap_filter(0, tm, torch.from_numpy(ys), n,
                               resampler="systematic", engine="xla")
    assert out.particles.dtype == out.final_particles.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits16(out.final_particles),
                                  _bits16(out.particles[-1]))
    ours_a = out.ancestors.numpy()
    for t in range(1, steps):
        diff = np.nonzero(ours_a[t] != ref_a[t])[0]
        w = (torch.ones(n) if t == 1 else
             torch.exp(out.obs_loglik[t - 1] - out.obs_loglik[t - 1].max()))
        _tie_check(t, diff, pos[t - 1], w, ours_a[t], ref_a[t])
        clean = ours_a[t] == ref_a[t]
        np.testing.assert_array_equal(_bits16(out.particles[t])[clean],
                                      _bits16(ref_x[t])[clean])
        if diff.size:
            break
        np.testing.assert_allclose(out.obs_loglik[t].numpy(), ref_ll[t],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.ess[t].numpy(), np.asarray(ref.ess[t]),
                                   rtol=1e-5)
    assert abs(float(out.log_evidence) - float(ref.log_evidence)) < 6.3
