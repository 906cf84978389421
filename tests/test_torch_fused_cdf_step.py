"""PyTorch port, ``ops/fused_cdf_step.py`` and ``engine="pallas"`` with the
systematic and stratified resamplers, against the JAX package on the CPU.

The JAX kernel runs in interpret mode with zero bits (see
tests/test_torch_fused_step.py). Given the same cdf, the systematic offset
``u`` replayed from JAX's key, and zero bits (stratified: ``u_g = 1e-12``
in every slot), the port's plain version must give JAX's ancestors
exactly and states and log-likelihoods at rtol 1e-5, atol 1e-5. The
statistical checks 5a-5d of ``benchmarks/validate_fused_tpu.py``
(``:117-191``) run through the plain version with Philox bits and their
own thresholds.
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_inputs import monthly_mats
from _torch_replay import fused_cdf_draws, fused_filter_parity, jax_model, \
    port_model, zero_bits

from cusmc_tpu.ops.fused_cdf_step import cdf_auto_tile as jax_cdf_auto_tile
from cusmc_tpu.ops.fused_cdf_step import fused_cdf_filter_step as jax_step
from cusmc_tpu.smc import particle_filter as jpf
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.ops import fused_cdf_step as fc
from cusmc_tpu_torch.ops.cumsum import blocked_cumsum
from cusmc_tpu_torch.smc import particle_filter as tpf
from cusmc_tpu_torch.smc.kalman import kalman_filter

D, N, TILE = 2, 4096, 1024
RTOL = ATOL = 1e-5


def _inputs(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.01, 1.0, n).astype(np.float32)
    cdf = np.cumsum(w, dtype=np.float32)
    X = rng.standard_normal((d, n)).astype(np.float32)
    y = (0.1 * rng.standard_normal(d)).astype(np.float32)
    G = (0.9 * np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(
        np.float32)
    Q = (0.1 * np.eye(d)).astype(np.float32)
    F = np.eye(d, dtype=np.float32)
    Li = (np.eye(d) / 0.3).astype(np.float32)
    return cdf, X, y, G, Q, F, Li


# (mode, noise, df, df_int, n)
PARITY_CASES = [("systematic", "mvn", None, None, N),
                ("systematic", "mvt", 5.0, 5, N),
                ("systematic", "mvt", 1.0, 1, N),
                ("systematic", "mvt", 5.5, None, N),
                ("systematic", "mvn", None, None, 8192),
                ("stratified", "mvn", None, None, N),
                ("stratified", "mvt", 5.0, 5, 8192)]


@pytest.mark.parametrize("mode,noise,df,df_int,n", PARITY_CASES)
def test_step_matches_jax_kernel_with_zero_bits(mode, noise, df, df_int, n):
    cdf, X, y, G, Q, F, Li = _inputs(n=n)
    log_norm = 0.75
    key = jax.random.key(21)
    xr, llr, ar = jax_step(
        key, jnp.asarray(cdf), jnp.asarray(cdf[127::128]),
        *map(jnp.asarray, (X, y, G, Q, F, Li)),
        None if df is None else jnp.float32(df), jnp.float32(log_norm),
        noise=noise, mode=mode, tile=TILE, interpret=True, df_int=df_int)
    draws = fused_cdf_draws(key)
    x, ll, a = fc.fused_cdf_filter_step_plain(
        *map(torch.from_numpy, (cdf, X, y, G, Q, F, Li)), df, log_norm,
        draws, noise=noise, mode=mode, tile=TILE, df_int=df_int,
        bits=zero_bits)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(llr), rtol=RTOL,
                               atol=ATOL)
    # The ancestors are searchsorted(cdf, fl(fl(g + u_g) * fl(total / n))).
    u = np.float32(1e-12) if mode == "stratified" else draws[0].numpy()
    pscale = np.float32(cdf[-1]) / np.float32(n)
    pos = (np.arange(n, dtype=np.float32) + u).astype(np.float32) * pscale
    expect = np.minimum(np.searchsorted(cdf, pos, side="right"), n - 1)
    np.testing.assert_array_equal(a.numpy(), expect)


@pytest.mark.parametrize("mode,noise,df,df_int", [
    ("systematic", "mvn", None, None), ("systematic", "mvt", 5.0, 5),
    ("stratified", "mvn", None, None), ("stratified", "mvt", 5.0, 5)])
def test_step_matches_jax_kernel_at_the_structural_width(mode, noise, df,
                                                         df_int):
    # d = 13, k = 1 (the monthly structural DLM's matrices), the width
    # whose kernel takes the (16, 1) bucket of the "thread" design.
    from cusmc_tpu_torch.ops.fused_step import step_widths

    G, Q, F, Li = monthly_mats()
    d = G.shape[0]
    cdf, X, _, _, _, _, _ = _inputs(seed=4, d=d)
    X = (0.3 * X).astype(np.float32)
    y = np.array([0.2], dtype=np.float32)
    key = jax.random.key(23)
    xr, llr, ar = jax_step(
        key, jnp.asarray(cdf), jnp.asarray(cdf[127::128]),
        *map(jnp.asarray, (X, y, G, Q, F, Li)),
        None if df is None else jnp.float32(df), jnp.float32(-0.5),
        noise=noise, mode=mode, tile=TILE, interpret=True, df_int=df_int)
    x, ll, a = fc.fused_cdf_filter_step_plain(
        *map(torch.from_numpy, (cdf, X, y, G, Q, F, Li)), df, -0.5,
        fused_cdf_draws(key), noise=noise, mode=mode, tile=TILE,
        df_int=df_int, bits=zero_bits)
    assert step_widths(d, F.shape[0]) == (16, 1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(llr), rtol=RTOL,
                               atol=ATOL)


# (d, k, mode, noise, df, df_int): the "tile" design in its padded widths
# at d = k = 64 and at k != d past the "thread" buckets ((64, 16)).
TILE_CASES = [(64, 64, "stratified", "mvt", 5.0, 5),
              (40, 1, "systematic", "mvn", None, None)]
TILE_N, TILE_SR = 2048, 8  # the smallest window the JAX kernel takes


@pytest.mark.parametrize("d,k,mode,noise,df,df_int", TILE_CASES)
def test_step_matches_jax_kernel_at_tile_widths(d, k, mode, noise, df,
                                                df_int):
    # The plain version the card holds the "tile" design to agrees with
    # the JAX kernel here.
    from cusmc_tpu_torch.ops.fused_step import step_path

    cdf, X, y, G, Q, F, Li = _inputs(seed=d + k, d=d, n=TILE_N)
    if k != d:
        rng = np.random.default_rng(100 + d + k)
        y = (0.1 * rng.standard_normal(k)).astype(np.float32)
        F = (0.3 * rng.standard_normal((k, d))).astype(np.float32)
        Li = (np.eye(k) / 0.3 + 0.1 * np.tril(rng.standard_normal((k, k)),
                                               -1)).astype(np.float32)
    key = jax.random.key(29)
    xr, llr, ar = jax_step(
        key, jnp.asarray(cdf), jnp.asarray(cdf[127::128]),
        *map(jnp.asarray, (X, y, G, Q, F, Li)),
        None if df is None else jnp.float32(df), jnp.float32(-0.5),
        noise=noise, mode=mode, tile=TILE, sr=TILE_SR, interpret=True,
        df_int=df_int)
    x, ll, a = fc.fused_cdf_filter_step_plain(
        *map(torch.from_numpy, (cdf, X, y, G, Q, F, Li)), df, -0.5,
        fused_cdf_draws(key), noise=noise, mode=mode, tile=TILE, sr=TILE_SR,
        df_int=df_int, bits=zero_bits)
    assert step_path(d, k) == "tile"
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(llr), rtol=RTOL,
                               atol=ATOL)


def test_filter_matches_jax_with_zero_bits(monkeypatch):
    jm = jax_model("mvt", 5.0)
    ys = load_y_sim()[:5].astype(np.float32)
    ties = fused_filter_parity(monkeypatch, jm, ys, N, "systematic", None,
                               "fused_cdf_filter_step_draws",
                               fused_cdf_draws)
    assert ties < 20


# -- statistics with real bits (validate_fused_tpu.py checks 5a-5d) ------

def _identity_step(cdf, X, q_scale, g_scale, gen, mode="systematic",
                   noise="mvn", df=None, df_int=None, tile=None):
    d = X.shape[0]
    eye = torch.eye(d)
    draws = fc.fused_cdf_filter_step_draws(gen)
    out = fc.fused_cdf_filter_step(
        cdf, X, torch.zeros(d), g_scale * eye, q_scale * eye, eye, eye, df,
        0.0, draws, noise=noise, mode=mode, tile=tile, df_int=df_int)
    return out, draws


def test_ancestors_obey_the_inverse_cdf_law_and_gather_exactly():
    rng = np.random.default_rng(7)
    n = 8192
    w = torch.from_numpy(rng.uniform(0.01, 1.0, n).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((D, n)).astype(np.float32))
    cdf, _ = blocked_cumsum(w)
    (Xc, _, ac), (u, _) = _identity_step(cdf, X, 0.0, 1.0,
                                         torch.Generator().manual_seed(1),
                                         tile=1024)
    c = cdf.numpy()
    pos = (np.arange(n) + float(u)) * (c[-1] / n)
    a = ac.numpy()
    lo = np.where(a > 0, c[np.maximum(a - 1, 0)], -np.inf)
    hi = c[np.minimum(a + 1, n - 1)]
    assert ((lo <= pos + 1e-5 * np.abs(pos))
            & (pos <= hi + 1e-5 * np.abs(hi))).all()
    assert torch.equal(Xc, X[:, ac.long()])


def test_noise_moments():
    n = 1 << 17
    cdf, _ = blocked_cumsum(torch.ones(n))
    X0 = torch.zeros((D, n))
    gen = torch.Generator().manual_seed(2)
    xs = _identity_step(cdf, X0, 0.5, 0.0, gen)[0][0].double()
    assert abs(float(xs.mean())) < 0.01 and abs(float(xs.std()) - 0.5) < 0.02
    xt = _identity_step(cdf, X0, 0.5, 0.0, gen, noise="mvt", df=5.0,
                        df_int=5)[0][0].double()
    assert abs(float(xt.var()) - 5.0 / 3.0 * 0.25) < 0.05


def test_stratified_offspring_track_weights():
    rng = np.random.default_rng(0)
    n = 8192
    logw = 2.0 * rng.standard_normal(n)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    cdf, _ = blocked_cumsum(torch.from_numpy((w * n).astype(np.float32)))
    X = torch.from_numpy(rng.standard_normal((D, n)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    tot = np.zeros(n)
    for _ in range(30):
        (_, _, a), _ = _identity_step(cdf, X, 0.0, 1.0, gen,
                                      mode="stratified", tile=1024)
        assert bool((a[1:] >= a[:-1]).all())
        tot += np.bincount(a.numpy(), minlength=n)
    err = np.abs(tot / (30 * n) - w).mean() / w.mean()
    assert err < 0.2, err


def test_filter_log_evidence_near_kalman():
    p = demo_model_params()
    ys = load_y_sim()[:101]
    _, _, zk = kalman_filter(ys, **{k: p[k] for k in
                                    ("F", "G", "V", "W", "m0", "C0")})
    model = DLM.create(device="cpu", noise="mvn", **p)
    zc = float(tpf.bootstrap_filter(0, model, ys, 8192,
                                    resampler="systematic", engine="pallas",
                                    return_history=False).log_evidence)
    zx = float(tpf.bootstrap_filter(0, model, ys, 8192,
                                    resampler="systematic", engine="xla",
                                    return_history=False).log_evidence)
    assert abs(zc - zk) < 0.02 * abs(zk) and abs(zc - zx) < 0.02 * abs(zk), \
        (zc, zx, zk)


# -- validation and routing ------------------------------------------------

def _step_kwargs(**over):
    cdf, X, y, G, Q, F, Li = map(torch.from_numpy, _inputs())
    kw = dict(cdf=cdf, X=X, y=y, G=G, Q=Q, F=F, Li=Li, df=None,
              log_norm=0.0, draws=fc.fused_cdf_filter_step_draws(None),
              noise="mvn", mode="systematic", tile=TILE, sr=16,
              df_int=None)
    kw.update(over)
    return kw


def _sized(n):
    """Arguments of N particles, as views that hold no memory."""
    return dict(cdf=torch.zeros(1).expand(n),
                X=torch.zeros(1, 1).expand(D, n), tile=1024)


BAD_ARGS = {
    "N % tile": lambda: dict(tile=1536),
    "tile % 1024": lambda: dict(tile=512),
    "N < 2 sr 128": lambda: dict(_sized(2048), sr=16),
    "N > 2^24": lambda: _sized((1 << 24) + 1024),
    "d > 128": lambda: dict(X=torch.zeros(129, N), G=torch.eye(129),
                            Q=torch.eye(129), F=torch.zeros(2, 129)),
    "mode": lambda: dict(mode="multinomial"),
    "float64 X": lambda: dict(X=torch.zeros(D, N, dtype=torch.float64)),
    "float64 cdf": lambda: dict(cdf=torch.ones(N, dtype=torch.float64)),
    "df_int": lambda: dict(noise="mvt", df=64.0, df_int=64),
    "mvt without df": lambda: dict(noise="mvt", df=None),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_step_rejects_bad_arguments(case):
    with pytest.raises(ValueError):
        fc.fused_cdf_filter_step(**_step_kwargs(**BAD_ARGS[case]()))


@pytest.mark.parametrize("noise,df,n", [
    ("mvn", None, 4096), ("mvn", None, 1000), ("mvn", None, 2048),
    ("mvt", 5.0, 1_000_448), ("mvt", 1.5, 4096), ("mvn", None, 3072)])
def test_eligibility_agrees_with_jax(noise, df, n):
    jm = jax_model(noise, df)
    assert tpf._fused_cdf_eligible(port_model(jm), n) == \
        jpf._fused_cdf_eligible(jm, n)
    for d in (2, 16, 32, 64):
        assert fc.cdf_auto_tile(n, d) == jax_cdf_auto_tile(n, d)
