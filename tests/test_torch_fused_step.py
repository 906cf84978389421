"""PyTorch port, ``ops/fused_step.py`` and ``engine="pallas"`` with the
metropolis resampler, against the JAX package on the CPU.

The JAX kernel runs in interpret mode, where ``pltpu.prng_random_bits``
returns zeros (``tests/test_fused_step.py:3-10``). Fed zero bits and the
window offsets ``s`` replayed from JAX's key, the port's plain version
must give JAX's ancestors exactly, and its states and log-likelihoods at
rtol 1e-5, atol 1e-5 (float32 products summed in another order). The
statistical checks of ``benchmarks/validate_fused_tpu.py:49-115``, which
the JAX package can run only on a TPU, run here through the plain version
with real (Philox) bits and their own thresholds.
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_inputs import monthly_mats
from _torch_replay import fused_filter_parity, fused_log_norm, \
    fused_step_draws, jax_model, port_model, zero_bits

import cusmc_tpu_torch
from cusmc_tpu.ops.fused_step import auto_tile as jax_auto_tile
from cusmc_tpu.ops.fused_step import fused_filter_step as jax_fused_step
from cusmc_tpu.smc import particle_filter as jpf
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.ops import fused_step as fs
from cusmc_tpu_torch.resampling.metropolis import metropolis_ancestors
from cusmc_tpu_torch.smc import particle_filter as tpf
from cusmc_tpu_torch.smc.kalman import kalman_filter

D, N, TILE = 2, 1024, 256
RTOL = ATOL = 1e-5


def _inputs(seed=0, d=D, n=N):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32)
    logw = (2.0 * rng.standard_normal(n)).astype(np.float32)
    logw -= logw.max()
    y = (0.1 * rng.standard_normal(d)).astype(np.float32)
    G = (0.9 * np.eye(d) + 0.05 * rng.standard_normal((d, d))).astype(
        np.float32)
    Q = (0.1 * np.eye(d)).astype(np.float32)
    F = np.eye(d, dtype=np.float32)
    Li = (np.eye(d) / 0.3).astype(np.float32)
    return X, logw, y, G, Q, F, Li


# (noise, df, df_int, num_window_tiles)
PARITY_CASES = [("mvn", None, None, 2), ("mvt", 5.0, 5, 2),
                ("mvt", 1.0, 1, 2), ("mvt", 5.5, None, 2),
                ("mvn", None, None, 3)]


@pytest.mark.parametrize("noise,df,df_int,wt", PARITY_CASES)
def test_step_matches_jax_kernel_with_zero_bits(noise, df, df_int, wt):
    X, logw, y, G, Q, F, Li = _inputs()
    log_norm = -1.25
    key = jax.random.key(11)
    xr, llr, ar = jax_fused_step(
        key, *map(jnp.asarray, (X, logw, y, G, Q, F, Li)),
        None if df is None else jnp.float32(df), jnp.float32(log_norm),
        noise=noise, num_sweeps=10, tile=TILE, interpret=True,
        df_int=df_int, num_window_tiles=wt)
    draws = fused_step_draws(key, N, TILE)
    x, ll, a = fs.fused_filter_step_plain(
        *map(torch.from_numpy, (X, logw, y, G, Q, F, Li)), df, log_norm,
        draws, noise=noise, num_sweeps=10, tile=TILE, df_int=df_int,
        num_window_tiles=wt, bits=zero_bits)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(llr), rtol=RTOL,
                               atol=ATOL)
    # The zero-bit ancestor map is the window's first tile, unrotated.
    i, lane = np.arange(N) // TILE, np.arange(N) % TILE
    s0 = int(draws[0][0])
    np.testing.assert_array_equal(
        a.numpy(), ((i + s0) % (N // TILE)) * TILE + lane)


def _jax_parity(X, logw, y, G, Q, F, Li, noise, df, df_int, log_norm, key):
    """The JAX kernel in interpret mode and the port's plain version with
    zero bits on the same inputs: ancestors exactly, states and ll at
    RTOL, ATOL."""
    xr, llr, ar = jax_fused_step(
        key, *map(jnp.asarray, (X, logw, y, G, Q, F, Li)),
        None if df is None else jnp.float32(df), jnp.float32(log_norm),
        noise=noise, num_sweeps=10, tile=TILE, interpret=True,
        df_int=df_int)
    x, ll, a = fs.fused_filter_step_plain(
        *map(torch.from_numpy, (X, logw, y, G, Q, F, Li)), df, log_norm,
        fused_step_draws(key, N, TILE), noise=noise, num_sweeps=10,
        tile=TILE, df_int=df_int, bits=zero_bits)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(llr), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("noise,df,df_int", [("mvn", None, None),
                                             ("mvt", 5.0, 5)])
def test_step_matches_jax_kernel_at_tile_widths(d, noise, df, df_int):
    # Widths whose kernel takes the "tile" design (d = 16 and 32 exactly,
    # d = 64 in its padded widths): the plain version it is held to on the
    # card agrees with the JAX kernel here.
    assert fs.step_path(d, d) == "tile"
    _jax_parity(*_inputs(d=d), noise, df, df_int, -1.25,
                jax.random.key(13))


def _shape_inputs(d, k, seed):
    """Inputs of state width d and observation width k != d: a dense F
    [k, d] and a triangular Li [k, k], made with numpy from a seed."""
    X, logw, _, G, Q, _, _ = _inputs(seed=seed, d=d)
    rng = np.random.default_rng(100 + seed)
    y = (0.1 * rng.standard_normal(k)).astype(np.float32)
    F = (0.3 * rng.standard_normal((k, d))).astype(np.float32)
    Li = (np.eye(k) / 0.3 + 0.1 * np.tril(rng.standard_normal((k, k)), -1)
          ).astype(np.float32)
    return X, logw, y, G, Q, F, Li


@pytest.mark.parametrize("d,k,noise,df,df_int", [
    (40, 1, "mvt", 5.0, 5), (20, 24, "mvn", None, None)])
def test_step_matches_jax_kernel_at_padded_tile_widths_k_not_d(
        d, k, noise, df, df_int):
    # Shapes with k != d past the "thread" buckets, which the card runs in
    # the "tile" design's padded widths ((64, 16) and (32, 32)).
    assert fs.step_path(d, k) == "tile" and fs.step_widths(d, k) != (d, k)
    _jax_parity(*_shape_inputs(d, k, seed=d + k), noise, df, df_int, -0.75,
                jax.random.key(19))


@pytest.mark.parametrize("noise,df,df_int", [("mvn", None, None),
                                             ("mvt", 5.0, 5)])
def test_step_matches_jax_kernel_at_the_structural_width(noise, df, df_int):
    # d = 13, k = 1, the width whose kernel takes the (16, 1) bucket of the
    # "thread" design on the card: its plain version agrees with the JAX
    # kernel here.
    G, Q, F, Li = monthly_mats()
    d, k = G.shape[0], F.shape[0]
    rng = np.random.default_rng(3)
    X = (0.3 * rng.standard_normal((d, N))).astype(np.float32)
    logw = (2.0 * rng.standard_normal(N)).astype(np.float32)
    logw -= logw.max()
    y = np.array([0.2], dtype=np.float32)
    key = jax.random.key(17)
    xr, llr, ar = jax_fused_step(
        key, *map(jnp.asarray, (X, logw, y, G, Q, F, Li)),
        None if df is None else jnp.float32(df), jnp.float32(-0.5),
        noise=noise, num_sweeps=10, tile=TILE, interpret=True,
        df_int=df_int)
    x, ll, a = fs.fused_filter_step_plain(
        *map(torch.from_numpy, (X, logw, y, G, Q, F, Li)), df, -0.5,
        fused_step_draws(key, N, TILE), noise=noise, num_sweeps=10,
        tile=TILE, df_int=df_int, bits=zero_bits)
    assert (d, k) == (13, 1) and fs.step_widths(d, k) == (16, 1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ar))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(llr), rtol=RTOL,
                               atol=ATOL)


def test_thread_widths_cover_every_shape():
    # Both kernels' rule, over every d, k <= 128: each shape maps to a
    # compiled design and widths, none to run-time widths. "thread" in the
    # smallest bucket that covers the shape while it needs at most 16
    # (k = 1 in a bucket of its own) but d = k = 16; "tile" at d = k in
    # TILE_DIMS exactly, else in the smallest padded width that covers it,
    # KM = 16 for k <= 16, else DM.
    buckets = fs.THREAD_BUCKET_DIMS
    pads = fs.TILE_PAD_DIMS
    seen = set()
    for d in range(1, fs.MAX_MXU_DIM + 1):
        for k in range(1, fs.MAX_MXU_DIM + 1):
            want = d if k == 1 else max(d, k)
            path = fs.step_path(d, k)
            dm, km = fs.step_widths(d, k)
            seen.add((path, dm, km))
            assert d <= dm and k <= km and km <= dm, (d, k)
            if path == "thread":
                assert want <= buckets[-1] and (d, k) != (16, 16), (d, k)
                assert dm == min(w for w in buckets if w >= want), (d, k)
                assert km == (1 if k == 1 else dm), (d, k)
            elif d == k and d in fs.TILE_DIMS:
                assert (dm, km) == (d, d)
            else:
                assert want > buckets[-1], (d, k)
                assert dm == min(w for w in pads if w >= want), (d, k)
                assert km == (fs.TILE_PAD_OBS if k <= fs.TILE_PAD_OBS
                              else dm)
    assert seen == ({("thread", w, 1) for w in buckets}
                    | {("thread", w, w) for w in buckets}
                    | {("tile", w, w) for w in fs.TILE_DIMS}
                    | {("tile", w, fs.TILE_PAD_OBS) for w in pads}
                    | {("tile", w, w) for w in pads})
    for d, k in ((0, 1), (1, 0), (129, 1), (2, 129)):
        for rule in (fs.step_path, fs.step_widths):
            with pytest.raises(ValueError):
                rule(d, k)


@pytest.mark.parametrize("d,k,path", [
    (2, 2, "thread"), (4, 4, "thread"), (8, 8, "thread"), (16, 16, "tile"),
    (32, 32, "tile"), (16, 8, "thread"), (5, 5, "thread"),
    (64, 64, "tile"), (24, 24, "tile"), (32, 1, "tile"), (2, 64, "tile"),
    (128, 128, "tile"), (16, 1, "thread")])
def test_step_path_by_shape(d, k, path):
    # A plain function of (d, k): the tile design at d = k in TILE_DIMS and
    # wherever the shape needs more than the widest bucket (16).
    assert fs.step_path(d, k) == path
    assert (path == "tile") == (d == k == 16 or
                                (d if k == 1 else max(d, k)) > 16)


@pytest.mark.parametrize("noise,df", [("mvn", None), ("mvt", 5.0),
                                      ("mvt", 5.5)])
def test_model_log_norm_matches_fused_factories(noise, df):
    jm = jax_model(noise, df)
    np.testing.assert_allclose(float(port_model(jm).log_norm),
                               fused_log_norm(jm), rtol=1e-6)
    created = DLM.create(device="cpu", noise=noise, df=df,
                         **demo_model_params())
    np.testing.assert_allclose(float(created.log_norm), fused_log_norm(jm),
                               rtol=1e-6)


def test_filter_matches_jax_with_zero_bits(monkeypatch):
    jm = jax_model("mvt", 5.0)
    ys = load_y_sim()[:5].astype(np.float32)
    fused_filter_parity(monkeypatch, jm, ys, N, "metropolis", TILE,
                        "fused_filter_step_draws",
                        lambda k: fused_step_draws(k, N, TILE))


# -- statistics with real bits (validate_fused_tpu.py checks 1-4) --------

def _identity_step(X, logw, q_scale, g_scale, gen, noise="mvn", df=None,
                   df_int=None, tile=fs.DEFAULT_TILE):
    d, n = X.shape
    eye = torch.eye(d)
    draws = fs.fused_filter_step_draws(gen, n, tile)
    return fs.fused_filter_step(X, logw, torch.zeros(d), g_scale * eye,
                                q_scale * eye, eye, eye, df, 0.0, draws,
                                noise=noise, tile=tile, df_int=df_int)


@pytest.fixture(scope="module")
def stat_inputs():
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((D, 8192)).astype(np.float32))
    logw = torch.from_numpy((2.0 * rng.standard_normal(8192)).astype(
        np.float32))
    return X, logw


def test_zero_noise_consistency(stat_inputs):
    X, logw = stat_inputs
    Xn, ll, a = _identity_step(X, logw, 0.0, 1.0, torch.Generator()
                               .manual_seed(1))
    assert torch.equal(Xn, X[:, a.long()])
    np.testing.assert_allclose(ll.numpy(), (-0.5 * (Xn ** 2).sum(0)).numpy(),
                               atol=1e-5)
    assert int((a.long() != torch.arange(8192)).sum()) > 4000


def test_offspring_track_weights_like_indexed_metropolis(stat_inputs):
    X, logw = stat_inputs
    n = X.shape[1]
    w = torch.softmax(logw.double(), 0).numpy()
    gen = torch.Generator().manual_seed(2)

    def offspring(fn, reps=30):
        tot = np.zeros(n)
        for _ in range(reps):
            tot += np.bincount(fn().numpy(), minlength=n)
        return tot / (reps * n)

    emp_fused = offspring(lambda: _identity_step(X, logw, 0.0, 1.0, gen)[2])
    emp_indexed = offspring(lambda: metropolis_ancestors(gen, logw, 10))
    err_f = np.abs(emp_fused - w).mean() / w.mean()
    err_i = np.abs(emp_indexed - w).mean() / w.mean()
    assert err_f < 1.3 * err_i + 0.05, (err_f, err_i)


def test_noise_moments():
    n = 1 << 17
    X0 = torch.zeros((D, n))
    lw0 = torch.zeros(n)
    gen = torch.Generator().manual_seed(3)
    xs = _identity_step(X0, lw0, 0.5, 0.0, gen)[0].double()
    assert abs(float(xs.mean())) < 0.01 and abs(float(xs.std()) - 0.5) < 0.02
    df = 8.0
    xt = _identity_step(X0, lw0, 0.5, 0.0, gen, noise="mvt", df=df)[0]
    vt = float(xt.double().var())
    assert abs(vt - df / (df - 2.0) * 0.25) < 0.03, vt
    xi = _identity_step(X0, lw0, 0.5, 0.0, gen, noise="mvt", df=5.0,
                        df_int=5)[0]
    assert abs(float(xi.double().var()) - 5.0 / 3.0 * 0.25) < 0.05


@pytest.fixture(scope="module")
def trace101():
    p = demo_model_params()
    ys = load_y_sim()[:101]
    _, _, loglik = kalman_filter(ys, **{k: p[k] for k in
                                        ("F", "G", "V", "W", "m0", "C0")})
    return DLM.create(device="cpu", noise="mvn", **p), ys, loglik


def test_filter_log_evidence_near_kalman(trace101):
    model, ys, zk = trace101
    zp = float(tpf.bootstrap_filter(0, model, ys, 8192, engine="pallas",
                                    return_history=False).log_evidence)
    zx = float(tpf.bootstrap_filter(0, model, ys, 8192, engine="xla",
                                    return_history=False).log_evidence)
    assert abs(zp - zk) < 0.08 * abs(zk) and abs(zp - zx) < 0.04 * abs(zk), \
        (zp, zx, zk)


# -- validation and routing ------------------------------------------------

def _step_kwargs(**over):
    X, logw, y, G, Q, F, Li = map(torch.from_numpy, _inputs())
    kw = dict(X=X, logw=logw, y=y, G=G, Q=Q, F=F, Li=Li, df=None,
              log_norm=0.0, draws=fs.fused_filter_step_draws(None, N, TILE),
              noise="mvn", num_sweeps=10, tile=TILE, df_int=None,
              num_window_tiles=2)
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    dict(tile=300),                                   # N % tile
    dict(num_sweeps=129),
    dict(df_int=31, noise="mvt", df=31.0),
    dict(df_int=0, noise="mvt", df=0.5),
    dict(num_window_tiles=4),
    dict(tile=512, num_window_tiles=3),               # N < 3 tiles
    dict(X=torch.zeros(129, N), G=torch.eye(129), Q=torch.eye(129),
         F=torch.zeros(2, 129)),
    dict(X=torch.zeros(2, N, dtype=torch.float64)),
    dict(noise="mvt", df=None),
    dict(X=torch.zeros(2, 960), logw=torch.zeros(960), tile=480),  # 128
])
def test_step_rejects_bad_arguments(over):
    with pytest.raises(ValueError):
        fs.fused_filter_step(**_step_kwargs(**over))


@pytest.mark.parametrize("noise,df,n,tile", [
    ("mvn", None, 4096, 512), ("mvn", None, 4096, 4096),
    ("mvt", 5.0, 8192, 1024), ("mvt", 1.5, 4096, 512),
    ("mvn", None, 1000, 500), ("mvn", None, 4096, 300)])
def test_eligibility_agrees_with_jax(noise, df, n, tile):
    jm = jax_model(noise, df)
    assert tpf._pallas_eligible(port_model(jm), n, tile) == \
        jpf._pallas_eligible(jm, n, tile)
    for d in (2, 8, 32, 128):
        assert fs.auto_tile(n, d) == jax_auto_tile(n, d)


def test_engine_auto_never_runs_a_fused_step(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a fused step ran")

    monkeypatch.setattr(tpf, "fused_filter_step", boom)
    monkeypatch.setattr(tpf, "fused_cdf_filter_step", boom)
    model = port_model(jax_model("mvn"))
    ys = torch.from_numpy(load_y_sim()[:6].astype(np.float32))
    for resampler in ("metropolis", "systematic", "stratified"):
        auto = tpf.bootstrap_filter(3, model, ys, 4096, resampler=resampler)
        xla = tpf.bootstrap_filter(3, model, ys, 4096, resampler=resampler,
                                   engine="xla")
        assert torch.equal(auto.particles, xla.particles)
        assert torch.equal(auto.log_evidence, xla.log_evidence)


def test_engine_pallas_routes_and_refuses():
    model = port_model(jax_model("mvt", 5.0))
    ys = torch.from_numpy(load_y_sim()[:4].astype(np.float32))
    for kw in (dict(resampler="multinomial"), dict(ess_threshold=0.5),
               dict(resampler="systematic", ess_threshold=0.5),
               dict(resampler="systematic", num_particles=1000),
               dict(num_particles=1000),
               dict(resampler_kwargs={"num_steps": "auto"})):
        n = kw.pop("num_particles", 4096)
        with pytest.raises(ValueError):
            tpf.bootstrap_filter(0, model, ys, n, engine="pallas", **kw)
    low_df = port_model(jax_model("mvt", 1.5))
    with pytest.raises(ValueError):
        tpf.bootstrap_filter(0, low_df, ys, 4096, engine="pallas")


@pytest.mark.parametrize("resampler", ["metropolis", "systematic",
                                       "stratified"])
def test_run_engine_pallas_returns_the_documented_dict(resampler):
    p = demo_model_params()
    ys = load_y_sim()[:8]
    out = cusmc_tpu_torch.run(4096, 2, 8, ys, p["m0"], p["C0"], p["F"],
                              p["G"], p["V"], p["W"], df=5.0,
                              resampler=resampler, distribution="mvt",
                              key=0, engine="pallas",
                              return_diagnostics=True, device="cpu")
    assert sorted(out) == ["ancestors", "ess", "log_evidence", "obs_loglik",
                           "posterior_x", "weights"]
    assert tuple(out["posterior_x"].shape) == (8, 4096, 2)
    assert tuple(out["weights"].shape) == (8, 4096)
    assert out["ancestors"].dtype == torch.int32
    for v in out.values():
        assert bool(torch.isfinite(v.float()).all())
    if resampler != "metropolis":
        assert bool((out["ancestors"][1:].diff(dim=1) >= 0).all())
