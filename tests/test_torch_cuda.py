"""PyTorch port, the hand-written CUDA kernels against their plain versions
on the card (marker ``cuda``; each test skips without a card).

This file imports neither jax nor cusmc_tpu, so it runs on a machine that
has only the port's dependencies; there, skip the repo's conftest (which
imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the cumsum within a worst-case float32 bound of a float64
cumsum, gamma(26 + tiles) * total with u = 2^-24 (each element passes
through at most 15 in-thread, 5 shuffle, 4 warp-offset and 2 applying
additions, one per earlier 8192-element tile and a final one), monotone,
bitwise flat over zero weights, and the same on every call; the search
and the roll walk exactly, since kernel and plain version make the same
float32 comparisons on the same numbers.
The search-only kernel, the take-columns kernel (float32 and bfloat16)
and the local-block mode exactly (the same float32 comparisons, pure
gathers). The fused steps:
ancestors exactly (the same Philox bits, the same float32
accept tests and positions), states and log-likelihoods at rtol 1e-4,
atol 1e-4 (the kernel sums its d- and k-term products in FMA chains, or
at d = k in {16, 32} in 3xTF32 tensor-core tiles, cuBLAS in its own
order; the residual y - F x cancels, and the quadratic form multiplies it
by Li). The "tile" design's statistical oracle runs here with
chip_smoke.py's functions and limits (tests/test_torch_wide_oracle.py
states them), so chip_smoke.py must sit at the root of the checkout.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from _torch_inputs import monthly_dlm, offset_clgssm, search_inputs

from cusmc_tpu_torch.io.data import demo_model_params
from cusmc_tpu_torch.ops import fused_cdf_step as fc
from cusmc_tpu_torch.ops import fused_step as fs
from cusmc_tpu_torch.ops.cumsum import FOLD, TILE, blocked_cumsum, \
    blocked_cumsum_plain
from cusmc_tpu_torch.ops.kernels import SEARCH_BLOCK
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
    inverse_cdf_apply_plain, inverse_cdf_search, inverse_cdf_search_plain, \
    take_columns, take_columns_plain
from cusmc_tpu_torch.resampling.rolls import roll_metropolis_draws, \
    roll_metropolis_sweeps_expspace, roll_metropolis_sweeps_expspace_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cumsum_bound(n, total):
    """gamma(26 + tiles) * total, u = 2^-24: csrc/cumsum.cu's worst-case
    rounding depth per element."""
    k = 26 + -(-n // TILE)
    u = 2.0 ** -24
    return k * u / (1.0 - k * u) * total


def _check_cumsum(w):
    before = blocked_cumsum.launches
    cdf, cdf128 = blocked_cumsum(w)
    assert blocked_cumsum.launches == before + 1
    plain, _ = blocked_cumsum_plain(w)
    ref = torch.cumsum(w.double(), 0)
    bound = _cumsum_bound(w.shape[0], float(ref[-1]))
    assert float((cdf.double() - ref).abs().max()) <= bound
    assert float((cdf - plain).abs().max()) <= 2 * bound
    assert bool(torch.all(cdf[1:] >= cdf[:-1]))
    # Flat over zero weights, bitwise: no inverse-CDF position falls in a
    # zero-weight particle's bin.
    zero = w == 0
    assert torch.equal(cdf[1:][zero[1:]], cdf[:-1][zero[1:]])
    if bool(zero[0]):
        assert float(cdf[0]) == 0.0
    assert torch.equal(cdf128, cdf[FOLD - 1::FOLD])
    assert torch.equal(blocked_cumsum(w)[0], cdf)  # the same every call


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 1 << 20, 1_000_003])
def test_cuda_cumsum_kernel(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    w = torch.rand(n, generator=gen, device=cuda)
    w[::7] = 0.0
    _check_cumsum(w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 5, TILE - 1, TILE + 1, 3 * TILE + 7,
                               1_000_003, 1 << 20])
def test_cuda_cumsum_kernel_adversarial(cuda, n):
    # Magnitudes over 2^40, zero runs longer than a tile that cross tile
    # edges, a heavy head; and a view 4 bytes off 16-byte alignment.
    gen = torch.Generator(device=cuda).manual_seed(n)
    e = torch.randint(-40, 1, (n + 1,), generator=gen, device=cuda)
    w = torch.exp2(e.float()) * torch.rand(n + 1, generator=gen, device=cuda)
    i = torch.arange(n + 1, device=cuda)
    w[(i % 12288) >= 3288] = 0.0
    w[:3] = 1.0
    _check_cumsum(w[:n])
    _check_cumsum(w[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sv-lookahead", "gaussian-0.001",
                                    "uniform-half-zero"])
def test_cuda_cumsum_kernel_flat_over_zero_weights(cuda, family):
    # The three families of chip_smoke.zero_weight_families at N = 2^20;
    # then no systematic ancestor through the kernel's cdf on a particle
    # of zero weight (a position clipped at the total is the reference's
    # own law and is not counted).
    import chip_smoke

    w = chip_smoke.zero_weight_families(1 << 20, cuda)[family]
    _check_cumsum(w)
    cdf, _ = blocked_cumsum(w)
    X = torch.zeros((2, w.shape[0]), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for _ in range(8):
        u = torch.rand((), generator=gen, device=cuda)
        pos = (torch.arange(w.shape[0], device=cuda) + u) / w.shape[0]
        _, a = inverse_cdf_apply(cdf, pos * cdf[-1], X)
        assert chip_smoke.zero_ancestors(w, cdf, u, a)[0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "concentrated", "zero-runs"])
def test_cuda_search_kernel(cuda, case):
    cdf, pos, X = (torch.from_numpy(a).to(cuda) for a in search_inputs(
        np.random.default_rng(11), case, 1 << 16, 2))
    before = inverse_cdf_apply.launches
    y, a = inverse_cdf_apply(cdf, pos, X)
    assert inverse_cdf_apply.launches == before + 1
    y_p, a_p = inverse_cdf_apply_plain(cdf, pos, X)
    assert torch.equal(a, a_p) and torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "concentrated", "zero-runs"])
@pytest.mark.parametrize("nq_div", [1, 4, 16])
@pytest.mark.parametrize("queries", ["sorted", "shuffled", "short",
                                     "ragged"])
def test_cuda_search_only_kernel(cuda, case, nq_div, queries):
    # L = N / nq_div sorted queries; shuffled (every block's stretch is the
    # whole cdf: the wide-block branch); fewer than a block of SEARCH_BLOCK
    # queries; a ragged last block. At nq_div = 16 (and in some zero-run
    # blocks at 4) a block spans more than the SEARCH_WINDOW-float window.
    n = 1 << 16
    cdf, pos, _ = (torch.from_numpy(a).to(cuda) for a in search_inputs(
        np.random.default_rng(5), case, n, 1))
    pos = pos[::nq_div]
    if queries == "shuffled":
        gen = torch.Generator(device=cuda).manual_seed(nq_div)
        pos = pos[torch.randperm(pos.shape[0], generator=gen, device=cuda)]
    elif queries == "short":
        pos = pos[:SEARCH_BLOCK // 2 + 44]
    elif queries == "ragged":
        pos = pos[:3 * SEARCH_BLOCK + 77]
    pos = pos.contiguous()
    before = inverse_cdf_search.launches
    a = inverse_cdf_search(cdf, pos)
    assert inverse_cdf_search.launches == before + 1
    assert torch.equal(a, inverse_cdf_search_plain(cdf, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["exp", "concentrated", "zero-runs",
                                  "shuffled"])
@pytest.mark.parametrize("mode", ["global", "local"])
@pytest.mark.parametrize("d", [2, 32])
def test_cuda_search_and_apply_kernel(cuda, d, mode, case):
    # The block-window search, then the d-row gather: the global mode on a
    # ragged count of queries (L = N - 333) and the local-block mode at the
    # shard shapes of a 4-way split (L = N/4 at base p N/4); exp,
    # concentrated and zero-run weights on sorted queries, and exp weights
    # on shuffled ones (every block's stretch is the whole cdf).
    n = 1 << 16
    weights = "uniform" if case in ("exp", "shuffled") else case
    cdf, pos, X = (torch.from_numpy(a).to(cuda) for a in search_inputs(
        np.random.default_rng(17), weights, n, d))
    if case == "shuffled":
        gen = torch.Generator(device=cuda).manual_seed(d)
        pos = pos[torch.randperm(n, generator=gen, device=cuda)].contiguous()
    L = n // 4
    shards = [(None, pos[:n - 333], X)] if mode == "global" else [
        (p * L, pos[p * L:(p + 1) * L].contiguous(),
         X[:, p * L:(p + 1) * L].contiguous()) for p in range(4)]
    for base, q, blk in shards:
        before = (inverse_cdf_apply.launches, inverse_cdf_apply.local_launches)
        y, a = inverse_cdf_apply(cdf, q, blk, local_base=base)
        assert (inverse_cdf_apply.launches - before[0],
                inverse_cdf_apply.local_launches - before[1]) == \
            ((1, 0) if base is None else (0, 1))
        y_p, a_p = inverse_cdf_apply_plain(cdf, q, blk, local_base=base)
        assert torch.equal(a, a_p) and torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sorted", "concentrated", "shuffled",
                                  "out-of-range"])
def test_cuda_take_columns_kernel(cuda, kind):
    n, d = 1 << 16, 3
    gen = torch.Generator(device=cuda).manual_seed(7)
    X = torch.randn((d, n), generator=gen, device=cuda)
    a = torch.randint(0, n, (n,), generator=gen, device=cuda)
    if kind == "sorted":
        a = torch.sort(a).values
    elif kind == "concentrated":
        a = torch.sort(a % 5).values
    elif kind == "out-of-range":
        a = a - n // 2 + (a % 3) * n
    a = a.to(torch.int32)
    before = take_columns.launches
    out = take_columns(X, a)
    assert take_columns.launches == before + 1
    assert torch.equal(out, take_columns_plain(X, a))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 32])
@pytest.mark.parametrize("kind", ["sorted", "shuffled", "clipped"])
def test_cuda_bf16_take_columns_kernel(cuda, d, kind):
    # The bfloat16 gather: bitwise the plain version's, counted apart.
    n = 1 << 16
    gen = torch.Generator(device=cuda).manual_seed(d)
    X = torch.randn((d, n), generator=gen, device=cuda).to(torch.bfloat16)
    a = torch.randint(0, n, (n,), generator=gen, device=cuda)
    if kind == "sorted":
        a = torch.sort(a).values
    elif kind == "clipped":
        a = a - n // 2 + (a % 3) * n
    a = a.to(torch.int32)
    before = (take_columns.launches, take_columns.bf16_launches)
    out = take_columns(X, a)
    assert (take_columns.launches, take_columns.bf16_launches) == \
        (before[0], before[1] + 1)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16),
                       take_columns_plain(X, a).view(torch.int16))


@pytest.mark.cuda
def test_cuda_generic_packed_path_launches_its_kernels(cuda):
    # The generic step (debug_checks=True, or a key outside the fast ops)
    # on the card: one roll, cumsum + search-and-apply, or take-columns
    # launch a step.
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.resampling import RESAMPLERS, register_resampler
    from cusmc_tpu_torch.resampling.metropolis import metropolis_ancestors
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    model = DLM.create(noise="mvt", df=5.0, device=cuda,
                       **demo_model_params())
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, ys = model.simulate(gen, 20)
    register_resampler("metropolis_indexed", metropolis_ancestors)
    try:
        for resampler, counter in (
                ("metropolis", (roll_metropolis_sweeps_expspace,
                                "launches")),
                ("systematic", (inverse_cdf_apply, "launches")),
                ("metropolis_indexed", (take_columns, "launches"))):
            fn, attr = counter
            before = getattr(fn, attr)
            res = bootstrap_filter(0, model, ys, 1 << 14, resampler=resampler,
                                   debug_checks=True)
            assert getattr(fn, attr) - before == 19, resampler
            assert res.particles.is_cuda
            assert bool(torch.isfinite(res.log_evidence))
    finally:
        RESAMPLERS.pop("metropolis_indexed")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "concentrated"])
def test_cuda_search_kernel_local_block(cuda, case):
    n, d = 1 << 16, 2
    cdf, pos, X = (torch.from_numpy(a).to(cuda) for a in search_inputs(
        np.random.default_rng(3), case, n, d))
    L = n // 4
    for p in range(4):
        base = p * L
        q = pos[base:base + L].contiguous()
        blk = X[:, base:base + L].contiguous()
        before = (inverse_cdf_apply.launches, inverse_cdf_apply.local_launches)
        y, a = inverse_cdf_apply(cdf, q, blk, local_base=base)
        assert (inverse_cdf_apply.launches,
                inverse_cdf_apply.local_launches) == (before[0],
                                                      before[1] + 1)
        y_p, a_p = inverse_cdf_apply_plain(cdf, q, blk, local_base=base)
        assert torch.equal(a, a_p) and torch.equal(y, y_p)
        hit = (a >= base) & (a < base + L)
        assert torch.equal(y[:, hit], X[:, a[hit].long()])


@pytest.mark.cuda
def test_cuda_roll_kernel(cuda):
    n = 1_000_003
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.exp(-25.0 * torch.randn(n, generator=gen, device=cuda) ** 2)
    X = torch.randn((2, n), generator=gen, device=cuda)
    shifts, u = roll_metropolis_draws(gen, n, 10, cuda)
    before = roll_metropolis_sweeps_expspace.launches
    y, a = roll_metropolis_sweeps_expspace(w, shifts, u, X)
    assert roll_metropolis_sweeps_expspace.launches == before + 1
    y_p, a_p = roll_metropolis_sweeps_expspace_plain(w, shifts, u, X)
    assert torch.equal(a, a_p) and torch.equal(y, y_p)


@pytest.mark.cuda
def test_cuda_wrappers_check_their_arguments(cuda):
    with pytest.raises(TypeError):
        blocked_cumsum(torch.ones(8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        blocked_cumsum(torch.ones(16, device=cuda)[::2])
    cdf = torch.arange(1.0, 9.0, device=cuda)
    with pytest.raises(ValueError):
        inverse_cdf_apply(cdf, cdf, torch.ones(2, 9, device=cuda))
    with pytest.raises(ValueError):
        inverse_cdf_apply(cdf, cdf.cpu(), torch.ones(2, 8, device=cuda))


_ONE_RANK = """
import sys, tempfile, torch
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \\
    inverse_cdf_search, take_columns
from cusmc_tpu_torch.parallel import ParticleAxis, initialize_distributed, \\
    sharded_bootstrap_filter
from cusmc_tpu_torch.resampling.rolls import roll_metropolis_sweeps_expspace
import torch.distributed as dist
with tempfile.TemporaryDirectory() as tmp:
    initialize_distributed(f"file://{tmp}/store", 1, 0)
    assert dist.get_backend() == "nccl"
    axis = ParticleAxis()
    model = DLM.create(noise="mvn", device="cuda", **demo_model_params())
    ys = load_y_sim()[:50]
    for r, count in (("systematic", lambda: inverse_cdf_apply.local_launches),
                     ("residual", lambda: (inverse_cdf_search.launches,
                                           take_columns.launches)),
                     ("metropolis",
                      lambda: roll_metropolis_sweeps_expspace.launches)):
        before = count()
        res = sharded_bootstrap_filter(0, model, ys, 1 << 14, axis,
                                       resampler=r)
        assert res.final_particles.is_cuda
        assert bool(torch.isfinite(res.log_evidence))
        print(r, before, count(), float(res.log_evidence))
    dist.destroy_process_group()
print("ok")
"""


@pytest.mark.cuda
def test_cuda_sharded_filter_on_a_one_rank_nccl_group(cuda):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _ONE_RANK], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.split("\n")
    assert lines[-2] == "ok"
    sysl, res, met = lines[:3]
    assert int(sysl.split()[2]) - int(sysl.split()[1]) == 49
    assert "(0, 0) (98, 49)" in res
    assert int(met.split()[2]) - int(met.split()[1]) == 49


@pytest.mark.cuda
def test_cuda_residual_run_through_the_kernels(cuda):
    import cusmc_tpu_torch
    from cusmc_tpu_torch.io.data import load_y_sim

    p = demo_model_params()
    ys = load_y_sim()[:50]
    before = [f.launches for f in (blocked_cumsum, inverse_cdf_apply)]
    out = cusmc_tpu_torch.run(4096, 2, 50, ys, p["m0"], p["C0"], p["F"],
                              p["G"], p["V"], p["W"], resampler="residual",
                              key=0, device=cuda)
    assert bool(torch.isfinite(out["log_evidence"]))
    # Three cumsums a step (the floor grid, the remainders and the
    # remainder draws' exponential spacings) and two searches.
    assert [f.launches - b for f, b in zip(
        (blocked_cumsum, inverse_cdf_apply), before)] == [147, 98]


@pytest.mark.cuda
def test_cuda_filter_runs_through_the_kernels(cuda):
    import cusmc_tpu_torch
    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim

    p = demo_model_params()
    ys = load_y_sim()[:50]
    for resampler, wrappers in (
            ("metropolis", (roll_metropolis_sweeps_expspace,)),
            ("systematic", (blocked_cumsum, inverse_cdf_apply))):
        before = [f.launches for f in wrappers]
        out = cusmc_tpu_torch.run(4096, 2, 50, ys, p["m0"], p["C0"], p["F"],
                                  p["G"], p["V"], p["W"], df=5.0,
                                  resampler=resampler, distribution="mvt",
                                  key=0, device=cuda)
        assert out["posterior_x"].is_cuda
        assert bool(torch.isfinite(out["log_evidence"]))
        assert [f.launches - b for f, b in zip(wrappers, before)] == \
            [49] * len(wrappers)


def _model_args(d, cuda, noise, df):
    """(G, Q, F, Li, y, df, log_norm, df_int) of the demo DLM of width d."""
    from cusmc_tpu_torch.models.dlm import DLM

    m = DLM.create(noise=noise, df=df, device=cuda, **demo_model_params(d))
    mats = tuple(t.contiguous() for t in (m.G, m.W_sqrt, m.F, m.V_chol_inv))
    y = torch.full((d,), 0.05, device=cuda)
    return mats, y, (df if noise == "mvt" else None), float(m.log_norm), \
        m.df_int


def _close(ours, plain):
    torch.testing.assert_close(ours, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d,noise,df,wt", [
    (2, "mvn", None, 2), (2, "mvt", 5.0, 2), (2, "mvt", 5.5, 3),
    (32, "mvt", 5.0, 2), (5, "mvn", None, 2), (16, "mvn", None, 2),
    (16, "mvt", 5.0, 3), (16, "mvt", 5.5, 2), (32, "mvn", None, 3),
    (32, "mvt", 5.5, 3)])
def test_cuda_fused_step_kernel(cuda, d, noise, df, wt):
    n, tile = 1 << 16, 2048
    gen = torch.Generator(device=cuda).manual_seed(d)
    X = 0.1 * torch.randn((d, n), generator=gen, device=cuda)
    logw = -5.0 * torch.rand(n, generator=gen, device=cuda)
    (G, Q, F, Li), y, df_, log_norm, df_int = _model_args(d, cuda, noise, df)
    draws = fs.fused_filter_step_draws(gen, n, tile, cuda)
    kw = dict(noise=noise, num_sweeps=10, tile=tile, df_int=df_int,
              num_window_tiles=wt)
    before = fs.fused_filter_step.launches
    x, ll, a = fs.fused_filter_step(X, logw, y, G, Q, F, Li, df_, log_norm,
                                    draws, **kw)
    assert fs.fused_filter_step.launches == before + 1
    assert fs.step_path(d, d) == ("tile" if d in (16, 32) else "thread")
    x_p, ll_p, a_p = fs.fused_filter_step_plain(X, logw, y, G, Q, F, Li,
                                                df_, log_norm, draws, **kw)
    assert torch.equal(a, a_p)
    _close(x, x_p)
    _close(ll, ll_p)


@pytest.mark.cuda
@pytest.mark.parametrize("d,mode,noise,df,n", [
    (2, "systematic", "mvt", 5.0, 1 << 16),
    (2, "stratified", "mvn", None, 1 << 16),
    (32, "systematic", "mvt", 5.0, 63 * 1024),
    (5, "stratified", "mvt", 5.0, 1 << 16),
    (16, "systematic", "mvn", None, 1 << 16),
    (16, "stratified", "mvt", 5.0, 63 * 1024),
    (16, "systematic", "mvt", 5.5, 63 * 1024),
    (16, "stratified", "mvt", 5.5, 1 << 16),
    (32, "systematic", "mvt", 5.5, 1 << 16),
    (32, "stratified", "mvn", None, 63 * 1024),
    (32, "stratified", "mvt", 5.0, 1 << 16),
    (32, "systematic", "mvn", None, 1 << 16)])
def test_cuda_fused_cdf_kernel(cuda, d, mode, noise, df, n):
    gen = torch.Generator(device=cuda).manual_seed(d)
    X = 0.1 * torch.randn((d, n), generator=gen, device=cuda)
    w = torch.exp(-5.0 * torch.rand(n, generator=gen, device=cuda))
    cdf, _ = blocked_cumsum(w)
    (G, Q, F, Li), y, df_, log_norm, df_int = _model_args(d, cuda, noise, df)
    draws = fc.fused_cdf_filter_step_draws(gen, cuda)
    kw = dict(noise=noise, mode=mode, df_int=df_int)
    before = fc.fused_cdf_filter_step.launches
    x, ll, a = fc.fused_cdf_filter_step(cdf, X, y, G, Q, F, Li, df_,
                                        log_norm, draws, **kw)
    assert fc.fused_cdf_filter_step.launches == before + 1
    assert fs.step_path(d, d) == ("tile" if d in (16, 32) else "thread")
    x_p, ll_p, a_p = fc.fused_cdf_filter_step_plain(
        cdf, X, y, G, Q, F, Li, df_, log_norm, draws, **kw)
    assert torch.equal(a, a_p)
    _close(x, x_p)
    _close(ll, ll_p)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("kind", ["metropolis", "cdf"])
def test_cuda_tile_oracle_moments(cuda, kind, d):
    # chip_smoke.py's checks 1-3 of the "tile" design on the kernel, at
    # m = 2^17: a dense G without noise, then the noise law (MVN and MVT)
    # and its independence across particles, tiles and calls.
    import chip_smoke as cs

    assert fs.step_path(d, d) == "tile"
    gen = torch.Generator(device=cuda).manual_seed(d)
    m = 1 << 17
    assert cs.oracle_zero_noise(kind, d, m, gen, cuda) <= cs.ZERO_NOISE_RTOL
    for noise in ("mvn", "mvt"):
        res = cs.oracle_noise(kind, d, m, gen, cuda, noise)
        assert [(k, v) for k, v in res if v >= cs.ORACLE_SE] == [], noise


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
def test_cuda_tile_oracle_log_evidence(cuda, d):
    # chip_smoke.py's check 4: the conditioned model at N = 2^20, T = 101,
    # 4 seeds a path, both engines and resamplers, in the bands that
    # chip_smoke.py states.
    import chip_smoke as cs

    z, zk = cs.oracle_logz(d, 1 << 20, cs.ORACLE_SEEDS, cuda)
    for name, detail, ok in cs.logz_checks(z, zk, cs.ORACLE_BANDS[d]):
        assert ok, f"{name}: {detail}"


@pytest.mark.cuda
def test_cuda_pallas_engine_runs_through_the_fused_kernels(cuda):
    import cusmc_tpu_torch
    from cusmc_tpu_torch.io.data import load_y_sim

    p = demo_model_params()
    ys = load_y_sim()[:50]
    for resampler, fused in (("metropolis", fs.fused_filter_step),
                             ("systematic", fc.fused_cdf_filter_step),
                             ("stratified", fc.fused_cdf_filter_step)):
        before = fused.launches
        composed = [f.launches for f in (inverse_cdf_apply,
                                         roll_metropolis_sweeps_expspace)]
        out = cusmc_tpu_torch.run(8192, 2, 50, ys, p["m0"], p["C0"], p["F"],
                                  p["G"], p["V"], p["W"], df=5.0,
                                  resampler=resampler, distribution="mvt",
                                  key=0, engine="pallas", device=cuda)
        assert out["posterior_x"].is_cuda
        assert bool(torch.isfinite(out["log_evidence"]))
        assert fused.launches - before == 49
        assert [f.launches for f in (inverse_cdf_apply,
                                     roll_metropolis_sweeps_expspace)] == \
            composed


# -- a bfloat16 state (mixed precision) ---------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 32])
def test_cuda_bf16_roll_and_search_and_apply_kernels(cuda, d):
    # The bfloat16 gathers: the float32 run's ancestors, values exactly the
    # plain version's, each launch counted apart from the float32 ones.
    n = 1_000_003
    gen = torch.Generator(device=cuda).manual_seed(d)
    w = torch.exp(-25.0 * torch.randn(n, generator=gen, device=cuda) ** 2)
    X32 = torch.randn((d, n), generator=gen, device=cuda)
    X = X32.to(torch.bfloat16)
    shifts, u = roll_metropolis_draws(gen, n, 10, cuda)
    before = (roll_metropolis_sweeps_expspace.launches,
              roll_metropolis_sweeps_expspace.bf16_launches)
    y, a = roll_metropolis_sweeps_expspace(w, shifts, u, X)
    assert (roll_metropolis_sweeps_expspace.launches,
            roll_metropolis_sweeps_expspace.bf16_launches) == \
        (before[0], before[1] + 1)
    y_p, a_p = roll_metropolis_sweeps_expspace_plain(w, shifts, u, X)
    assert torch.equal(a, a_p) and torch.equal(y, y_p)
    assert torch.equal(a, roll_metropolis_sweeps_expspace(w, shifts, u,
                                                          X32)[1])
    cdf, _ = blocked_cumsum(w)
    pos = (torch.arange(n, device=cuda, dtype=torch.float32) + 0.5) / n \
        * cdf[-1]
    before = inverse_cdf_apply.bf16_launches
    y, a = inverse_cdf_apply(cdf, pos, X)
    assert inverse_cdf_apply.bf16_launches == before + 1
    y_p, a_p = inverse_cdf_apply_plain(cdf, pos, X)
    assert torch.equal(a, a_p) and torch.equal(y, y_p)
    L = n // 4
    q, Xl = pos[L:2 * L].contiguous(), X[:, L:2 * L].contiguous()
    before = inverse_cdf_apply.bf16_local_launches
    y, a = inverse_cdf_apply(cdf, q, Xl, local_base=L)
    assert inverse_cdf_apply.bf16_local_launches == before + 1
    y_p, a_p = inverse_cdf_apply_plain(cdf, q, Xl, local_base=L)
    assert torch.equal(a, a_p) and torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("d,noise,df", [
    (2, "mvn", None), (2, "mvt", 5.0), (4, "mvt", 5.5), (6, "mvn", None),
    (16, "mvn", None), (16, "mvt", 5.0), (32, "mvt", 5.0),
    (32, "mvt", 5.5)])
def test_cuda_bf16_fused_step_kernel(cuda, d, noise, df):
    # The fused Metropolis step on a bfloat16 state: the float32 kernel's
    # ancestors, and chip_smoke.py's rule for the states (bitwise but for
    # a 1-ulp mismatch at a rounding boundary) and ll (1e-4 where the
    # states agree).
    import chip_smoke as cs
    from cusmc_tpu_torch.models.dlm import DLM

    n, tile = 1 << 16, 2048
    gen = torch.Generator(device=cuda).manual_seed(d)
    m = DLM.create(noise=noise, df=df, device=cuda,
                   state_dtype=torch.bfloat16, **demo_model_params(d))
    G, Q, F, Li = (t.contiguous() for t in (m.G, m.W_sqrt, m.F,
                                            m.V_chol_inv))
    X32 = 0.1 * torch.randn((d, n), generator=gen, device=cuda)
    X = X32.to(torch.bfloat16)
    logw = -5.0 * torch.rand(n, generator=gen, device=cuda)
    y = torch.full((d,), 0.05, device=cuda)
    draws = fs.fused_filter_step_draws(gen, n, tile, cuda)
    args = (logw, y, G, Q, F, Li, df, float(m.log_norm), draws)
    kw = dict(noise=noise, num_sweeps=10, tile=tile, df_int=m.df_int)
    before = (fs.fused_filter_step.launches, fs.fused_filter_step.bf16_launches)
    x, ll, a = fs.fused_filter_step(X, *args, **kw)
    assert (fs.fused_filter_step.launches,
            fs.fused_filter_step.bf16_launches) == (before[0], before[1] + 1)
    assert x.dtype == torch.bfloat16 and ll.dtype == torch.float32
    x_p, ll_p, a_p, x_pre = fs.fused_filter_step_plain(X, *args, **kw,
                                                       pre_rounding=True)
    assert torch.equal(a, a_p)
    (G32, Q32, F32, Li32), _, _, _, _ = _model_args(d, cuda, noise, df)
    _, _, a32 = fs.fused_filter_step(X32, logw, y, G32, Q32, F32, Li32,
                                     *args[6:], **kw)
    assert torch.equal(a, a32)
    diff, _ = cs.bf16_state_mismatches(x, x_p, x_pre)
    same = diff.logical_not().all(0)
    _close(ll[same], ll_p[same])


@pytest.mark.cuda
@pytest.mark.parametrize("resampler", ["metropolis", "systematic"])
def test_cuda_streaming_launches_its_kernels(cuda, resampler):
    # The streaming filter runs the one-shot filter's steps on the card:
    # one roll, or one cumsum and one search-and-apply, launch a step, and
    # the streamed run and its history equal the one-shot run bitwise.
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter
    from cusmc_tpu_torch.smc.streaming import streaming_bootstrap_filter

    model = DLM.create(noise="mvt", df=5.0, device=cuda,
                       **demo_model_params())
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, ys = model.simulate(gen, 41)
    counters = ([roll_metropolis_sweeps_expspace]
                if resampler == "metropolis"
                else [blocked_cumsum, inverse_cdf_apply])
    before = [fn.launches for fn in counters]
    res, store = streaming_bootstrap_filter(0, model, ys, 1 << 14,
                                            chunk_steps=16,
                                            resampler=resampler)
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [40] * len(counters)
    one = bootstrap_filter(0, model, ys, 1 << 14, resampler=resampler)
    assert torch.equal(res.final_particles, one.final_particles)
    assert torch.equal(res.log_evidence, one.log_evidence)
    assert torch.equal(res.ess, one.ess)
    np.testing.assert_array_equal(store.view(), one.particles.cpu().numpy())


@pytest.mark.cuda
def test_cuda_generator_state_round_trip(cuda):
    # A CUDA generator's state (Philox seed and offset) restores the same
    # stream: what a snapshot of a run on the card holds.
    from cusmc_tpu_torch.utils.rng import generator_state, \
        set_generator_state

    gen = torch.Generator(device=cuda).manual_seed(3)
    torch.rand(10, generator=gen, device=cuda)
    state = generator_state(gen)
    assert state.size == 16
    want = torch.rand(5, generator=gen, device=cuda)
    other = torch.Generator(device=cuda).manual_seed(9)
    set_generator_state(other, state)
    assert torch.equal(torch.rand(5, generator=other, device=cuda), want)


# -- the widths of the other models: d = 1 and the monthly DLM -----------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 13])
@pytest.mark.parametrize("case", ["uniform", "concentrated", "zero-runs"])
def test_cuda_search_and_roll_at_model_widths(cuda, case, d):
    # The stochastic volatility model and UNGM (d = 1) and the monthly
    # structural DLM (d = 13) on the composed path: the search-and-apply
    # and the roll walk, exactly their plain versions.
    n = 1 << 16
    cdf, pos, X = (torch.from_numpy(a).to(cuda) for a in search_inputs(
        np.random.default_rng(d), case, n, d))
    y, a = inverse_cdf_apply(cdf, pos, X)
    y_p, a_p = inverse_cdf_apply_plain(cdf, pos, X)
    assert torch.equal(a, a_p) and torch.equal(y, y_p)
    gen = torch.Generator(device=cuda).manual_seed(d)
    w = torch.diff(cdf, prepend=cdf[:1] * 0)
    shifts, u = roll_metropolis_draws(gen, n, 10, cuda)
    y, a = roll_metropolis_sweeps_expspace(w, shifts, u, X)
    y_p, a_p = roll_metropolis_sweeps_expspace_plain(w, shifts, u, X)
    assert torch.equal(a, a_p) and torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["metropolis", "systematic", "stratified"])
@pytest.mark.parametrize("noise", ["mvn", "mvt"])
def test_cuda_fused_kernels_at_d13_k1(cuda, kind, noise):
    # The fused kernels' runtime-width "thread" template (launch<0, 0>)
    # on the monthly DLM, d = 13, k = 1: ancestors exactly, states and
    # log-likelihoods at rtol 1e-4, atol 1e-4, as at the other widths.
    m = monthly_dlm(cuda, noise)
    n = 1 << 16
    gen = torch.Generator(device=cuda).manual_seed(13)
    X = 0.1 * torch.randn((13, n), generator=gen, device=cuda)
    logw = -5.0 * torch.rand(n, generator=gen, device=cuda)
    mats = tuple(t.contiguous() for t in (m.G, m.W_sqrt, m.F, m.V_chol_inv))
    y = torch.full((1,), 0.05, device=cuda)
    df = 5.0 if noise == "mvt" else None
    assert fs.step_path(13, 1) == "thread"
    if kind == "metropolis":
        draws = fs.fused_filter_step_draws(gen, n, 2048, cuda)
        kw = dict(noise=noise, num_sweeps=10, tile=2048, df_int=m.df_int,
                  num_window_tiles=2)
        args = (X, logw, y, *mats, df, float(m.log_norm), draws)
        out = fs.fused_filter_step(*args, **kw)
        plain = fs.fused_filter_step_plain(*args, **kw)
    else:
        cdf, _ = blocked_cumsum(torch.exp(logw))
        draws = fc.fused_cdf_filter_step_draws(gen, cuda)
        kw = dict(noise=noise, mode=kind, df_int=m.df_int)
        args = (cdf, X, y, *mats, df, float(m.log_norm), draws)
        out = fc.fused_cdf_filter_step(*args, **kw)
        plain = fc.fused_cdf_filter_step_plain(*args, **kw)
    assert torch.equal(out[2], plain[2])
    _close(out[0], plain[0])
    _close(out[1], plain[1])


@pytest.mark.cuda
def test_cuda_models_run_through_their_kernels(cuda):
    # The stochastic volatility model and UNGM on the packed fast step
    # (d = 1) and the monthly DLM on both engines (d = 13, k = 1): each
    # run launches its kernels T-1 times.
    from cusmc_tpu_torch.models import StochasticVolatility, UNGM
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    gen = torch.Generator(device=cuda).manual_seed(0)
    sv, ungm, monthly = (StochasticVolatility.create(device=cuda),
                         UNGM.create(device=cuda), monthly_dlm(cuda))
    runs = [(sv, "metropolis", "xla", (roll_metropolis_sweeps_expspace,)),
            (sv, "systematic", "xla", (blocked_cumsum, inverse_cdf_apply)),
            (ungm, "systematic", "xla", (blocked_cumsum, inverse_cdf_apply)),
            (monthly, "metropolis", "pallas", (fs.fused_filter_step,)),
            (monthly, "systematic", "pallas", (fc.fused_cdf_filter_step,))]
    for model, resampler, engine, wrappers in runs:
        _, ys = model.simulate(gen, 20)
        before = [f.launches for f in wrappers]
        res = bootstrap_filter(0, model, ys, 1 << 16, resampler=resampler,
                               engine=engine, return_history=False)
        assert bool(torch.isfinite(res.log_evidence))
        assert [f.launches - b for f, b in zip(wrappers, before)] == \
            [19] * len(wrappers)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 16384])
def test_cuda_rbpf_general_bank_step_matches_the_shared_one(cuda, n):
    # One step of the general bank (vmapped matrices; batched library
    # factor and solves over [n, 2, 2]) on particles sharing one
    # covariance, against the shared-covariance step: means, covariances
    # and log-likelihoods at rtol 1e-5, atol 1e-5.
    from cusmc_tpu_torch.smc import rbpf

    gen = torch.Generator(device=cuda).manual_seed(n)
    u = torch.randn((n, 1), generator=gen, device=cuda)
    m = torch.randn((n, 2), generator=gen, device=cuda)
    A = 0.3 * torch.randn((2, 2), generator=gen, device=cuda)
    P = A @ A.T + 0.1 * torch.eye(2, device=cuda)
    y = torch.tensor([0.3, -0.2], device=cuda)
    general = rbpf._kf_general(offset_clgssm(cuda, False), y, u, m,
                               P.expand(n, 2, 2))
    shared = rbpf._kf_constant(offset_clgssm(cuda, True), y, u, m, P)
    for ours, theirs in zip(general, shared):
        torch.testing.assert_close(ours, theirs.expand_as(ours), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["systematic", "stratified", "multinomial",
                                  "residual"])
def test_cuda_registry_resamplers_skip_zero_weights(cuda, name):
    # The registry's cdf (resampling.classic.weight_cdf) on the card: in
    # float32, torch.cumsum's parallel scan stepped up by an ulp over
    # zero weights and the search gave those particles ancestors. The
    # weights are the stochastic volatility lookahead at y = 3, about
    # 6000 of them zero in float32.
    from cusmc_tpu_torch.resampling import get_resampler

    n = 1 << 20
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = -1.0 + torch.randn(n, generator=gen, device=cuda)
    logw = torch.log_softmax(-0.5 * (x + 9.0 * torch.exp(-x)), 0)
    w = torch.softmax(logw, 0)
    assert int((w == 0).sum()) > 1000
    for _ in range(5):
        a = get_resampler(name)(gen, logw).long()
        assert bool((w[a] > 0).all()), int((w[a] == 0).sum())
