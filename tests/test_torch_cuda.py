"""PyTorch port, the hand-written CUDA kernels against their plain versions
on the card (marker ``cuda``; each test skips without a card).

This file imports neither jax nor cusmc_tpu, so it runs on a machine that
has only the port's dependencies; there, skip the repo's conftest (which
imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the cumsum within a worst-case float32 bound of a float64
cumsum, (25 + tiles) * eps * total (each element passes through at most
16 in-thread, 8 shuffle and one tile-offset additions plus one per earlier
tile), and monotone; the search and the roll walk exactly, since kernel
and plain version make the same float32 comparisons on the same numbers.
The search-only kernel, the take-columns kernel and the local-block mode
exactly (the same float32 comparisons, pure gathers). The fused steps:
ancestors exactly (the same Philox bits, the same float32
accept tests and positions), states and log-likelihoods at rtol 1e-4,
atol 1e-4 (the kernel sums its d- and k-term products in FMA chains,
cuBLAS in its own order; the residual y - F x cancels, and the quadratic
form multiplies it by Li).
"""

import numpy as np
import pytest
import torch

from _torch_inputs import search_inputs

from cusmc_tpu_torch.io.data import demo_model_params
from cusmc_tpu_torch.ops import fused_cdf_step as fc
from cusmc_tpu_torch.ops import fused_step as fs
from cusmc_tpu_torch.ops.cumsum import FOLD, blocked_cumsum, \
    blocked_cumsum_plain
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 1 << 20, 1_000_003])
def test_cuda_cumsum_kernel(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    w = torch.rand(n, generator=gen, device=cuda)
    w[::7] = 0.0
    before = blocked_cumsum.launches
    cdf, cdf128 = blocked_cumsum(w)
    assert blocked_cumsum.launches == before + 1
    plain, _ = blocked_cumsum_plain(w)
    ref = torch.cumsum(w.double(), 0)
    tiles = -(-n // 4096)
    bound = (25 + tiles) * torch.finfo(torch.float32).eps * float(ref[-1])
    assert float((cdf.double() - ref).abs().max()) <= bound
    assert float((cdf - plain).abs().max()) <= 2 * bound
    assert bool(torch.all(cdf[1:] >= cdf[:-1]))
    assert torch.equal(cdf128, cdf[FOLD - 1::FOLD])


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
@pytest.mark.parametrize("nq_div", [1, 4])
def test_cuda_search_only_kernel(cuda, case, nq_div):
    n = 1 << 16
    cdf, pos, _ = (torch.from_numpy(a).to(cuda) for a in search_inputs(
        np.random.default_rng(5), case, n, 1))
    pos = pos[::nq_div].contiguous()  # L = N / nq_div queries
    before = inverse_cdf_search.launches
    a = inverse_cdf_search(cdf, pos)
    assert inverse_cdf_search.launches == before + 1
    assert torch.equal(a, inverse_cdf_search_plain(cdf, pos))


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
    # Two cumsums and two searches a step: the floor grid and remainders.
    assert [f.launches - b for f, b in zip(
        (blocked_cumsum, inverse_cdf_apply), before)] == [98, 98]


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
    (32, "mvt", 5.0, 2), (5, "mvn", None, 2)])
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
    x_p, ll_p, a_p = fs.fused_filter_step_plain(X, logw, y, G, Q, F, Li,
                                                df_, log_norm, draws, **kw)
    assert torch.equal(a, a_p)
    _close(x, x_p)
    _close(ll, ll_p)


@pytest.mark.cuda
@pytest.mark.parametrize("d,mode,noise,n", [
    (2, "systematic", "mvt", 1 << 16), (2, "stratified", "mvn", 1 << 16),
    (32, "systematic", "mvt", 63 * 1024), (5, "stratified", "mvt", 1 << 16)])
def test_cuda_fused_cdf_kernel(cuda, d, mode, noise, n):
    gen = torch.Generator(device=cuda).manual_seed(d)
    X = 0.1 * torch.randn((d, n), generator=gen, device=cuda)
    w = torch.exp(-5.0 * torch.rand(n, generator=gen, device=cuda))
    cdf, _ = blocked_cumsum(w)
    (G, Q, F, Li), y, df_, log_norm, df_int = _model_args(d, cuda, noise,
                                                          5.0)
    draws = fc.fused_cdf_filter_step_draws(gen, cuda)
    kw = dict(noise=noise, mode=mode, df_int=df_int)
    before = fc.fused_cdf_filter_step.launches
    x, ll, a = fc.fused_cdf_filter_step(cdf, X, y, G, Q, F, Li, df_,
                                        log_norm, draws, **kw)
    assert fc.fused_cdf_filter_step.launches == before + 1
    x_p, ll_p, a_p = fc.fused_cdf_filter_step_plain(
        cdf, X, y, G, Q, F, Li, df_, log_norm, draws, **kw)
    assert torch.equal(a, a_p)
    _close(x, x_p)
    _close(ll, ll_p)


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
