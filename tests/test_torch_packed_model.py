"""PyTorch port, ``ops/packed_model.py`` on the CPU: the rule that sends the
DLM's composed packed step to its kernels, and the plain versions.

The kernels run only on the card (tests/test_torch_cuda.py holds them to
the plain versions there). Here: which device, dtypes, widths, particle
count, stride and ``per_dim_chi`` take them (``takes_kernel``), that a
CPU state never does, and that the plain versions are bitwise the
composed expressions the DLM computed before they moved to this module
(held to the JAX package by tests/test_torch_dlm.py and
tests/test_torch_mixed_precision.py), for a float32 and a bfloat16
state, MVN and MVT with an odd, an even and a non-integer df.
"""

import _torch_threads  # noqa: F401
import pytest
import torch

from _torch_inputs import dense_dlm

from cusmc_tpu_torch.ops import packed_model as pm
from cusmc_tpu_torch.ops.packed import matvec, quadform
from cusmc_tpu_torch.ops.random import chi2_transform

F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
CUDA = torch.device("cuda", 0)
NOISES = [("mvn", None), ("mvt", 5.0), ("mvt", 4.0), ("mvt", 4.5)]
# (3, 20): past the kernels' widths, k > d as in a dynamic factor model,
# where only the plain versions run.
SHAPES = [(1, 1), (2, 2), (5, 3), (13, 1), (16, 16), (3, 20)]


@pytest.mark.parametrize("device,state,weight,d,k,n,stride,per_dim,takes", [
    (CUDA, F32, F32, 2, 2, 1 << 23, 1, False, True),
    ("cuda", F32, F32, 13, 1, 1 << 22, 1, False, True),
    (CUDA, F32, F32, 16, 16, 1000, 1, False, True),
    (CUDA, F32, F32, 1, 1, 1, 1, False, True),
    ("cpu", F32, F32, 2, 2, 1 << 20, 1, False, False),
    (CUDA, BF16, F32, 2, 2, 1 << 20, 1, False, False),
    (CUDA, F32, F64, 2, 2, 1 << 20, 1, False, False),
    (CUDA, F64, F64, 2, 2, 1 << 20, 1, False, False),
    (CUDA, F32, F32, 17, 1, 1 << 20, 1, False, False),
    (CUDA, F32, F32, 20, 20, 1 << 20, 1, False, False),
    (CUDA, F32, F32, 2, 17, 1 << 20, 1, False, False),
    (CUDA, F32, F32, 2, 2, 1 << 20, 2, False, False),
    (CUDA, F32, F32, 2, 2, 1 << 20, 1, True, False),
    (CUDA, F32, F32, 2, 2, 1 << 31, 1, False, False),
])
def test_takes_kernel_rule(device, state, weight, d, k, n, stride, per_dim,
                           takes):
    assert pm.takes_kernel(device, state, weight, d, k, n, stride,
                           per_dim) is takes


@pytest.mark.parametrize("state_dtype", [F32, BF16])
@pytest.mark.parametrize("per_dim", [False, True])
def test_a_cpu_state_runs_no_kernel(state_dtype, per_dim):
    m = dense_dlm(2, 2, "mvt", 5.0, "cpu", state_dtype)
    m.per_dim_chi = per_dim
    X = torch.zeros((2, 64), dtype=state_dtype)
    assert not m.runs_kernels(X)
    assert not m.runs_kernels(X[:, ::2])
    before = (pm.packed_propagate.launches, pm.packed_loglik.launches)
    m.observation_logpdf_packed(torch.zeros(2), m.propagate_packed(
        torch.Generator().manual_seed(0), X))
    assert (pm.packed_propagate.launches,
            pm.packed_loglik.launches) == before


def _composed_propagate(m, X, noise):
    """The DLM's packed propagate as it was written before the plain
    version moved to ops/packed_model.py, on the same draws."""
    mean = matvec(m.G_f32, X, out_dtype=X.dtype)
    z = noise[0]
    sdtype = m.state_dtype
    if m.noise != "mvt":
        return mean + matvec(m.W_sqrt_f32, z, out_dtype=sdtype)
    lz = matvec(m.W_sqrt_f32, z, out_dtype=sdtype)
    g = chi2_transform(m.df_value, m.df_int, noise[1])
    return mean + lz * torch.sqrt(torch.div(m.df, g)).to(sdtype)


def _composed_loglik(m, y, X):
    """The DLM's packed log-density as it was written before the plain
    version moved to ops/packed_model.py."""
    wdtype = m.V_chol.dtype
    resid = y[:, None].to(wdtype) - matvec(m.F_f32, X, out_dtype=wdtype)
    quad = quadform(m.V_chol_inv, resid)
    if m.noise == "mvt":
        k = m.obs_dim
        return m.log_norm - 0.5 * (m.df_value + k) * torch.log1p(
            quad / m.df)
    return m.log_norm - 0.5 * quad


@pytest.mark.parametrize("d,k", SHAPES)
@pytest.mark.parametrize("noise,df", NOISES)
@pytest.mark.parametrize("state_dtype", [F32, BF16])
def test_plain_versions_are_the_composed_expressions(d, k, noise, df,
                                                     state_dtype):
    m = dense_dlm(d, k, noise, df, "cpu", state_dtype)
    n = 1000
    gen = torch.Generator().manual_seed(10 * d + k)
    X = torch.randn((d, 2 * n), generator=gen).to(state_dtype)
    y = 0.1 * torch.randn((k,), generator=gen)
    for x in (X[:, :n].contiguous(), X[:, 1:1 + n]):
        draws = m.packed_noise(gen, n)
        want = _composed_propagate(m, x, draws)
        for got in (pm.packed_propagate_plain(m, x, draws),
                    pm.packed_propagate(m, x, draws),
                    m.propagate_packed(None, x, draws)):
            assert got.dtype == state_dtype
            assert torch.equal(got, want)
        want = _composed_loglik(m, y, x)
        for got in (pm.packed_loglik_plain(m, y, x),
                    pm.packed_loglik(m, y, x),
                    m.observation_logpdf_packed(y, x)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("noise,df", NOISES)
def test_packed_step_draws_the_same_numbers_on_both_paths(noise, df):
    # packed_noise is the one source of draws: propagate_packed on its own
    # generator is the plain version on the draws a twin generator gives.
    m = dense_dlm(2, 2, noise, df, "cpu")
    X = torch.randn((2, 500), generator=torch.Generator().manual_seed(1))
    got = m.propagate_packed(torch.Generator().manual_seed(7), X)
    draws = m.packed_noise(torch.Generator().manual_seed(7), 500)
    assert torch.equal(got, pm.packed_propagate_plain(m, X, draws))
    x0 = m.sample_initial_packed(torch.Generator().manual_seed(3), 500)
    draws = m.packed_noise(torch.Generator().manual_seed(3), 500)
    assert torch.equal(x0, pm.sample_packed_plain(m, m.m0[:, None],
                                                  m.C0_sqrt, draws))
