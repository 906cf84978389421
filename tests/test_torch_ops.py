"""PyTorch port, the kernel ops: the plain versions of ``blocked_cumsum``,
``inverse_cdf_apply`` (global and local-block mode), ``inverse_cdf_search``
and ``take_columns`` against the JAX Pallas kernels run in interpret mode
(as tests/test_cumsum.py and tests/test_monotone_gather.py run them). The
CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.

Tolerances: the cumsum at rtol 2e-6 / atol 1e-5, the JAX kernel's own test
bound (float32 sums in another order); the searches and gathers exactly,
since both sides search the same monotone cdf and copy the same values.
The JAX local-block kernel leaves the values of out-of-block ancestors
unset, so values are compared where the ancestor lies in the block.
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_inputs import search_inputs

import cusmc_tpu_torch
from cusmc_tpu.ops.cumsum import blocked_cumsum as jax_blocked_cumsum
from cusmc_tpu.ops import monotone_gather as jmg
from cusmc_tpu.ops.monotone_gather import inverse_cdf_apply as jax_icdf
from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.io.data import demo_model_params
from cusmc_tpu_torch.ops.cumsum import EPOCH_LIMIT, FOLD, TILE, ScanState, \
    blocked_cumsum
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply, \
    inverse_cdf_search, take_columns


@pytest.mark.parametrize("n", [4096, 8192])
def test_cumsum_matches_jax_kernel(n):
    w = np.random.default_rng(n).uniform(size=n).astype(np.float32)
    ref, ref128 = jax_blocked_cumsum(jnp.asarray(w), interpret=True)
    cdf, cdf128 = blocked_cumsum(torch.from_numpy(w))
    np.testing.assert_allclose(cdf.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(cdf128.numpy(), cdf.numpy()[FOLD - 1::FOLD])
    assert cdf128.shape == ref128.shape
    assert bool(torch.all(cdf[1:] >= cdf[:-1]))


def test_cumsum_any_length():
    cdf, cdf128 = blocked_cumsum(torch.ones(FOLD * 3 + 5))
    np.testing.assert_allclose(cdf.numpy(), np.arange(1, FOLD * 3 + 6))
    assert cdf128.shape == (3,)


@pytest.mark.parametrize("kind", ["reuse", "grow", "wrap"])
def test_scan_state_epochs_and_tickets(kind):
    # The CUDA scan's look-back state: each call a new epoch and the
    # ticket base of the tiles handed out before it, on one buffer zeroed
    # once; a larger call or the epoch limit starts a fresh buffer.
    st = ScanState("cpu")
    buf, epoch, base = st.next_call(3 * TILE)
    assert (epoch, base) == (1, 0) and buf.numel() >= 4
    assert buf.dtype == torch.int64 and not bool(buf.any())
    if kind == "reuse":
        for i, n in enumerate((3 * TILE, 1, 2 * TILE + 5)):
            b, e, t = st.next_call(n)
            assert b.data_ptr() == buf.data_ptr()
            assert (e, t) == (2 + i, (3, 6, 7)[i])
    elif kind == "grow":
        b, e, t = st.next_call(10 * TILE + 1)
        assert b.numel() >= 12 and (e, t) == (1, 0)
        assert st.next_call(TILE)[1:] == (2, 11)
    else:
        st.epoch = EPOCH_LIMIT - 2
        assert st.next_call(TILE)[1:] == (EPOCH_LIMIT - 1, 3)
        b, e, t = st.next_call(TILE)
        assert (e, t) == (1, 0) and b.data_ptr() != buf.data_ptr()
        assert not bool(b.any())


@pytest.mark.parametrize("case", ["uniform", "concentrated", "zero-runs"])
def test_inverse_cdf_apply_matches_jax_kernel(case):
    cdf, pos, X = search_inputs(np.random.default_rng(11), case, 2048, 3)
    y_ref, a_ref = jax_icdf(jnp.asarray(cdf), jnp.asarray(pos),
                            jnp.asarray(X), interpret=True)
    y, a = inverse_cdf_apply(torch.from_numpy(cdf), torch.from_numpy(pos),
                             torch.from_numpy(X))
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


def test_inverse_cdf_apply_clips_past_the_end():
    cdf = torch.tensor([0.0, 1.0, 1.0, 2.0])
    pos = torch.tensor([0.0, 0.5, 1.0, 2.0, 3.0])
    y, a = inverse_cdf_apply(cdf, pos, torch.arange(4.0)[None])
    # <= keeps the zero-weight particles 0 and 2 from ever being chosen.
    assert a.tolist() == [1, 1, 3, 3, 3]
    assert y[0].tolist() == [1.0, 1.0, 3.0, 3.0, 3.0]


def test_default_device_is_the_card_or_an_error():
    # ``None`` never falls back to the CPU: it is the card, and without one
    # it raises, as run(device=None) then does.
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    p = demo_model_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cusmc_tpu_torch.run(256, 2, 3, np.zeros((3, 2)), p["m0"], p["C0"],
                            p["F"], p["G"], p["V"], p["W"])


@pytest.mark.parametrize("state_dtype", [None, torch.bfloat16])
def test_model_default_device_is_the_card_or_an_error(state_dtype):
    # A model built with device=None lives on the card, and without one its
    # construction raises; the filter then runs where the model lives.
    from cusmc_tpu_torch.models.dlm import DLM

    p = demo_model_params()
    if torch.cuda.is_available():
        model = DLM.create(state_dtype=state_dtype, **p)
        assert model.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DLM.create(state_dtype=state_dtype, **p)
    cpu = DLM.create(state_dtype=state_dtype, device="cpu", **p)
    assert cpu.device.type == "cpu"
    arrays = {name: getattr(cpu, name).float().numpy()
              for name in ("F", "G", "m0", "C0_sqrt", "W_sqrt", "V_chol",
                           "V_chol_inv")}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DLM.from_jax_arrays(**arrays)
    moved = DLM.from_jax_arrays(device="cpu", **arrays)
    torch.testing.assert_close(moved.G, cpu.G.float(), rtol=0, atol=0)
    result = cusmc_tpu_torch.bootstrap_filter(
        0, cpu, np.zeros((3, 2), np.float32), 256, resampler="systematic")
    assert result.final_particles.device.type == "cpu"


def test_cpu_resolution_and_unsupported_devices():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    w = torch.ones(8, device="meta")
    with pytest.raises(ValueError):
        blocked_cumsum(w)


@pytest.mark.parametrize("case", ["uniform", "concentrated", "zero-runs"])
@pytest.mark.parametrize("nq_div", [1, 4])
def test_inverse_cdf_search_matches_jax_kernel(case, nq_div):
    # L = N and L = N/4 sorted queries over the N-long cdf.
    cdf, pos, _ = search_inputs(np.random.default_rng(12), case, 4096, 1)
    pos = np.ascontiguousarray(pos[::nq_div])
    a_ref = jmg.inverse_cdf_search(jnp.asarray(cdf), jnp.asarray(pos),
                                   interpret=True)
    a = inverse_cdf_search(torch.from_numpy(cdf), torch.from_numpy(pos))
    assert a.dtype == torch.int32 and a.shape == (4096 // nq_div,)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


def _ancestors(kind, n, rng):
    a = rng.integers(0, n, n)
    if kind == "sorted":
        a = np.sort(a)
    elif kind == "concentrated":  # long constant runs, then jumps
        a = np.sort(np.where(np.arange(n) % 7 == 0, n - 1, np.arange(n) % 3))
    return a.astype(np.int32)


@pytest.mark.parametrize("kind", ["sorted", "concentrated", "unsorted"])
def test_take_columns_matches_jax_kernel(kind):
    rng = np.random.default_rng(13)
    n = 2048
    X = rng.standard_normal((3, n)).astype(np.float32)
    a = _ancestors(kind, n, rng)
    ref = jmg.take_columns(jnp.asarray(X), jnp.asarray(a), tile=512,
                           interpret=True)
    out = take_columns(torch.from_numpy(X), torch.from_numpy(a))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_take_columns_clips_out_of_range():
    X = torch.arange(8.0).reshape(2, 4)
    a = torch.tensor([-3, 0, 3, 9], dtype=torch.int32)
    assert take_columns(X, a).tolist() == [[0.0, 0.0, 3.0, 3.0],
                                           [4.0, 4.0, 7.0, 7.0]]


@pytest.mark.parametrize("case", ["uniform", "concentrated"])
def test_inverse_cdf_apply_local_block_matches_jax_kernel(case):
    # The shard shapes of a 4-way split: the global cdf, each shard's
    # queries and its [d, N/4] block at base p N/4.
    n, n_loc = 8192, 2048
    cdf, pos, X = search_inputs(np.random.default_rng(14), case, n, 2)
    for p in range(4):
        base = p * n_loc
        q, blk = pos[base:base + n_loc], X[:, base:base + n_loc]
        y_ref, a_ref = jax_icdf(jnp.asarray(cdf), jnp.asarray(q),
                                jnp.asarray(blk), tile=512, interpret=True,
                                local_base=base)
        y, a = inverse_cdf_apply(torch.from_numpy(cdf), torch.from_numpy(q),
                                 torch.from_numpy(np.ascontiguousarray(blk)),
                                 local_base=base)
        a_ref = np.asarray(a_ref)
        np.testing.assert_array_equal(a.numpy(), a_ref)
        hit = (a_ref >= base) & (a_ref < base + n_loc)
        np.testing.assert_array_equal(y.numpy()[:, hit],
                                      np.asarray(y_ref)[:, hit])
        np.testing.assert_array_equal(y.numpy()[:, hit], X[:, a_ref[hit]])
        rel = np.clip(a_ref - base, 0, n_loc - 1)
        np.testing.assert_array_equal(y.numpy(), blk[:, rel])
