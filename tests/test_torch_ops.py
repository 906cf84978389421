"""PyTorch port, the kernel ops: the plain versions of ``blocked_cumsum`` and
``inverse_cdf_apply`` against the JAX Pallas kernels run in interpret mode
(as tests/test_cumsum.py and tests/test_monotone_gather.py run them). The
CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.

Tolerances: the cumsum at rtol 2e-6 / atol 1e-5, the JAX kernel's own test
bound (float32 sums in another order); the search exactly, since both
sides search the same monotone cdf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_inputs import search_inputs

from cusmc_tpu.ops.cumsum import blocked_cumsum as jax_blocked_cumsum
from cusmc_tpu.ops.monotone_gather import inverse_cdf_apply as jax_icdf
from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.ops.cumsum import FOLD, blocked_cumsum
from cusmc_tpu_torch.ops.monotone_gather import inverse_cdf_apply


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


def test_cpu_resolution_and_unsupported_devices():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    w = torch.ones(8, device="meta")
    with pytest.raises(ValueError):
        blocked_cumsum(w)
