"""PyTorch port, the roll walk's design: the plan that chooses one pass or
bands from (N, d, the state's bytes, the card's L2 bytes), the bands it
gives, the plain version on the two ancestor patterns whose answer is
known, and the port against JAX on JAX's replayed draws.

The plan is a pure function, so it is tested here on the CPU: bands
cover every row exactly once, in order; a band fits its share of L2
(unless it is one row, which cannot be cut); X that fits the one-pass
share takes one pass (the headline's d = 2 at N = 2^20 on the H100's
50 MB L2). The values are exact: the apply copies, and the walk makes
the same float32 comparisons on the same numbers.
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import roll_draws

from cusmc_tpu.resampling import rolls as jrolls
from cusmc_tpu_torch.resampling import rolls

H100_L2 = 52_428_800  # cudaDeviceProp.l2CacheSize of an H100 SXM


@pytest.mark.parametrize("n", [1, 1000, 1_000_003, 1 << 20, 1 << 24])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 13, 16, 32, 128])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("l2", [H100_L2, 6 * 1024 * 1024])
def test_bands_cover_every_row_once_and_fit_their_budget(n, d, itemsize, l2):
    rows = rolls.roll_band_rows(n, d, itemsize, l2)
    bands = rolls.roll_bands(d, rows)
    assert 1 <= rows <= d
    assert [r for r0, r1 in bands for r in range(r0, r1)] == list(range(d))
    assert all(r1 - r0 <= rows for r0, r1 in bands)
    one_pass = d * n * itemsize <= rolls.ROLL_ONE_PASS_SHARE * l2
    # One row cannot be cut: d = 1 takes one pass at any n.
    assert (rolls.roll_path(rows, d) == "one-pass") == (one_pass or d == 1)
    assert (len(bands) == 1) == (one_pass or d == 1)
    if not one_pass:
        assert rows == 1 or rows * n * itemsize <= rolls.ROLL_BAND_SHARE * l2
        # Balanced: no band is shorter than the others by a whole band.
        assert bands[-1][1] - bands[-1][0] > rows - len(bands)
        assert -(-d // rows) <= rolls.MAX_BANDS


def test_plan_at_the_main_paths_shapes():
    # The headline runs one pass; the monthly DLM, the bfloat16 rows'
    # widths and the full width run bands (N = 2^20).
    n = 1 << 20
    assert rolls.roll_band_rows(n, 1, 4, H100_L2) == 1
    assert rolls.roll_band_rows(n, 2, 4, H100_L2) == 2
    assert rolls.roll_band_rows(n, 2, 2, H100_L2) == 2
    for d, itemsize in ((13, 4), (16, 4), (32, 4), (16, 2), (32, 2)):
        rows = rolls.roll_band_rows(n, d, itemsize, H100_L2)
        assert rolls.roll_path(rows, d) == "banded", (d, itemsize)
        assert rows * n * itemsize <= rolls.ROLL_BAND_SHARE * H100_L2


def _identity_and_front(n, b, seed):
    gen = torch.Generator().manual_seed(seed)
    shifts = torch.randint(-(1 << 31), (1 << 31) - 1, (b,), generator=gen,
                           dtype=torch.int32)
    return shifts, torch.ones(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,b", [(1, 1), (7, 3), (1000, 10), (4099, 5)])
def test_identity_and_one_front_patterns(dtype, n, b):
    # w constant: u = 1 rejects every proposal (1 * 1 < 1 is false), so
    # a = i; u = 1/2 accepts every one, so a = (i + s_B) mod n.
    shifts, w = _identity_and_front(n, b, n + b)
    X = torch.randn((5, n), generator=torch.Generator().manual_seed(b)
                    ).to(dtype)
    i = torch.arange(n)
    for u_value, expect in ((1.0, i),
                            (0.5, torch.remainder(i + int(shifts[-1]), n))):
        u = torch.full((b, n), u_value)
        y, a = rolls.roll_metropolis_sweeps_expspace(w, shifts, u, X)
        assert a.dtype == torch.int32
        assert torch.equal(a.long(), expect)
        assert y.dtype == dtype and torch.equal(y, X[:, expect])


@pytest.mark.parametrize("d", [2, 13])
@pytest.mark.parametrize("n", [1000, 4096, 4099])
def test_mixed_pattern_matches_jax_exactly(d, n):
    rng = np.random.default_rng(n + d)
    ll = -25.0 * rng.standard_normal(n) ** 2
    w = np.exp(ll - ll.max()).astype(np.float32)
    X = rng.standard_normal((d, n)).astype(np.float32)
    key = jax.random.key(n * d)
    x_ref, a_ref = jrolls.roll_metropolis_sweeps_expspace(
        key, jnp.asarray(X), jnp.asarray(w), 10)
    shifts, u = roll_draws(key, n, 10)
    x, a = rolls.roll_metropolis_sweeps_expspace(
        torch.from_numpy(w), shifts, u, torch.from_numpy(X))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    # The winners spread over several fronts, as the banded design assumes.
    fronts = {(int(ai) - i) % n for i, ai in enumerate(a.numpy())}
    assert len(fronts) >= 4
    # Copied band by band, as the kernel copies them, the rows are the same.
    for rows in (1, 3, d):
        banded = torch.cat([torch.from_numpy(X)[r0:r1, a.long()]
                            for r0, r1 in rolls.roll_bands(d, rows)])
        assert torch.equal(banded, x)
        y, a_b = rolls.roll_metropolis_sweeps_in_bands(
            torch.from_numpy(w), shifts, u, torch.from_numpy(X), rows)
        assert torch.equal(a_b, a) and torch.equal(y, x)
