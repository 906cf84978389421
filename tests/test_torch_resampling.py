"""PyTorch port, resampling: the roll-Metropolis walk, apply and ancestors
against JAX given the replayed shifts and uniforms (exact: the same float32
comparisons on the same numbers), and the sorted positions given JAX's
uniforms (rtol 1e-6: one float32 division may round differently).
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import TINY, dyadic_logw, metropolis_draws, \
    roll_draws, to_torch

from cusmc_tpu.resampling import classic as jclassic
from cusmc_tpu.resampling import rolls as jrolls
from cusmc_tpu_torch.resampling import classic, rolls

N, B = 4096, 10


def _weights(kind, n=N):
    rng = np.random.default_rng(0)
    if kind == "exp":
        ll = -25.0 * rng.standard_normal(n) ** 2
        return np.exp(ll - ll.max()).astype(np.float32)
    if kind == "zeros":  # degenerate pairs (0 vs 0) must reject
        w = np.zeros(n, np.float32)
        w[::97] = 1.0
        return w
    return rng.uniform(size=n).astype(np.float32)


@pytest.mark.parametrize("kind", ["exp", "uniform", "zeros"])
def test_weight_walk_matches_jax_exactly(kind):
    key = jax.random.key(3)
    w = _weights(kind)
    b_win_ref, shifts_ref = jrolls.roll_metropolis_weight_walk(
        key, jnp.asarray(w), B)
    shifts, u = roll_draws(key, N, B)
    np.testing.assert_array_equal(shifts.numpy(), np.asarray(shifts_ref))
    b_win = rolls.roll_metropolis_weight_walk(torch.from_numpy(w), shifts, u)
    np.testing.assert_array_equal(b_win.numpy(), np.asarray(b_win_ref))


def test_apply_and_ancestors_match_jax_exactly():
    key = jax.random.key(4)
    w = _weights("exp")
    X = np.random.default_rng(1).standard_normal((3, N)).astype(np.float32)
    b_win, shifts = jrolls.roll_metropolis_weight_walk(key, jnp.asarray(w), B)
    np.testing.assert_array_equal(
        rolls.apply_winning_rolls(torch.from_numpy(X), to_torch(b_win),
                                  to_torch(shifts)).numpy(),
        np.asarray(jrolls.apply_winning_rolls(jnp.asarray(X), b_win, shifts)))
    np.testing.assert_array_equal(
        rolls.winning_ancestors(to_torch(b_win), to_torch(shifts)).numpy(),
        np.asarray(jrolls.winning_ancestors(b_win, shifts)))


def test_sweeps_expspace_matches_jax_exactly():
    key = jax.random.key(5)
    w = _weights("exp")
    X = np.random.default_rng(2).standard_normal((2, N)).astype(np.float32)
    x_ref, a_ref = jrolls.roll_metropolis_sweeps_expspace(
        key, jnp.asarray(X), jnp.asarray(w), B)
    shifts, u = roll_draws(key, N, B)
    x, a = rolls.roll_metropolis_sweeps_expspace(
        torch.from_numpy(w), shifts, u, torch.from_numpy(X))
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))


def test_draws_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    shifts, u = rolls.roll_metropolis_draws(gen, 1000, 7)
    assert shifts.dtype == torch.int32 and shifts.shape == (7,)
    assert int(shifts.min()) >= 0 and int(shifts.max()) < 1000
    assert u.shape == (7, 1000) and float(u.min()) >= 0 and float(u.max()) < 1


@pytest.mark.parametrize("spread,expect", [(0.0, 3), (0.6, 5), (3.0, 10)])
def test_auto_num_steps_buckets(spread, expect):
    # Kish ess/N > 0.75 -> ceil(B/4); in (0.5, 0.75] -> ceil(B/2); else B.
    rng = np.random.default_rng(3)
    ll = spread * rng.standard_normal(N)
    w = np.exp(ll - ll.max()).astype(np.float32)
    assert rolls.auto_num_steps(torch.from_numpy(w), B) == expect


def test_offspring_law_of_metropolis():
    # Mean offspring count tracks N * w_norm (finite-B bias aside): the
    # heaviest decile of particles must collect well above its share.
    gen = torch.Generator().manual_seed(6)
    w = torch.from_numpy(_weights("uniform"))
    counts = torch.zeros(N)
    for _ in range(20):
        shifts, u = rolls.roll_metropolis_draws(gen, N, B)
        _, a = rolls.roll_metropolis_sweeps_expspace(w, shifts, u,
                                                     torch.zeros(1, N))
        counts += torch.bincount(a.long(), minlength=N).float()
    expected = 20 * N * w / w.sum()
    top = torch.argsort(w)[-N // 10:]
    ratio = float(counts[top].sum() / expected[top].sum())
    assert 0.9 < ratio < 1.1


@pytest.mark.parametrize("name", sorted(classic.POSITION_FNS))
def test_positions_given_jax_uniforms(name):
    key = jax.random.key(8)
    n = 1000
    ref = jclassic.POSITION_FNS[name](key, n, jnp.float32)
    if name == "systematic":
        ours = classic.systematic_from_uniforms(
            to_torch(jax.random.uniform(key, (), jnp.float32)), n)
    elif name == "stratified":
        ours = classic.stratified_from_uniforms(
            to_torch(jax.random.uniform(key, (n,), jnp.float32)))
    else:
        ours = classic.sorted_from_uniforms(to_torch(jax.random.uniform(
            key, (n + 1,), jnp.float32, minval=TINY)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    assert bool(torch.all(ours[1:] >= ours[:-1]))
    assert float(ours.min()) >= 0.0 and float(ours.max()) < 1.0


@pytest.mark.parametrize("name", sorted(classic.POSITION_FNS))
def test_position_fns_draw_sorted_unit_positions(name):
    gen = torch.Generator().manual_seed(9)
    pos = classic.POSITION_FNS[name](gen, 2048)
    assert pos.shape == (2048,) and pos.dtype == torch.float32
    assert bool(torch.all(pos[1:] >= pos[:-1]))
    assert float(pos.min()) >= 0.0 and float(pos.max()) < 1.0


@pytest.mark.parametrize("kind", ["exp", "uniform"])
def test_metropolis_ancestors_match_jax_exactly(kind):
    from cusmc_tpu.resampling.metropolis import metropolis_ancestors as jma
    from cusmc_tpu_torch.resampling import metropolis

    key = jax.random.key(9)
    logw = np.log(np.maximum(_weights(kind), 1e-30)).astype(np.float32)
    ref = jma(key, jnp.asarray(logw), num_steps=B)
    a = metropolis.metropolis_from_draws(torch.from_numpy(logw),
                                         *metropolis_draws(key, N, B))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref))
    gen = torch.Generator().manual_seed(0)
    drawn = metropolis.metropolis_ancestors(gen, torch.from_numpy(logw), B)
    assert drawn.dtype == torch.int32 and drawn.shape == (N,)
    assert int(drawn.min()) >= 0 and int(drawn.max()) < N


@pytest.mark.parametrize("name", ["systematic", "stratified", "multinomial"])
def test_ancestor_functions_match_jax(monkeypatch, name):
    # Exact: dyadic weights make both packages' cdfs exact, and JAX's
    # sorted uniforms are handed the port's (its log and cumsum round in
    # another order).
    logw = dyadic_logw(np.random.default_rng(4), N)
    key = jax.random.key(12)
    if name == "multinomial":
        u = np.array(jax.random.uniform(key, (N + 1,), jnp.float32,
                                        minval=TINY))
        pos = jnp.asarray(classic.sorted_from_uniforms(
            torch.from_numpy(u)).numpy())
        monkeypatch.setattr(jclassic, "sorted_uniforms",
                            lambda k, n, dtype: pos)
    else:
        shape = () if name == "systematic" else (N,)
        u = np.array(jax.random.uniform(key, shape, jnp.float32))
    ref = getattr(jclassic, f"{name}_ancestors")(key, jnp.asarray(logw))
    ours = getattr(classic, f"{name}_ancestors")(
        None, torch.from_numpy(logw), torch.from_numpy(u))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    drawn = getattr(classic, f"{name}_ancestors")(
        torch.Generator().manual_seed(1), torch.from_numpy(logw))
    assert int(drawn.min()) >= 0 and int(drawn.max()) < N
