"""PyTorch port, MCMC part 2: the stretch move, parallel tempering,
ChEES-HMC and the convergence driver, against ``cusmc_tpu.mcmc``.

Parity on replayed draws: each sampler runs in both packages on the same
target and first positions, with JAX's per-sweep draws (its key schedule,
given in each module's docstring) handed to the port's ``draws=``;
positions, log-densities, adapted scales, samples and rates at rtol 1e-5
(atol 1e-5: the two packages' float32 products and gradients differ in
the last bits). The runs are short (T <= 60, C <= 32), so that no accept
or swap decision sits within that rounding of its threshold: the
decisions, read from the kept states, are equal. ``_halton2`` is held
exactly over the first 4096 points and a few large ones. The driver is
held to JAX on every block's replayed draws (its samples, R-hat, ESS and
block count). With bfloat16 proposal noise JAX runs op by op
(``jax.disable_jit``): compiled XLA on the CPU rewrites the scaling of
the bfloat16 normals (ROADMAP section 3).

Oracles: the cases of tests/test_{ensemble,tempering,chees,driver}.py at
their sizes and thresholds (some at fewer sweeps or chains where the band
allows it, each noted), run on the port's own draws.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import F32, to_torch

from cusmc_tpu.mcmc import chees_hmc_sampler as jchees
from cusmc_tpu.mcmc import parallel_tempering_sampler as jpt
from cusmc_tpu.mcmc import sample_to_convergence as jdriver
from cusmc_tpu.mcmc import stretch_move_sampler as jstretch
from cusmc_tpu.mcmc.chees import _halton2 as j_halton2
from cusmc_tpu_torch.mcmc import (
    chees_hmc_sampler,
    geometric_ladder,
    metropolis_hastings_sampler,
    parallel_tempering_sampler,
    sample_to_convergence,
    stretch_move_sampler,
)
from cusmc_tpu_torch.mcmc.chees import _halton2

SEP = 4.0


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _init(shape, seed=0, scale=1.0, shift=0.0):
    x = (shift + scale * np.random.default_rng(seed).standard_normal(shape)
         ).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _gauss(stds=None, scale=1.0):
    """-0.5 |x / stds|^2 (times ``scale``) in both packages."""
    if stds is None:
        return (lambda x: -0.5 * jnp.sum(x * x, axis=-1) * scale,
                lambda x: -0.5 * torch.sum(x * x, dim=-1) * scale)
    s = np.asarray(stds, np.float32)
    js, ts = jnp.asarray(s), torch.from_numpy(s)
    return (lambda x: -0.5 * jnp.sum((x / js) ** 2, axis=-1),
            lambda x: -0.5 * torch.sum((x / ts) ** 2, dim=-1))


def _mixture(normalised=True):
    """tests/test_tempering.py's bimodal target: the equal mixture of
    N(-SEP 1, I) and N(+SEP 1, I); unnormalised as in
    tests/test_driver.py."""
    def jmix(x):
        a = -0.5 * jnp.sum((x + SEP) ** 2, axis=-1)
        b = -0.5 * jnp.sum((x - SEP) ** 2, axis=-1)
        out = jnp.logaddexp(a, b)
        if normalised:
            d = x.shape[-1]
            out = out - jnp.log(2.0) - 0.5 * d * jnp.log(2 * jnp.pi)
        return out

    def tmix(x):
        a = -0.5 * torch.sum((x + SEP) ** 2, dim=-1)
        b = -0.5 * torch.sum((x - SEP) ** 2, dim=-1)
        out = torch.logaddexp(a, b)
        if normalised:
            d = x.shape[-1]
            out = out - np.log(2.0) - 0.5 * d * np.log(2 * np.pi)
        return out
    return jmix, tmix


# -- the JAX key schedules --------------------------------------------------

def stretch_draws(key, steps, w):
    half = w // 2
    out = []
    for t in range(steps):
        halves = []
        for k in jax.random.split(jax.random.fold_in(key, t)):
            kz, kj, ku = jax.random.split(k, 3)
            halves.append((to_torch(jax.random.uniform(kz, (half,), F32)),
                           to_torch(jax.random.randint(kj, (half,), 0, half)),
                           to_torch(jax.random.uniform(ku, (half,), F32))))
        out.append(tuple(halves))
    return out


def pt_draws(key, steps, r, c, d, swap_every=1, noise_dtype=F32):
    out = []
    for t in range(steps):
        kz, ku, ks = jax.random.split(jax.random.fold_in(key, t), 3)
        z = jax.random.normal(kz, (r, c, d), noise_dtype).astype(F32)
        us = (to_torch(jax.random.uniform(ks, (r - 1, c), F32))
              if r > 1 and t % swap_every == 0 else None)
        out.append((to_torch(z), to_torch(jax.random.uniform(ku, (r, c),
                                                             F32)), us))
    return out


def chees_draws(key, steps, c, d):
    out = []
    for t in range(steps):
        kp, ku = jax.random.split(jax.random.fold_in(key, t))
        out.append((to_torch(jax.random.normal(kp, (c, d), F32)),
                    to_torch(jax.random.uniform(ku, (c,), F32))))
    return out


def mh_draws(key, steps, c, d):
    out = []
    for t in range(steps):
        kz, ku = jax.random.split(jax.random.fold_in(key, t))
        out.append((to_torch(jax.random.normal(kz, (c, d), F32)),
                    to_torch(jax.random.uniform(ku, (c,), F32))))
    return out


def driver_draws(key, sampler, n_blocks, block_steps, shape, **kw):
    """The warm block's draws, then each block's (``k_warm, key =
    split(key)``; per block ``key, k_b = split(key)``)."""
    def one(k):
        if sampler == "stretch":
            return stretch_draws(k, block_steps, shape[0])
        if sampler == "pt":
            return pt_draws(k, block_steps, kw["num_rungs"], *shape)
        if sampler == "chees":
            return chees_draws(k, block_steps, *shape)
        return mh_draws(k, block_steps, *shape)

    k_warm, key = jax.random.split(key)
    out = [one(k_warm)]
    for _ in range(n_blocks):
        key, k_b = jax.random.split(key)
        out.append(one(k_b))
    return out


# -- parity on replayed draws -----------------------------------------------

def test_halton2_is_exact():
    ts = list(range(4096)) + [65535, 1 << 20, (1 << 24) - 1, 12345677]
    for t in ts:
        assert _halton2(t) == float(np.float32(j_halton2(jnp.asarray(t)))), t
    u = np.asarray([_halton2(t) for t in range(16)])
    np.testing.assert_allclose(u[1:4], [0.5, 0.25, 0.75], atol=1e-6)
    assert sorted(np.floor(u[:8] * 8).astype(int).tolist()) == list(range(8))


@pytest.mark.parametrize("thin", [1, 4])
def test_stretch_matches_jax(thin):
    w, d, steps = 16, 3, 40
    key = jax.random.key(31)
    jlogp, logp = _gauss([1.0, 2.0, 0.5])
    jx, x = _init((w, d), 1)
    ref = jstretch(key, jlogp, jx, steps, thin=thin)
    ours = stretch_move_sampler(None, logp, x, steps, thin=thin,
                                draws=stretch_draws(key, steps, w))
    _close(ours.x.numpy(), ref.x)
    _close(ours.samples.numpy(), ref.samples)
    assert ours.samples.shape == ref.samples.shape
    _close(float(ours.accept_rate), float(ref.accept_rate))
    # Op by op, JAX takes the port's arithmetic: the walkers are bitwise
    # (compiled XLA fuses the stretch into a multiply-add).
    if thin == 1:
        short = 12
        with jax.disable_jit():
            ref = jstretch(key, jlogp, jx, short)
        np.testing.assert_array_equal(ours.samples[:short].numpy(),
                                      ref.samples)


PT_CASES = {
    "default": dict(num_rungs=4, beta_min=0.1, step_size=0.5),
    "ladder": dict(betas=[1.0, 0.05, 0.03, 0.02], step_size=0.3,
                   adapt_ladder=True),
    "swap-every": dict(betas=[1.0, 0.5, 0.25], swap_every=3, thin=5),
    "rung-init": dict(num_rungs=3, beta_min=0.2, init_log_step=[-0.5, 0.0,
                                                                0.3]),
    "bf16-noise": dict(num_rungs=4, beta_min=0.1, noise_dtype="bf16"),
}


@pytest.mark.parametrize("case", sorted(PT_CASES))
def test_pt_matches_jax(case):
    # bfloat16 noise runs JAX op by op (slow): 12 sweeps.
    c, d, steps = 12, 2, 12 if case == "bf16-noise" else 50
    kw = dict(PT_CASES[case])
    key = jax.random.key(32)
    jlogp, logp = _mixture()
    r = len(kw["betas"]) if "betas" in kw else kw["num_rungs"]
    jkw, tkw = dict(kw), dict(kw)
    noise = F32
    if case == "bf16-noise":
        noise = jnp.bfloat16
        jkw["noise_dtype"], tkw["noise_dtype"] = jnp.bfloat16, torch.bfloat16
    for k in ("betas", "init_log_step"):
        if k in kw:
            jkw[k] = jnp.asarray(kw[k], F32)
            tkw[k] = torch.tensor(kw[k], dtype=torch.float32)
    shape = (r, c, d) if case == "rung-init" else (c, d)
    jx, x = _init(shape, 2, scale=2.0)
    if case == "bf16-noise":
        with jax.disable_jit():
            ref = jpt(key, jlogp, jx, steps, num_adapt=8, **jkw)
    else:
        ref = jpt(key, jlogp, jx, steps, num_adapt=30, **jkw)
    draws = pt_draws(key, steps, r, c, d, kw.get("swap_every", 1), noise)
    ours = parallel_tempering_sampler(
        None, logp, x, steps, num_adapt=8 if case == "bf16-noise" else 30,
        draws=draws, **tkw)
    for f in ("x", "logp", "log_step", "accept_count", "swap_count",
              "ladder_s", "swap_ema"):
        _close(getattr(ours.state, f).numpy(), getattr(ref.state, f))
    for f in ("samples", "accept_rate", "swap_rate", "step_size", "betas"):
        _close(getattr(ours, f).numpy(), getattr(ref, f))
    assert ours.samples.shape == ref.samples.shape


@pytest.mark.parametrize("precondition,thin", [(True, 1), (False, 3)])
def test_chees_matches_jax(precondition, thin):
    c, d, steps = 16, 4, 60
    key = jax.random.key(33)
    jlogp, logp = _gauss([1.0, 2.0, 4.0, 8.0])
    jx, x = _init((c, d), 3, scale=3.0)
    kw = dict(step_size=0.3, init_traj=0.6, num_adapt=40,
              precondition=precondition, thin=thin)
    ref = jchees(key, jlogp, jx, steps, **kw)
    ours = chees_hmc_sampler(None, logp, x, steps,
                             draws=chees_draws(key, steps, c, d), **kw)
    for f in ("x", "logp", "grad", "log_step", "log_traj", "adam_m",
              "adam_v", "var_est", "accept_count"):
        _close(getattr(ours.state, f).numpy(), getattr(ref.state, f))
    for f in ("samples", "accept_rate", "step_size", "traj_length",
              "mean_leapfrog", "mass_var"):
        _close(getattr(ours, f).numpy(), getattr(ref, f))
    assert float(ours.mean_leapfrog) > 1.0


# One shape and block length for every sampler, so that JAX compiles its
# diagnostics once for all four cases. The stretch move's proposal
# amplifies the two packages' last-bit differences (see
# test_stretch_matches_jax), so its blocks are half as long.
DRIVER_CASES = {
    "chees": dict(step_size=0.3, init_traj=0.6),
    "mh": dict(step_size=1.0),
    "pt": dict(step_size=0.6, num_rungs=3, beta_min=0.1, adapt_ladder=True),
    "stretch": {},
}
DRIVER_SHAPE, DRIVER_BLOCK, DRIVER_BLOCKS = (16, 2), 12, 2


@pytest.mark.parametrize("sampler", sorted(DRIVER_CASES))
def test_driver_matches_jax(sampler):
    key = jax.random.key(34)
    jlogp, logp = _gauss([1.0, 2.0])
    jx, x = _init(DRIVER_SHAPE, 4)
    kw = dict(DRIVER_CASES[sampler], block_steps=DRIVER_BLOCK,
              max_blocks=DRIVER_BLOCKS, min_ess=1e9)
    if sampler == "stretch":  # see DRIVER_CASES
        kw["block_steps"] = DRIVER_BLOCK // 2
    ref = jdriver(key, jlogp, jx, sampler=sampler, **kw)
    draws = driver_draws(key, sampler, DRIVER_BLOCKS, kw["block_steps"],
                         DRIVER_SHAPE, **DRIVER_CASES[sampler])
    ours = sample_to_convergence(None, logp, x, sampler=sampler,
                                 draws=draws, **kw)
    assert isinstance(ours.samples, np.ndarray)
    assert ours.samples.shape == ref.samples.shape
    _close(ours.samples, ref.samples)
    _close(ours.rhat, ref.rhat, rtol=1e-4)
    _close(ours.ess, ref.ess, rtol=1e-3)
    assert (ours.blocks, ours.converged) == (ref.blocks, ref.converged)


# -- refusals -----------------------------------------------------------------

def test_refusals():
    _, logp = _gauss()
    with pytest.raises(ValueError, match="EVEN walker count"):
        stretch_move_sampler(0, logp, torch.zeros((7, 2)), 10)
    with pytest.raises(ValueError, match="2d"):
        stretch_move_sampler(0, logp, torch.zeros((4, 8)), 10)
    with pytest.raises(ValueError, match="rung axis"):
        parallel_tempering_sampler(0, logp, torch.zeros((3, 8, 2)), 10,
                                   num_rungs=4)
    with pytest.raises(ValueError, match="betas\\[0\\]"):
        parallel_tempering_sampler(0, logp, torch.zeros((8, 2)), 10,
                                   betas=torch.tensor([0.9, 0.5]))
    with pytest.raises(ValueError, match="decreasing"):
        parallel_tempering_sampler(0, logp, torch.zeros((8, 2)), 10,
                                   betas=torch.tensor([1.0, 0.5, 0.6]))
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_to_convergence(0, lambda x: x.sum(-1), torch.zeros((4, 2)),
                              sampler="gibbs")


# -- the oracles of tests/test_ensemble.py -----------------------------------

def test_stretch_correlated_gaussian_no_tuning():
    d, w, steps, rho = 4, 64, 4000, 0.9
    scales = np.asarray([1.0, 2.0, 3.0, 5.0])
    corr = np.full((d, d), rho) + (1 - rho) * np.eye(d)
    cov = scales[:, None] * corr * scales[None, :]
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32))
    logp = lambda x: -0.5 * torch.einsum("wi,ij,wj->w", x, prec, x)
    init = torch.randn((w, d), generator=torch.Generator().manual_seed(0))
    res = stretch_move_sampler(0, logp, init, steps)
    s = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.5)
    np.testing.assert_allclose(np.cov(s.T), cov, rtol=0.35, atol=0.5)
    assert 0.1 < float(res.accept_rate) < 0.6


def test_stretch_reproducible_and_shapes():
    _, logp = _gauss()
    init = torch.randn((16, 2), generator=torch.Generator().manual_seed(1))
    r1 = stretch_move_sampler(5, logp, init, 100, thin=4)
    r2 = stretch_move_sampler(torch.Generator().manual_seed(5), logp, init,
                              100, thin=4)
    assert r1.samples.shape == (25, 16, 2)
    assert torch.equal(r1.x, r2.x)


# -- the oracles of tests/test_tempering.py ----------------------------------

def test_geometric_ladder():
    b = geometric_ladder(6, 0.05).numpy()
    assert b[0] == 1.0
    np.testing.assert_allclose(b[-1], 0.05, rtol=1e-6)
    assert (np.diff(b) < 0).all()
    assert geometric_ladder(1).shape == (1,)
    _, logp = _gauss()
    r = parallel_tempering_sampler(0, logp, torch.zeros((16, 2)), 50,
                                   num_rungs=4)
    np.testing.assert_allclose(
        r.betas.numpy(), [1.0, 0.1 ** (1 / 3), 0.1 ** (2 / 3), 0.1],
        rtol=1e-5)


def test_pt_crosses_modes_plain_mh_does_not():
    d, chains, steps = 2, 32, 3000
    _, mix = _mixture()
    init = -SEP + 0.5 * torch.randn((chains, d),
                                    generator=torch.Generator().manual_seed(2))
    mh = metropolis_hastings_sampler(0, mix, init, steps, step_size=0.6,
                                     adapt_rate=0.0)
    pt = parallel_tempering_sampler(0, mix, init, steps, num_rungs=8,
                                    beta_min=0.02, step_size=0.6)
    assert float((mh.samples[steps // 2:, :, 0] > 0).double().mean()) < 0.05
    frac = float((pt.samples[steps // 2:, :, 0] > 0).double().mean())
    assert 0.30 < frac < 0.70
    # tests/test_tempering.py::test_cold_marginal_moments at 32 chains.
    s = pt.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(s.mean(0), 0.0, atol=1.2)
    np.testing.assert_allclose(s.var(0), 1.0 + SEP ** 2, rtol=0.35)


def test_pt_unimodal_exactness():
    d, chains, steps = 3, 64, 3000
    logp = lambda x: -0.5 * torch.sum((x - 1.5) ** 2, dim=-1) / 0.49
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(3))
    pt = parallel_tempering_sampler(0, logp, init, steps, num_rungs=4,
                                    beta_min=0.2, step_size=0.4)
    s = pt.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(s.mean(0), 1.5, atol=0.15)
    np.testing.assert_allclose(s.var(0), 0.49, rtol=0.3)


def test_pt_swap_rates_shapes_and_options():
    d, chains, steps, R = 2, 16, 400, 6
    _, logp = _gauss()
    init = torch.randn((chains, d), generator=torch.Generator().manual_seed(4))
    pt = parallel_tempering_sampler(0, logp, init, steps, num_rungs=R,
                                    beta_min=0.1)
    assert pt.samples.shape == (steps, chains, d)
    assert pt.swap_rate.shape == (R - 1,) and pt.accept_rate.shape == (R,)
    sw = pt.swap_rate.numpy()
    assert (sw > 0.05).all() and (sw <= 1.0).all()
    assert float(pt.betas[0]) == 1.0
    r1 = parallel_tempering_sampler(1, logp, init[:8], 100, num_rungs=4,
                                    keep_samples=False)
    r2 = parallel_tempering_sampler(1, logp, init[:8], 100, num_rungs=4,
                                    keep_samples=False)
    assert r1.samples is None and torch.equal(r1.state.x, r2.state.x)
    pt = parallel_tempering_sampler(0, logp, init[:8], 120,
                                    betas=torch.tensor([1.0, 0.5, 0.25]),
                                    swap_every=3)
    assert pt.swap_rate.shape == (2,)
    assert torch.isfinite(pt.swap_rate).all()


def test_pt_adaptive_ladder_equalises_swap_rates():
    d, chains, steps = 2, 64, 3000
    betas0 = torch.tensor([1.0, 0.05, 0.03, 0.02])
    _, logp = _gauss(scale=50.0)
    init = 0.14 * torch.randn((chains, d),
                              generator=torch.Generator().manual_seed(5))
    fixed = parallel_tempering_sampler(0, logp, init, steps, betas=betas0,
                                       step_size=0.05)
    adapt = parallel_tempering_sampler(0, logp, init, steps, betas=betas0,
                                       step_size=0.05, adapt_ladder=True)
    sw_f, sw_a = fixed.swap_rate.numpy(), adapt.swap_rate.numpy()
    assert sw_a.std() < 0.7 * sw_f.std(), (sw_f, sw_a)
    b = adapt.betas.numpy()
    assert b[0] == 1.0
    np.testing.assert_allclose(b[-1], 0.02, rtol=1e-4)
    assert (np.diff(b) < 0).all()
    # tests/test_tempering.py::test_bimodal_still_recovered_with_adaptation
    _, mix = _mixture(normalised=False)
    init = -SEP + 0.5 * torch.randn((32, d),
                                    generator=torch.Generator().manual_seed(6))
    pt = parallel_tempering_sampler(0, mix, init, steps, num_rungs=8,
                                    beta_min=0.02, step_size=0.6,
                                    adapt_ladder=True)
    frac = float((pt.samples[steps // 2:, :, 0] > 0).double().mean())
    assert 0.25 < frac < 0.75


# -- the oracles of tests/test_chees.py --------------------------------------

@pytest.mark.parametrize("precondition", [False, True])
def test_chees_adapts_on_a_wide_target(precondition):
    # Stds 1..10: without preconditioning the trajectory grows toward the
    # widest scale; with it the mass diagonal learns the variances and
    # the trajectory stays short.
    d = 8 if not precondition else 6
    chains, steps = 128, 1200
    stds = np.linspace(1.0, 10.0, d).astype(np.float32)
    _, logp = _gauss(stds)
    init = torch.from_numpy(stds) * torch.randn(
        (chains, d), generator=torch.Generator().manual_seed(7))
    res = chees_hmc_sampler(0, logp, init, steps, step_size=0.3,
                            init_traj=0.6, precondition=precondition,
                            keep_samples=False)
    if precondition:
        ratio = res.mass_var.numpy() / stds ** 2
        assert (ratio > 0.4).all() and (ratio < 2.5).all()
        assert 0.4 < float(res.accept_rate) < 0.95
        assert float(res.traj_length) < 6.0
    else:
        assert float(res.traj_length) > 3.0
        assert 0.4 < float(res.accept_rate) < 0.9
        assert float(res.mean_leapfrog) > 4.0


def test_chees_moments_on_anisotropic_gaussian():
    d, chains, steps = 4, 128, 1500
    stds = np.asarray([1.0, 2.0, 4.0, 8.0], np.float32)
    _, logp = _gauss(stds)
    init = torch.from_numpy(stds) * torch.randn(
        (chains, d), generator=torch.Generator().manual_seed(8))
    res = chees_hmc_sampler(0, logp, init, steps, step_size=0.3,
                            init_traj=0.6)
    s = res.samples[steps // 2:].reshape(-1, d).numpy()
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.9)
    np.testing.assert_allclose(s.var(0), stds ** 2, rtol=0.35)


def test_chees_freezes_reproduces_and_rejects_divergences():
    _, logp = _gauss()
    init = torch.randn((16, 2), generator=torch.Generator().manual_seed(9))
    r = chees_hmc_sampler(0, logp, init, 200, num_adapt=50,
                          keep_samples=False)
    r2 = chees_hmc_sampler(0, logp, init, 120, num_adapt=50,
                           keep_samples=False)
    assert float(r.traj_length) == float(r2.traj_length)
    assert float(r.step_size) == float(r2.step_size)
    r3 = chees_hmc_sampler(0, logp, init[:8, :], 60, thin=3)
    assert r3.samples.shape == (20, 8, 2)
    _, stiff = _gauss(scale=50.0)
    r = chees_hmc_sampler(0, stiff, 0.1 * init[:8], 50, step_size=5.0,
                          adapt_rate=0.0, traj_lr=0.0, keep_samples=False)
    assert torch.isfinite(r.state.x).all()
    assert float(r.accept_rate) < 0.2


# -- the oracles of tests/test_driver.py -------------------------------------

def test_driver_chees_converges_fast():
    d, chains = 4, 64
    stds = np.asarray([1.0, 2.0, 4.0, 8.0], np.float32)
    _, logp = _gauss(stds)
    init = torch.from_numpy(stds) * torch.randn(
        (chains, d), generator=torch.Generator().manual_seed(10))
    run = sample_to_convergence(0, logp, init, sampler="chees",
                                block_steps=300, max_blocks=10,
                                min_ess=400.0, step_size=0.3, init_traj=0.6)
    assert run.converged and run.blocks <= 5
    assert run.rhat.max() <= 1.01 and run.ess.min() >= 400
    s = run.samples.reshape(-1, d)
    np.testing.assert_allclose(s.var(0), stds ** 2, rtol=0.4)


def test_driver_mh_flags_nonconvergence_and_converges():
    _, logp = _gauss()
    init = torch.randn((8, 2), generator=torch.Generator().manual_seed(11))
    run = sample_to_convergence(0, logp, init, sampler="mh", block_steps=50,
                                max_blocks=2, min_ess=1e6)
    assert not run.converged and run.blocks == 2
    assert run.samples.shape == (100, 8, 2)
    init = torch.randn((64, 2), generator=torch.Generator().manual_seed(12))
    run = sample_to_convergence(0, logp, init, sampler="mh", block_steps=400,
                                max_blocks=10, min_ess=300.0, step_size=1.0)
    assert run.converged
    np.testing.assert_allclose(run.samples.reshape(-1, 2).var(0), 1.0,
                               rtol=0.3)


def test_driver_pt_on_bimodal():
    _, mix = _mixture(normalised=False)
    gen = torch.Generator().manual_seed(13)
    init = -SEP + 0.5 * torch.randn((32, 2), generator=gen)
    run = sample_to_convergence(0, mix, init, sampler="pt", block_steps=800,
                                max_blocks=8, min_ess=300.0, step_size=0.6,
                                num_rungs=6, beta_min=0.02, adapt_ladder=True)
    assert run.converged
    frac = float((run.samples[..., 0] > 0).mean())
    assert 0.2 < frac < 0.8


def test_driver_stretch():
    d, walkers = 3, 64
    stds = np.asarray([1.0, 3.0, 9.0], np.float32)
    _, logp = _gauss(stds)
    init = torch.from_numpy(stds) * torch.randn(
        (walkers, d), generator=torch.Generator().manual_seed(14))
    run = sample_to_convergence(0, logp, init, sampler="stretch",
                                block_steps=600, max_blocks=10,
                                min_ess=300.0)
    assert run.converged
    np.testing.assert_allclose(run.samples.reshape(-1, d).var(0), stds ** 2,
                               rtol=0.4)
