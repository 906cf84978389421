"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

JAX and torch draw different numbers from the same seed, so wherever the
JAX package draws inside a function, these helpers replay its key schedule
and hand the exact draws to the port's pure transforms. Inputs cross
between the packages as numpy arrays.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

F32 = jnp.float32
TINY = float(jnp.finfo(F32).tiny)


def to_torch(a):
    """A JAX or numpy array as a torch tensor; bfloat16 crosses as its
    16-bit words (``torch.from_numpy`` refuses numpy's bfloat16)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def chi2_integer_draws(key, df, shape):
    """``ops/random.chi2_integer_df``: ``ku, kz = split(key)``."""
    m, r = divmod(df, 2)
    ku, kz = jax.random.split(key)
    us = (to_torch(jax.random.uniform(ku, (m,) + shape, F32, minval=TINY))
          if m else None)
    z = to_torch(jax.random.normal(kz, shape, F32)) if r else None
    return us, z


def fast_gamma_draws(key, alpha, shape, rounds=4):
    """``ops/random.fast_gamma``: ``kx, ku, kb = split(key, 3)``."""
    kx, ku, kb = jax.random.split(key, 3)
    xs = to_torch(jax.random.normal(kx, (rounds,) + shape, F32))
    us = to_torch(jax.random.uniform(ku, (rounds,) + shape, F32,
                                     minval=TINY))
    u_boost = None
    if np.float32(alpha) < 1.0:
        u_boost = to_torch(jax.random.uniform(kb, shape, F32, minval=TINY))
    return xs, us, u_boost


def packed_noise(key, jmodel, n):
    """The draws of ``DLM._sample_packed(key, ...)`` in the port's
    ``packed_noise`` layout: ``kz, kg = split(key)`` for MVT; z in the
    state dtype, the chi-square draws float32, (1, n) or (d, n) with
    ``per_dim_chi``."""
    d = jmodel.state_dim
    sdt = jmodel.W_sqrt.dtype
    if jmodel.noise != "mvt":
        return (to_torch(jax.random.normal(key, (d, n), sdt)),)
    kz, kg = jax.random.split(key)
    z = to_torch(jax.random.normal(kz, (d, n), sdt))
    shape = (d, n) if jmodel.per_dim_chi else (1, n)
    if jmodel.df_int is not None:
        return (z, chi2_integer_draws(kg, jmodel.df_int, shape))
    alpha = np.float32(0.5) * np.float32(jmodel.df)
    return (z, fast_gamma_draws(kg, float(alpha), shape))


def roll_draws(key, n, num_steps):
    """``resampling/rolls.roll_metropolis_weight_walk``: shifts and the
    per-sweep uniforms."""
    k_shift, k_u = jax.random.split(key)
    shifts = jax.random.randint(k_shift, (num_steps,), 0, n, jnp.int32)
    u = jnp.stack([jax.random.uniform(jax.random.fold_in(k_u, b), (n,), F32)
                   for b in range(num_steps)])
    return to_torch(shifts), to_torch(u)


def metropolis_draws(key, n, num_steps):
    """``resampling/metropolis.metropolis_ancestors``: per sweep b,
    ``kj, ku = split(fold_in(key, b))``, proposals j and uniforms u."""
    js, us = [], []
    for b in range(num_steps):
        kj, ku = jax.random.split(jax.random.fold_in(key, b))
        js.append(jax.random.randint(kj, (n,), 0, n, dtype=jnp.int32))
        us.append(jax.random.uniform(ku, (n,), dtype=F32))
    return to_torch(jnp.stack(js)), to_torch(jnp.stack(us))


def dyadic_logw(rng, n):
    """Log weights whose softmax is exact: {1, 1/2, 1/4, 1/8} summing to
    n / 2, so every normalised weight and cdf entry is dyadic."""
    n8, n4 = int(0.3 * n), n // 5
    n2 = 3 * n - 7 * n8 - 3 * n4
    w = np.repeat(np.float32([1.0, 0.5, 0.25, 0.125]),
                  [n8, n4, n2, n - n8 - n4 - n2])
    return np.log(rng.permutation(w)).astype(np.float32)


def fused_step_draws(key, n, tile):
    """``ops/fused_step.fused_filter_step``'s draws: ``k_s, k_seed =
    split(key)``, the window offsets ``s`` and the seed pair."""
    k_s, k_seed = jax.random.split(key)
    s = jax.random.randint(k_s, (2,), 0, n // tile, jnp.int32)
    seed = jax.random.bits(k_seed, (2,), jnp.uint32).astype(jnp.int32)
    return to_torch(s), to_torch(seed)


def fused_cdf_draws(key):
    """``ops/fused_cdf_step.fused_cdf_filter_step``'s draws: ``k_u, k_seed
    = split(key)``, the systematic offset ``u`` and the seed pair."""
    k_u, k_seed = jax.random.split(key)
    u = jax.random.uniform(k_u, (), F32)
    seed = jax.random.bits(k_seed, (2,), jnp.uint32).astype(jnp.int32)
    return to_torch(u), to_torch(seed)


def filter_step_keys(key, num_steps):
    """``bootstrap_filter``'s keys: ``k_init, k_scan = split(key)``, and
    ``fold_in(k_scan, t)`` for t = 1 .. T-1."""
    k_init, k_scan = jax.random.split(key)
    return k_init, [jax.random.fold_in(k_scan, t) for t in range(1,
                                                                 num_steps)]


def zero_bits(seed, blocks, stream, rows, lanes):
    """A bit source of zeros: what the JAX kernels' interpret mode gets
    from ``pltpu.prng_random_bits`` on the CPU."""
    return torch.zeros((rows, blocks.shape[0], lanes.shape[0]),
                       dtype=torch.int64)


def fused_log_norm(jmodel):
    """The observation log-normaliser of the fused steps
    (``particle_filter.py:349-361, 544-555``), float32."""
    from jax.scipy.special import gammaln

    k = jmodel.obs_dim
    half_logdet = jnp.sum(jnp.log(jnp.diagonal(jmodel.V_chol)))
    if jmodel.noise == "mvt":
        df = jmodel.df
        return float(gammaln(0.5 * (df + k)) - gammaln(0.5 * df)
                     - 0.5 * k * (jnp.log(df) + math.log(math.pi))
                     - half_logdet)
    return float(-0.5 * k * math.log(2.0 * math.pi) - half_logdet)


def fused_filter_parity(monkeypatch, jm, ys, n, resampler, tile, draw_name,
                        draw_fn, rtol=1e-5, atol=1e-5):
    """Both packages' ``bootstrap_filter(engine="pallas")`` from the same
    x0, zero bits on both sides, the port replaying JAX's per-step draws
    (``draw_fn(key_t)``) in place of its ``draw_name`` function.

    Metropolis: ancestors equal. Systematic: the two packages sum the cdf
    in different float32 orders (JAX's blocked cumsum, ``torch.cumsum``),
    so an ancestor may differ where a position sits on a cdf boundary to
    within that rounding; each such slot must be shown to be such a tie
    (``|p - cdf[j]| <= 1e-5 total`` for every boundary j between the two
    ancestors), and slots descended from one are left out of the state
    comparison. Everything else at ``rtol``/``atol``. Returns the number
    of tie slots."""
    from cusmc_tpu.smc import particle_filter as jpf
    from cusmc_tpu_torch.ops import fused_cdf_step, fused_step
    from cusmc_tpu_torch.smc import particle_filter as tpf

    key = jax.random.key(5)
    ref = jpf.bootstrap_filter(key, jm, jnp.asarray(ys), n,
                               resampler=resampler, engine="pallas",
                               pallas_tile=tile, pallas_interpret=True)
    k_init, step_keys = filter_step_keys(key, ys.shape[0])
    x0 = to_torch(jm.sample_initial_packed(k_init, n))
    draws = [draw_fn(k) for k in step_keys]
    replay = iter(draws)
    tm = port_model(jm)
    monkeypatch.setattr(tm, "sample_initial_packed", lambda gen, m: x0)
    monkeypatch.setattr(tpf, draw_name, lambda *a, **k: next(replay))
    for module in (fused_step, fused_cdf_step):
        monkeypatch.setattr(module, "philox_bits", zero_bits)
    out = tpf.bootstrap_filter(0, tm, torch.from_numpy(ys), n,
                               resampler=resampler, engine="pallas",
                               pallas_tile=tile)
    ours_a = out.ancestors.numpy()
    ref_a = np.asarray(ref.ancestors)
    clean = np.ones(n, bool)
    ties = 0
    for t in range(1, ys.shape[0]):
        diff = np.nonzero(ours_a[t] != ref_a[t])[0]
        if resampler == "metropolis":
            np.testing.assert_array_equal(ours_a[t], ref_a[t])
        elif diff.size:
            ll = out.obs_loglik[t - 1].double()
            w = (torch.ones(n, dtype=torch.float64) if t == 1
                 else torch.exp(ll - ll.max()))
            cdf = torch.cumsum(w.float(), 0).double().numpy()
            u = float(draws[t - 1][0])
            pos = (diff + u) * (cdf[-1] / n)
            for g, p in zip(diff, pos):
                lo, hi = sorted((ours_a[t][g], ref_a[t][g]))
                assert np.all(np.abs(cdf[lo:hi] - p) <= 1e-5 * cdf[-1]), \
                    f"step {t} slot {g}: ancestors {lo} / {hi} off a tie"
            ties += diff.size
        clean = clean[ours_a[t]] & (ours_a[t] == ref_a[t])
        for ours, theirs in ((out.particles[t], ref.particles[t]),
                             (out.obs_loglik[t], ref.obs_loglik[t])):
            np.testing.assert_allclose(ours.numpy()[clean],
                                       np.asarray(theirs)[clean],
                                       rtol=rtol, atol=atol)
    assert ties <= 1e-3 * n * (ys.shape[0] - 1), ties
    np.testing.assert_allclose(out.final_particles.numpy()[clean],
                               np.asarray(ref.final_particles)[clean],
                               rtol=rtol, atol=atol)
    for ours, theirs in ((out.ess, ref.ess),
                         (out.log_evidence, ref.log_evidence)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=rtol, atol=atol)
    if resampler == "metropolis":
        np.testing.assert_allclose(out.final_log_weights.numpy(),
                                   np.asarray(ref.final_log_weights),
                                   rtol=rtol, atol=atol)
    return ties


def port_model(jmodel):
    """The port's model carrying the JAX model's leaves across: a DLM's
    factors, or the scalars of a stochastic volatility model or a UNGM."""
    from cusmc_tpu.models.stochvol import StochasticVolatility as JSV
    from cusmc_tpu.models.ungm import UNGM as JUNGM
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.models.stochvol import StochasticVolatility
    from cusmc_tpu_torch.models.ungm import UNGM

    if isinstance(jmodel, JSV):
        return StochasticVolatility.from_jax_arrays(
            mu=jmodel.mu, phi=jmodel.phi, sigma=jmodel.sigma,
            beta=jmodel.beta, device="cpu")
    if isinstance(jmodel, JUNGM):
        return UNGM.from_jax_arrays(q=jmodel.q, r=jmodel.r,
                                    x0_std=jmodel.x0_std, device="cpu")
    return DLM.from_jax_arrays(
        F=jmodel.F, G=jmodel.G, m0=jmodel.m0, C0_sqrt=jmodel.C0_sqrt,
        W_sqrt=jmodel.W_sqrt, V_chol=jmodel.V_chol,
        V_chol_inv=jmodel.V_chol_inv,
        df=None if jmodel.df is None else np.asarray(jmodel.df),
        noise=jmodel.noise, df_int=jmodel.df_int,
        per_dim_chi=jmodel.per_dim_chi, device="cpu")


def jax_model(noise, df=None, d=2, state_dtype=None, per_dim_chi=False):
    from cusmc_tpu.io.data import demo_model_params
    from cusmc_tpu.models.dlm import DLM

    return DLM.create(noise=noise, df=df, dtype=F32, state_dtype=state_dtype,
                      per_dim_chi=per_dim_chi, **demo_model_params(d=d))



def gumbel_draws(key, shape):
    """The Gumbel noise that ``jax.random.categorical(key, ...)`` adds to
    its logits (``-log(-log u)``, u in [tiny, 1)), computed by JAX."""
    u = jax.random.uniform(key, shape, F32, minval=TINY)
    return to_torch(-jnp.log(-jnp.log(u)))


def fold_split(key, t, num=2):
    """A step's keys in the auxiliary filters: ``split(fold_in(key, t),
    num)`` (APF, cSMC, RBPF, EnKF: 2; Liu-West: 3)."""
    return jax.random.split(jax.random.fold_in(key, t), num)


def normal_noise(key, shape):
    """``(z,)``: the standard normals of ``jax.random.normal(key, shape)``
    in float32 (the stochastic volatility model's and UNGM's draws)."""
    return (to_torch(jax.random.normal(key, shape, F32)),)


def batch_noise(key, jm, shape):
    """The draws of the JAX batch ``DLM._sample(key, mean, scale, shape)``
    for the port's ``noise=``: ``(z,)`` for MVN, ``(z, g)`` for MVT with g
    the chi-square variates of ``jax.random.gamma``
    (``distributions/mvt.py:119-131``: ``kz, kg = split(key)``). ``jm``
    the JAX model; ``d`` is the width of the scale sampled (state or
    observation)."""
    shape, d = tuple(shape[:-1]), shape[-1]
    if jm.noise != "mvt":
        return (to_torch(jax.random.normal(key, shape + (d,), F32)),)
    kz, kg = jax.random.split(key)
    z = jax.random.normal(kz, shape + (d,), F32)
    df = jnp.asarray(jm.df, F32)
    g = 2.0 * jax.random.gamma(kg, 0.5 * df, shape + (1,), dtype=F32)
    return to_torch(z), to_torch(g)


def model_noise(key, jm, shape):
    """The draws of a JAX model's batch sampling method at ``shape`` (its
    output's shape): a DLM's ``batch_noise``, else ``normal_noise``."""
    from cusmc_tpu.models.dlm import DLM as JDLM

    if isinstance(jm, JDLM):
        return batch_noise(key, jm, shape)
    return normal_noise(key, shape)


def registry_draws(name, key, n, num_steps=10):
    """The keyword draws of the port's registry resampler ``name`` that
    replay the JAX resampler on ``key``: ``{"u": ...}`` for systematic
    (one offset), stratified (N) and multinomial (N+1 in [tiny, 1)),
    ``{"j": ..., "u": ...}`` for metropolis."""
    if name == "systematic":
        return {"u": to_torch(jax.random.uniform(key, (), F32))}
    if name == "stratified":
        return {"u": to_torch(jax.random.uniform(key, (n,), F32))}
    if name == "multinomial":
        return {"u": to_torch(jax.random.uniform(key, (n + 1,), F32,
                                                 minval=TINY))}
    if name == "metropolis":
        j, u = metropolis_draws(key, n, num_steps)
        return {"j": j, "u": u}
    raise KeyError(name)


def assert_ancestors_or_ties(ours, ref, logw, draws, name="systematic"):
    """Ancestors of a registry resampler equal, or a shown cdf tie: the
    two packages sum the softmax's cdf in different float32 orders, so a
    slot may differ where its position lies on a cdf boundary within that
    rounding (each boundary between the two ancestors within 1e-5 of the
    position, the total being 1). Returns the number of such slots."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    diff = np.nonzero(ours != ref)[0]
    if not diff.size:
        return 0
    assert name in ("systematic", "stratified", "multinomial"), name
    n = ours.shape[0]
    cdf = np.cumsum(np.exp(np.asarray(logw, np.float64)
                           - np.logaddexp.reduce(np.asarray(logw,
                                                            np.float64))))
    u = np.asarray(draws["u"], np.float64)
    if name == "systematic":
        pos = (np.arange(n) + u) / n
    elif name == "stratified":
        pos = (np.arange(n) + u) / n
    else:
        s = np.cumsum(-np.log(u))
        pos = s[:n] / s[n]
    for g in diff:
        lo, hi = sorted((ours[g], ref[g]))
        assert np.all(np.abs(cdf[lo:hi] - pos[g]) <= 1e-5), \
            f"slot {g}: ancestors {lo} / {hi} off a tie"
    return diff.size
