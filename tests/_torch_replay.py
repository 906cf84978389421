"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

JAX and torch draw different numbers from the same seed, so wherever the
JAX package draws inside a function, these helpers replay its key schedule
and hand the exact draws to the port's pure transforms. Inputs cross
between the packages as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

F32 = jnp.float32
TINY = float(jnp.finfo(F32).tiny)


def to_torch(a):
    return torch.from_numpy(np.array(a))


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
    ``packed_noise`` layout: ``kz, kg = split(key)`` for MVT."""
    d = jmodel.state_dim
    if jmodel.noise != "mvt":
        return (to_torch(jax.random.normal(key, (d, n), F32)),)
    kz, kg = jax.random.split(key)
    z = to_torch(jax.random.normal(kz, (d, n), F32))
    if jmodel.df_int is not None:
        return (z, chi2_integer_draws(kg, jmodel.df_int, (1, n)))
    alpha = np.float32(0.5) * np.float32(jmodel.df)
    return (z, fast_gamma_draws(kg, float(alpha), (1, n)))


def roll_draws(key, n, num_steps):
    """``resampling/rolls.roll_metropolis_weight_walk``: shifts and the
    per-sweep uniforms."""
    k_shift, k_u = jax.random.split(key)
    shifts = jax.random.randint(k_shift, (num_steps,), 0, n, jnp.int32)
    u = jnp.stack([jax.random.uniform(jax.random.fold_in(k_u, b), (n,), F32)
                   for b in range(num_steps)])
    return to_torch(shifts), to_torch(u)


def port_model(jmodel):
    """The port's DLM carrying the JAX model's factors across."""
    from cusmc_tpu_torch.models.dlm import DLM

    return DLM.from_jax_arrays(
        F=jmodel.F, G=jmodel.G, m0=jmodel.m0, C0_sqrt=jmodel.C0_sqrt,
        W_sqrt=jmodel.W_sqrt, V_chol=jmodel.V_chol,
        V_chol_inv=jmodel.V_chol_inv,
        df=None if jmodel.df is None else np.asarray(jmodel.df),
        noise=jmodel.noise, df_int=jmodel.df_int)


def jax_model(noise, df=None, d=2):
    from cusmc_tpu.io.data import demo_model_params
    from cusmc_tpu.models.dlm import DLM

    return DLM.create(noise=noise, df=df, dtype=F32,
                      **demo_model_params(d=d))

