"""Fast fixed-round random samplers for the hot loop.

Port of ``cusmc_tpu/ops/random.py:24-104``: ``fast_gamma`` (a
Marsaglia-Tsang squeeze sampler with a FIXED number of proposal rounds,
unresolved lanes fall back to the mean, bias < 1e-5 relative),
``fast_chi2`` (``2 fast_gamma(df / 2)``) and ``chi2_integer_df`` (exact chi-square for small integer df from one log of
a product of uniforms). ``gumbel`` and ``categorical`` are the law of
``jax.random.categorical`` (an argmax of logits plus Gumbel noise
``-log(-log u)``, u in [tiny, 1)), which the forecast, FFBS and conditional
SMC draw their indices from; given JAX's noise they pick JAX's indices.

Each sampler is split into a draw step (a ``torch.Generator`` -> normals
and uniforms) and a pure transform of those draws, so that a test can feed
the transform the exact numbers JAX drew and compare the results to f32
rounding. ``sampler(gen, ...)`` is ``transform(*draws(gen, ...))``.

JAX draws its uniforms with ``minval=finfo.tiny``, i.e. in [tiny, 1); the
port clamps ``torch.rand``'s [0, 1) to the same range.

``normal`` draws standard normals in float32 with ``torch.randn``, and in
bfloat16 with ``jax.random.normal``'s own bfloat16 law, which the
mixed-precision model draws its noise from (``cusmc_tpu/models/dlm.py:189,
206``): ``jax.random.uniform`` draws 8-bit words for a type with fewer than
8 mantissa bits, keeps their top 7 bits as the mantissa of a float in
[1, 2), maps it onto [nextafter(-1, 0), 1), and ``normal`` takes
``sqrt(2) erfinv(u)``, each step rounded to bfloat16. The law takes only
128 values, and its tails stop at -2.890625 and 2.515625;
``torch.randn(dtype=torch.bfloat16)`` rounds a full-tailed normal
instead, which is another law.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

_DEFAULT_ROUNDS = 4

# Integer-df chi-square beats Marsaglia-Tsang up to roughly here (the JAX
# package's own bound, ``cusmc_tpu/ops/random.py:66-70``).
MAX_INTEGER_DF = 30


_BF16_NORMALS: dict = {}


def bf16_normal_table(device=None) -> torch.Tensor:
    """The 128 values of the bfloat16 normal law, indexed by the top 7 bits
    of an 8-bit word: ``jax.random.uniform``'s bfloat16 construction
    (``floats = bitcast(bits >> 1 | bits(1.0)) - 1``, then
    ``max(lo, floats (1 - lo) + lo)`` with ``lo = nextafter(-1, 0)``, each
    operation rounded to bfloat16) and ``sqrt(2) erfinv(u)``, the inverse
    error function taken in float64 and rounded once, as XLA rounds its
    bfloat16 result. Built once a device."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    table = _BF16_NORMALS.get(dev)
    if table is None:
        bf = torch.bfloat16
        one = torch.ones((), dtype=bf)
        lo = torch.nextafter(-one, torch.zeros_like(one))
        mant = torch.arange(128, dtype=torch.int32) | 0x3F80
        floats = mant.to(torch.int16).view(bf) - one
        u = torch.maximum(lo, floats * (one - lo) + lo)
        erfinv = torch.erfinv(u.double()).to(bf)
        table = (torch.tensor(math.sqrt(2.0), dtype=bf) * erfinv).to(dev)
        _BF16_NORMALS[dev] = table
    return table


def normal(gen: Optional[torch.Generator], shape, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """Standard normals of ``shape``: ``torch.randn`` for float32; for
    bfloat16 the law of ``bf16_normal_table``, a uniform level from
    ``gen`` (the top 7 bits of JAX's 8-bit word) picking its value."""
    shape = tuple(shape)
    if dtype == torch.bfloat16:
        level = torch.randint(0, 128, shape, generator=gen, device=device)
        return bf16_normal_table(level.device)[level]
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def tiny_uniform(gen: Optional[torch.Generator], shape, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """U[tiny, 1) draws (log-safe)."""
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype, device=device)
    return u.clamp_(min=torch.finfo(dtype).tiny)


def _gamma_consts(alpha: float):
    """(boosted, a, d, c) of Marsaglia-Tsang in float32, computed the way
    the JAX sampler computes them on an f32 scalar."""
    alpha32 = np.float32(alpha)
    boosted = bool(alpha32 < 1.0)
    a = np.float32(alpha32 + np.float32(1.0)) if boosted else alpha32
    d = np.float32(a - np.float32(1.0 / 3.0))
    c = np.float32(np.float32(1.0) / np.sqrt(np.float32(9.0) * d))
    return boosted, float(a), float(d), float(c)


def fast_gamma_draws(gen: Optional[torch.Generator], alpha: float, shape,
                     dtype=torch.float32, device=None,
                     rounds: int = _DEFAULT_ROUNDS):
    """(xs [rounds, *shape] normals, us [rounds, *shape] uniforms,
    u_boost [*shape] or None) — the boost uniform only when alpha < 1."""
    shape = tuple(shape)
    xs = torch.randn((rounds,) + shape, generator=gen, dtype=dtype,
                     device=device)
    us = tiny_uniform(gen, (rounds,) + shape, dtype, device)
    boosted = _gamma_consts(alpha)[0]
    u_boost = tiny_uniform(gen, shape, dtype, device) if boosted else None
    return xs, us, u_boost


def fast_gamma_transform(alpha: float, xs: torch.Tensor, us: torch.Tensor,
                         u_boost: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Gamma(alpha, 1) from the draws of ``fast_gamma_draws``."""
    boosted, a, d, c = _gamma_consts(alpha)
    shape = xs.shape[1:]
    accepted = torch.zeros(shape, dtype=torch.bool, device=xs.device)
    out = torch.full(shape, a, dtype=xs.dtype, device=xs.device)
    for r in range(xs.shape[0]):
        x = xs[r]
        t = 1.0 + c * x
        v = t * t * t
        pos = v > 0.0
        ok = pos & (torch.log(us[r]) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.where(pos, v, torch.ones_like(v))))
        take = ok & ~accepted
        out = torch.where(take, d * v, out)
        accepted = accepted | ok
    if boosted:
        if u_boost is None:
            raise ValueError("alpha < 1 needs the boost uniforms")
        out = out * u_boost ** float(np.float32(1.0) / np.float32(alpha))
    return out


def fast_gamma(gen: Optional[torch.Generator], alpha: float, shape,
               dtype=torch.float32, device=None,
               rounds: int = _DEFAULT_ROUNDS) -> torch.Tensor:
    """Gamma(alpha, 1) draws of ``shape``; statistically exact except for
    a < 1e-5 mean-fallback tail."""
    return fast_gamma_transform(
        alpha, *fast_gamma_draws(gen, alpha, shape, dtype, device, rounds))


def fast_chi2(gen: Optional[torch.Generator], df: float, shape,
              dtype=torch.float32, device=None,
              draws: Optional[tuple] = None) -> torch.Tensor:
    """Chi-square(df) = 2 Gamma(df / 2) draws of ``shape``. ``draws``
    replaces the draw: those of ``fast_gamma_draws(gen, df / 2, shape)``."""
    alpha = 0.5 * float(df)
    if draws is None:
        draws = fast_gamma_draws(gen, alpha, shape, dtype, device)
    return 2.0 * fast_gamma_transform(alpha, *draws)


def _check_df(df) -> Tuple[int, int]:
    if not (isinstance(df, int) and not isinstance(df, bool)
            and 1 <= df <= MAX_INTEGER_DF):
        raise ValueError(f"df must be an int in [1, {MAX_INTEGER_DF}], "
                         f"got {df!r}")
    return divmod(df, 2)


def chi2_integer_df_draws(gen: Optional[torch.Generator], df: int, shape,
                          dtype=torch.float32, device=None):
    """(us [df // 2, *shape] uniforms or None, z [*shape] normals or
    None) for ``chi2_integer_df_transform``."""
    m, r = _check_df(df)
    shape = tuple(shape)
    us = tiny_uniform(gen, (m,) + shape, dtype, device) if m > 0 else None
    z = (torch.randn(shape, generator=gen, dtype=dtype, device=device)
         if r else None)
    return us, z


def chi2_integer_df_transform(df: int, us: Optional[torch.Tensor],
                              z: Optional[torch.Tensor]) -> torch.Tensor:
    """chi2_{2m+r} = -2 log(prod_{i<m} U_i) + r z^2 (exact)."""
    m, r = _check_df(df)
    ref = us if us is not None else z
    out = torch.zeros(ref.shape[1:] if us is not None else ref.shape,
                      dtype=ref.dtype, device=ref.device)
    if m > 0:
        prod = us[0]
        for i in range(1, m):
            prod = prod * us[i]
        # Guard the (astronomically unlikely) f32 underflow of the product.
        prod = torch.clamp(prod, min=torch.finfo(prod.dtype).tiny)
        out = -2.0 * torch.log(prod)
    if r:
        out = out + z * z
    return out


def chi2_integer_df(gen: Optional[torch.Generator], df: int, shape,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """EXACT chi-square(df) draws for small integer df."""
    return chi2_integer_df_transform(
        df, *chi2_integer_df_draws(gen, df, shape, dtype, device))


def integer_df(df) -> Optional[int]:
    """df as an int when it is a small integer (the exact one-log
    chi-square path, ``cusmc_tpu/models/dlm.py:80-87``), else None."""
    if df is None:
        return None
    df_f = float(df)
    if df_f.is_integer() and 1 <= df_f <= MAX_INTEGER_DF:
        return int(df_f)
    return None


def chi2_draws(gen: Optional[torch.Generator], df: float,
               df_int: Optional[int], shape, dtype=torch.float32,
               device=None):
    """Draws of one chi-square(df) sample: those of ``chi2_integer_df``
    when ``df_int`` is set, else those of ``fast_gamma(df / 2)``."""
    if df_int is not None:
        return chi2_integer_df_draws(gen, df_int, shape, dtype, device)
    return fast_gamma_draws(gen, 0.5 * df, shape, dtype, device)


def chi2_transform(df: float, df_int: Optional[int], draws) -> torch.Tensor:
    """chi-square(df) from the draws of ``chi2_draws``."""
    if df_int is not None:
        return chi2_integer_df_transform(df_int, *draws)
    return 2.0 * fast_gamma_transform(0.5 * df, *draws)


# Elements of Gumbel noise drawn at once by ``categorical``: an [M, N]
# draw (M draws over N categories) is made in blocks of rows this large.
CATEGORICAL_BLOCK = 1 << 26


def gumbel(gen: Optional[torch.Generator], shape, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log u)``, u in [tiny, 1)."""
    return -torch.log(-torch.log(tiny_uniform(gen, shape, dtype, device)))


def categorical(gen: Optional[torch.Generator], logits: torch.Tensor,
                num: Optional[int] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices over the last axis of ``logits`` [..., N], drawn with
    probabilities softmax(logits): ``argmax(logits + g)`` with g Gumbel
    noise of ``(num,) + logits.shape`` (``num`` draws per row; None: one).
    ``noise`` replaces the draw. The noise is made in blocks of rows of
    ``CATEGORICAL_BLOCK`` elements, so an [M, N] draw never holds more
    than one block. Returns int64 of shape ``(num,) + logits.shape[:-1]``."""
    shape = ((num,) if num is not None else ()) + tuple(logits.shape)
    if noise is not None:
        return torch.argmax(noise + logits, dim=-1)
    n = shape[-1]
    rows = math.prod(shape[:-1])
    flat = logits.reshape(-1, n)
    out = torch.empty(rows, dtype=torch.int64, device=logits.device)
    step = max(1, CATEGORICAL_BLOCK // max(n, 1))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        g = gumbel(gen, (r1 - r0, n), logits.dtype, logits.device)
        lg = flat if flat.shape[0] == 1 else flat[
            torch.arange(r0, r1, device=logits.device) % flat.shape[0]]
        out[r0:r1] = torch.argmax(g + lg, dim=-1)
    return out.reshape(shape[:-1])
