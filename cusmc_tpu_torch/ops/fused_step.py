"""Fused filter step: windowed-Metropolis resample, propagate and reweight
in one pass.

Port of ``cusmc_tpu/ops/fused_step.py`` (``_step_kernel`` at ``:127``,
behind ``fused_filter_step`` at ``:350``). On a CUDA tensor
``fused_filter_step`` launches ``csrc/fused_step.cu``; on a CPU tensor it
takes ``fused_filter_step_plain``, the same arithmetic in PyTorch. Both
draw their random bits from the port's Philox (``ops/philox.py``): the TPU
kernel's hardware bits cannot be reproduced, so the plain version takes a
``bits`` source, which the tests set to zeros to hold it against the JAX
kernel in interpret mode (whose emulated bits are all zero).

Semantics kept from the TPU kernel, for tile i of ``tile`` particles:

- the window is the source tiles ``(i + s[0]) mod nb`` and
  ``(i + s[0] + 1) mod nb``, plus ``(i + s[1]) mod nb`` when
  ``num_window_tiles=3``, rotated by ``r = bits & 127`` (one per tile);
- sweep ``sw`` proposes window position ``db + lane`` of the rotated
  window, ``db = 128 ((bits & 0x7FFFFFFF) mod n_off)``; the chain accepts
  when ``u * w_cur < w_cand`` on ``w = exp(logw)`` (strict, float32);
- the ancestor map of ``:257-270``; propagate ``G x + Q z`` (MVT: ``z``
  scaled by ``sqrt(df / g)``, ``g`` a one-log integer-df chi-square or four
  Marsaglia-Tsang rounds); reweight through ``Li`` (``:291-343``).

Random rows (``ops/philox.py`` layout): stream 1 of tile i holds ``r``
(row 0, lane 0) and the sweep offsets (row 1, lane sw); stream 0 of each
particle holds its B accept uniforms, then ``2d`` Box-Muller rows (the
first uniforms of the d normals, then their partners), then the
chi-square rows (``df_int // 2 + 2 (df_int % 2)``, or 3 per
Marsaglia-Tsang round).

The kernel has two designs of its propagate-and-reweight half, chosen by
``step_path(d, k)`` in the compiled widths ``step_widths(d, k)``: "thread"
(d and k up to 16 but d = k = 16; one particle per thread,
``csrc/propagate.cuh``) and "tile" (d = k in {16, 32}, and every shape
wider than 16: each warp's 32 particles through the four matrix products
as 3xTF32 tensor-core tiles). Both draw the same bits and give the same
ancestors; the plain version is the same for both. No shape runs at
run-time widths.

The "thread" design runs in a compiled width bucket, ``step_widths(d,
k)`` = (DM, KM) with DM >= d and KM >= k: its loops are unrolled to DM
and KM and guarded by d and k, so that its vectors live in registers,
and each normal is drawn and added into ``Q z`` in one pass over the
columns, while the ancestor's column is in flight. The walk and the
block's tile, key and window are formed in 32 bits, once a block, and a
particle's candidate weights are loaded a chunk of sweeps at a time, with
the chunk's accept uniforms drawn while they fly; the accept chain keeps
the sweeps' order. Each group of four Philox rows is drawn once a
particle, even where the accept rows and the noise rows share one.

The "tile" design runs at d = k in ``TILE_DIMS`` in tiles of exactly
that width (``csrc/tile_propagate.cuh``), and past 16 at the padded
widths ``step_widths(d, k)`` = (DM, KM), DM the smallest of
``TILE_PAD_DIMS`` at least d (at least max(d, k) when k > 1), KM = 16 for
k <= 16, else DM (``csrc/wide_propagate.cuh``): d and k zero-padded, the
padding drawing no Philox row, one state tile a warp, the normals drawn a
k-step at a time, and the matrices' k-panels staged for the whole block.
The fused inverse-CDF step takes the same designs and widths
(``ops/fused_cdf_step.py``).

The state is float32 or, under mixed precision, bfloat16 with ``G``,
``Q`` and ``F`` in the state's type (``:223-229, 277-289, 329-336``); the
weights, ``Li``, ``y``, the noise's scale and ``ll`` stay float32. The
bfloat16 step follows the TPU kernel's law, which is not the composed
path's: the normals are drawn in float32 and rounded to bfloat16 before
the ``Q`` product, ``G x + (Q z) s`` is summed in float32 and rounded once
to the stored state, and ``ll`` is computed from that stored state. The
ancestors do not depend on the state's type. A bfloat16 state needs even
d, as in the JAX package (``:375-377``). The port's float32 step does not
emulate the TPU kernel's single-pass bf16 matrix unit at d > 8.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels
from cusmc_tpu_torch.ops.packed import matvec
from cusmc_tpu_torch.ops.philox import philox_bits
from cusmc_tpu_torch.ops.random import MAX_INTEGER_DF

DEFAULT_TILE = 2048
MAX_MXU_DIM = 128   # d, k cap (the TPU kernel's; kept as the port's limit)
_MT_ROUNDS = 4      # Marsaglia-Tsang proposal rounds (ops/random.py)
MAX_SWEEPS = 128    # one row of 128 per-tile offset bits on the TPU

BitSource = Callable[..., torch.Tensor]


def to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """U(0,1) from raw bits: the low 23 bits times 2^-23, clamped at
    1e-12 so that a log is safe (``fused_step.py:63-75``)."""
    u = (bits & 0x007FFFFF).to(torch.float32) * (1.0 / (1 << 23))
    return torch.clamp_min(u, 1e-12)


def to_normals(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Box-Muller normals from two bit rows."""
    r = torch.sqrt(-2.0 * torch.log(to_uniform(b1)))
    return r * torch.cos((2.0 * math.pi) * to_uniform(b2))


def mt_gamma(alpha: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Fixed-round Marsaglia-Tsang Gamma(alpha) for alpha >= 1 (0-dim
    float32): ``bits`` [3 * _MT_ROUNDS, ...], three rows per round (the
    Box-Muller pair, the accept uniform) -> [...]."""
    dd = alpha - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * dd)
    shape = bits.shape[1:]
    accepted = torch.zeros(shape, dtype=torch.bool, device=bits.device)
    out = alpha.expand(shape)
    for i in range(_MT_ROUNDS):
        x = to_normals(bits[3 * i], bits[3 * i + 1])
        t = 1.0 + c * x
        v = t * t * t
        u = to_uniform(bits[3 * i + 2])
        pos = v > 0.0
        ok = pos & (torch.log(u) < 0.5 * x * x + dd - dd * v
                    + dd * torch.log(torch.where(pos, v, 1.0)))
        out = torch.where(ok & ~accepted, dd * v, out)
        accepted = accepted | ok
    return out


def chi2_rows(noise: str, df_int: Optional[int]) -> int:
    """Random rows the chi-square of one particle takes."""
    if noise != "mvt":
        return 0
    if df_int is not None:
        m, odd = divmod(df_int, 2)
        return m + 2 * odd
    return 3 * _MT_ROUNDS


def auto_tile(n: int, dk: int, state_itemsize: int = 4) -> int:
    """The JAX package's tile choice (``fused_step.py:109-124``), kept so
    that ``pallas_tile`` means the same window in both packages: the
    largest power-of-two tile dividing n, at least 2 tiles, capped by d."""
    if dk >= 128:
        cap = 512 * (4 // state_itemsize)
    else:
        cap = 131072 // max(dk, 8)
    t = 512
    while t * 2 <= min(cap, 16384, n // 2) and n % (t * 2) == 0:
        t *= 2
    return t


TILE_DIMS = (16, 32)  # d = k compiled exactly for the "tile" design
# The "tile" design's padded state widths past 16, and the observation
# width of its shapes with k <= 16.
TILE_PAD_DIMS = (32, 64, 128)
TILE_PAD_OBS = 16
# The "thread" design's compiled state widths: each with an observation
# width of 1 (the univariate models, the structural family) and of itself.
THREAD_BUCKET_DIMS = (2, 4, 8, 16)


def _width(d: int, k: int) -> int:
    """The width a shape needs: d for k = 1, else max(d, k)."""
    if not (1 <= d <= MAX_MXU_DIM and 1 <= k <= MAX_MXU_DIM):
        raise ValueError(f"no fused step at d={d}, k={k}")
    return d if k == 1 else max(d, k)


def step_path(d: int, k: int) -> str:
    """The design the kernel runs for state width d and observation width
    k: "tile" for d = k in ``TILE_DIMS`` and for every shape wider than
    the largest "thread" bucket, else "thread"."""
    wide = _width(d, k) > THREAD_BUCKET_DIMS[-1]
    return "tile" if wide or (d == k and d in TILE_DIMS) else "thread"


def step_widths(d: int, k: int) -> Tuple[int, int]:
    """The compiled widths (DM, KM) both kernels run the design
    ``step_path(d, k)`` in, d and k padded to them: for "thread" the
    width bucket, DM the smallest of ``THREAD_BUCKET_DIMS`` at least d (at
    least max(d, k) when k > 1) and KM = 1 for k = 1, else DM; for "tile"
    (d, d) at d = k in ``TILE_DIMS``, else DM the smallest of
    ``TILE_PAD_DIMS`` at least d (at least max(d, k) when k > 1) and
    KM = ``TILE_PAD_OBS`` for k <= 16, else DM."""
    want = _width(d, k)
    if step_path(d, k) == "thread":
        width = min(w for w in THREAD_BUCKET_DIMS if w >= want)
        return width, 1 if k == 1 else width
    if d == k and d in TILE_DIMS:
        return d, d
    dm = min(w for w in TILE_PAD_DIMS if w >= want)
    return dm, TILE_PAD_OBS if k <= TILE_PAD_OBS else dm


def fused_filter_step_draws(gen: Optional[torch.Generator], n: int,
                            tile: int, device=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s [2] int32 in [0, n / tile), seed [2] int32)``, drawn on the
    device with no read-back (``fused_step.py:406-413``)."""
    s = torch.randint(0, n // tile, (2,), generator=gen, dtype=torch.int32,
                      device=device)
    seed = torch.randint(-(1 << 31), 1 << 31, (2,), generator=gen,
                         dtype=torch.int64, device=device).to(torch.int32)
    return s, seed


def propagate_reweight_plain(x_anc, zbits, cbits, y, G, Q, F, Li, df,
                             log_norm, noise: str, df_int: Optional[int]):
    """Propagate and reweight packed ``x_anc`` [d, N] (float32 or
    bfloat16, with G, Q and F of its type) with the noise rows ``zbits``
    [2d, N] and chi-square rows ``cbits`` [*, N]; ``df`` and ``log_norm``
    are 0-dim float32. Returns ``(x_new [d, N] of x_anc's type, ll [N],
    x_pre [d, N])``, ``x_pre`` the float32 state before its rounding to
    x_anc's type."""
    d = x_anc.shape[0]
    k = F.shape[0]
    f32 = torch.float32
    mean = matvec(G, x_anc, f32)
    qz = matvec(Q, to_normals(zbits[:d], zbits[d:]).to(x_anc.dtype), f32)
    if noise == "mvt":
        if df_int is not None:
            m, odd = divmod(df_int, 2)
            if m > 0:
                prod = to_uniform(cbits[0])
                for j in range(1, m):
                    prod = prod * to_uniform(cbits[j])
                g = -2.0 * torch.log(torch.clamp_min(prod, 1e-38))
            else:
                g = torch.zeros(x_anc.shape[1:], dtype=torch.float32,
                                device=x_anc.device)
            if odd:
                zc = to_normals(cbits[m], cbits[m + 1])
                g = g + zc * zc
        else:
            g = 2.0 * mt_gamma(0.5 * df, cbits[:3 * _MT_ROUNDS])
        qz = qz * torch.sqrt(df / g)
    x_pre = mean + qz
    x_new = x_pre.to(x_anc.dtype)
    zz = Li @ (y[:, None] - matvec(F, x_new, f32))
    quad = torch.sum(zz * zz, dim=0)
    if noise == "mvt":
        ll = log_norm - 0.5 * (df + k) * torch.log1p(quad / df)
    else:
        ll = log_norm - 0.5 * quad
    return x_new, ll, x_pre


def _scalars(df, log_norm, device):
    f32 = torch.float32
    return (torch.tensor(1.0 if df is None else float(df), dtype=f32,
                         device=device),
            torch.as_tensor(log_norm, dtype=f32).to(device))


def check_step_args(d: int, k: int, n: int, *, dtype, noise: str,
                    df, num_sweeps: int, tile: int, df_int,
                    num_window_tiles: int) -> None:
    """The ValueErrors of ``fused_step.py:365-404``, with the state's
    type (float32, or bfloat16 at even d)."""
    if n % tile != 0:
        raise ValueError(f"N={n} not divisible by tile={tile}")
    if tile % 128 != 0:
        raise ValueError(f"tile={tile} must be a multiple of 128")
    if max(d, k) > MAX_MXU_DIM:
        raise ValueError(f"fused step supports d,k <= {MAX_MXU_DIM}")
    if dtype not in kernels.STATE_DTYPES:
        raise ValueError(f"fused step takes a float32 or bfloat16 state, "
                         f"not {dtype}")
    if dtype == torch.bfloat16 and d % 2:
        raise ValueError("bfloat16 state needs even d")
    if num_sweeps > MAX_SWEEPS:
        raise ValueError(f"num_sweeps={num_sweeps} exceeds the kernel's "
                         f"{MAX_SWEEPS}-sweep proposal-bit budget")
    if num_sweeps < 0:
        raise ValueError(f"num_sweeps={num_sweeps} < 0")
    if df_int is not None and not 1 <= df_int <= MAX_INTEGER_DF:
        raise ValueError(f"df_int={df_int} outside [1, {MAX_INTEGER_DF}]; "
                         f"pass df_int=None for the Marsaglia-Tsang path")
    if noise not in ("mvn", "mvt"):
        raise ValueError(f"unknown noise {noise!r}")
    if noise == "mvt" and df is None:
        raise ValueError("mvt noise needs df")
    if num_window_tiles not in (2, 3):
        raise ValueError("num_window_tiles must be 2 or 3")
    if n < num_window_tiles * tile:
        raise ValueError(f"N={n} smaller than the {num_window_tiles}-tile "
                         f"window")


def require_model(X, y, G, Q, F, Li, seed) -> int:
    """Validate the arguments both fused kernels take before their
    pointers are passed on: contiguous X [d, N], G, Q [d, d] and F [k, d]
    of the state's type (float32 or bfloat16), float32 y [k] and Li
    [k, k], and an int32 seed [2], on X's device. Returns the kernels'
    ``bf16`` flag."""
    d = X.shape[0]
    k = F.shape[0]
    dev = X.device
    bf16 = kernels.require_state(X, "X", dev)
    kernels.require(y, "y", torch.float32, 1, dev)
    for name, mat, shape, dtype in (("G", G, (d, d), X.dtype),
                                    ("Q", Q, (d, d), X.dtype),
                                    ("F", F, (k, d), X.dtype),
                                    ("Li", Li, (k, k), torch.float32)):
        kernels.require(mat, name, dtype, 2, dev)
        if tuple(mat.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(mat.shape)}, "
                             f"expected {shape}")
    kernels.require(seed, "seed", torch.int32, 1, dev)
    if y.shape[0] != k or seed.shape[0] != 2:
        raise ValueError("y [k] and seed [2] expected")
    return bf16


def fused_filter_step_plain(X, logw, y, G, Q, F, Li, df, log_norm, draws, *,
                            noise: str = "mvn", num_sweeps: int = 10,
                            tile: int = DEFAULT_TILE,
                            df_int: Optional[int] = None,
                            num_window_tiles: int = 2,
                            bits: Optional[BitSource] = None,
                            pre_rounding: bool = False):
    """The plain version of the kernel, on any device. ``bits(seed,
    blocks, stream, rows, lanes) -> [rows, nb, L]`` is the bit source
    (None: Philox, ``ops/philox.philox_bits``). ``pre_rounding`` adds the
    float32 state before its rounding to X's type as a fourth output, so
    that a check can show where two roundings of it may differ."""
    bits = philox_bits if bits is None else bits
    d, n = X.shape
    dev = X.device
    s, seed = draws
    nb = n // tile
    wt = num_window_tiles
    wlen = wt * tile
    tiles = torch.arange(nb, device=dev)
    lanes = torch.arange(tile, device=dev)
    sc = bits(seed, tiles, 1, 2, torch.arange(max(num_sweeps, 1),
                                              device=dev))
    r = (sc[0, :, :1] & 127)                                   # [nb, 1]
    n_off = (wt - 1) * tile // 128 + 1
    db = 128 * ((sc[1, :, :num_sweeps] & 0x7FFFFFFF) % n_off)  # [nb, B]
    s64 = s.to(torch.int64)
    ws = (((tiles + s64[0]) % nb) * tile)[:, None]
    ws2 = (((tiles + s64[1]) % nb) * tile)[:, None]

    def wrap(q):
        return torch.where(q >= wlen, q - wlen, q)

    def global_index(q):
        pair = torch.remainder(ws + q, n)
        if wt == 2:
            return pair
        return torch.where(q < 2 * tile, pair, ws2 + (q - 2 * tile))

    rows = bits(seed, tiles, 0, num_sweeps + 2 * d + chi2_rows(noise, df_int),
                lanes)                                         # [R, nb, tile]
    w = torch.exp(logw)
    base = lanes[None, :] + r                                  # [nb, tile]
    w_cur = w[global_index(wrap(base))]
    a_off = torch.zeros_like(base)
    for sw in range(num_sweeps):
        dsw = db[:, sw:sw + 1]
        w_cand = w[global_index(wrap(base + dsw))]
        acc = to_uniform(rows[sw]) * w_cur < w_cand
        w_cur = torch.where(acc, w_cand, w_cur)
        a_off = torch.where(acc, dsw, a_off)
    a = global_index(wrap(base + a_off)).reshape(n)
    flat = rows.reshape(rows.shape[0], n)
    df_t, ln_t = _scalars(df, log_norm, dev)
    x_new, ll, x_pre = propagate_reweight_plain(
        X.index_select(1, a), flat[num_sweeps:num_sweeps + 2 * d],
        flat[num_sweeps + 2 * d:], y, G, Q, F, Li, df_t, ln_t, noise, df_int)
    if pre_rounding:
        return x_new, ll, a.to(torch.int32), x_pre
    return x_new, ll, a.to(torch.int32)


def fused_filter_step(X, logw, y, G, Q, F, Li, df, log_norm, draws, *,
                      noise: str = "mvn", num_sweeps: int = 10,
                      tile: int = DEFAULT_TILE, df_int: Optional[int] = None,
                      num_window_tiles: int = 2):
    """One fused filter step on packed particles ``X`` [d, N] with
    log-weights ``logw`` [N]; ``draws = (s, seed)`` from
    ``fused_filter_step_draws``; ``df`` (None for MVN) and ``log_norm``
    floats. Returns ``(X_new [d, N], ll [N], ancestors [N] int32)``.

    CUDA: the kernel (contiguous, X, G, Q and F float32 or all bfloat16);
    CPU: the plain version. ``fused_filter_step.launches`` counts kernel
    launches on a float32 state, ``.bf16_launches`` on a bfloat16 one."""
    d, n = X.shape
    k = F.shape[0]
    check_step_args(d, k, n, dtype=X.dtype, noise=noise, df=df,
                    num_sweeps=num_sweeps, tile=tile, df_int=df_int,
                    num_window_tiles=num_window_tiles)
    if not is_cuda(X, "fused_filter_step"):
        return fused_filter_step_plain(
            X, logw, y, G, Q, F, Li, df, log_norm, draws, noise=noise,
            num_sweeps=num_sweeps, tile=tile, df_int=df_int,
            num_window_tiles=num_window_tiles)
    dev = X.device
    s, seed = draws
    bf16 = require_model(X, y, G, Q, F, Li, seed)
    kernels.require(logw, "logw", torch.float32, 1, dev)
    kernels.require(s, "s", torch.int32, 1, dev)
    if logw.shape[0] != n or s.shape[0] != 2:
        raise ValueError("logw [N] and s [2] expected")
    tiled = step_path(d, k) == "tile"
    dm, km = step_widths(d, k)
    if bf16 and tiled and any(m.data_ptr() % 4 for m in (X, G, Q, F)):
        raise ValueError("the bfloat16 tile design reads X, G, Q and F in "
                         "4-byte words: they must be 4-byte aligned")
    lib = kernels.library()
    x_new = torch.empty_like(X)
    ll = torch.empty((n,), dtype=torch.float32, device=dev)
    a = torch.empty((n,), dtype=torch.int32, device=dev)
    rc = lib.cusmc_fused_step(
        X.data_ptr(), logw.data_ptr(), y.data_ptr(), G.data_ptr(),
        Q.data_ptr(), F.data_ptr(), Li.data_ptr(), s.data_ptr(),
        seed.data_ptr(), x_new.data_ptr(), ll.data_ptr(), a.data_ptr(), n,
        tile, d, k, num_sweeps, num_window_tiles, int(noise == "mvt"),
        0 if df_int is None else df_int, 1.0 if df is None else float(df),
        float(log_norm), int(tiled), dm, km, bf16,
        kernels.stream_of(X))
    kernels.check(rc, "fused_filter_step")
    if bf16:
        fused_filter_step.bf16_launches += 1
    else:
        fused_filter_step.launches += 1
    return x_new, ll, a


fused_filter_step.launches = 0
fused_filter_step.bf16_launches = 0
