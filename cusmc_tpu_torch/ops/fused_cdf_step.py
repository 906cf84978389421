"""Fused inverse-CDF filter step: systematic or stratified resample,
propagate and reweight in one pass.

Port of ``cusmc_tpu/ops/fused_cdf_step.py`` (``_fused_cdf_kernel`` at
``:104``, behind ``fused_cdf_filter_step`` at ``:337``). On a CUDA tensor
``fused_cdf_filter_step`` launches ``csrc/fused_cdf_step.cu``; on a CPU
tensor it takes ``fused_cdf_filter_step_plain``.

Output slot ``g`` takes the position ``p = fl(fl(g + u_g) * pscale)`` with
``pscale = fl(cdf[N-1] / N)`` (``:183-190``): ``u_g = u`` for systematic,
the uniform of the slot's Philox row 0 for stratified. Its ancestor is
``#{j : cdf[j] <= p}`` clipped to N-1, the search of
``ops/monotone_gather``; then gather, propagate and reweight as in
``ops/fused_step`` (``:257-304``). The positions are exact inverse-CDF
positions, so the ancestor law is that of the composed path.

Random rows (``ops/philox.py`` layout): block ``slot // tile``, lane
``slot % tile``, stream 0: row 0 the stratified uniform (unused by
systematic), then the ``2d`` Box-Muller rows, then the chi-square rows.

The kernel searches the cdf a block of ``kernels.CDF_BLOCK`` slots at a
time, through a shared-memory window of at most ``kernels.CDF_WINDOW``
floats of the stretch between the block's first and last position
(``csrc/common.cuh``). Its propagate-and-reweight half takes the design
that ``ops.fused_step.step_path(d, k)`` names in the widths
``ops.fused_step.step_widths(d, k)``, the rule of the fused Metropolis
step: "tile" (d = k in {16, 32} and every shape wider than 16: 3xTF32
tensor-core tiles, ``csrc/tile_propagate.cuh`` and, at padded widths,
``csrc/wide_propagate.cuh``) or "thread" (``csrc/propagate.cuh``, the
block's Philox key and ``pscale`` formed once, in 32 bits). The plain
version is the same for both.

The TPU kernel's group-bound tables (``srows``, ``wcnt``, ``woff``,
``grows``, ``:383-411``) place Mosaic's DMA windows and are not ported;
``cdf128`` is not taken. ``tile`` and ``sr`` keep their JAX meaning in the
argument checks, so the same sizes are accepted and refused.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels
from cusmc_tpu_torch.ops.fused_step import (
    MAX_MXU_DIM,
    BitSource,
    _scalars,
    chi2_rows,
    propagate_reweight_plain,
    require_model,
    step_path,
    step_widths,
    to_uniform,
)
from cusmc_tpu_torch.ops.philox import philox_bits
from cusmc_tpu_torch.ops.random import MAX_INTEGER_DF

FOLD = 128
DEFAULT_TILE = 1024
DEFAULT_SROWS = 16
MODES = ("systematic", "stratified")


def cdf_auto_tile(n: int, dk: int) -> int:
    """The JAX package's tile per state dimension (``:316-331``): 1024 at
    d <= 8 and d > 32, 4096 at d <= 16, 2048 at d <= 32, falling to the
    largest 1024-multiple power of two dividing n."""
    if dk <= 8 or dk > 32:
        want = 1024
    elif dk <= 16:
        want = 4096
    else:
        want = 2048
    t = 1024
    while t * 2 <= min(want, n // 2) and n % (t * 2) == 0:
        t *= 2
    return t if n % t == 0 else 1024


def fused_cdf_filter_step_draws(gen: Optional[torch.Generator], device=None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u, seed)``: the systematic offset (0-dim float32 in [0, 1)) and
    the Philox seed pair [2] int32 (``:379-381``), on the device."""
    u = torch.rand((), generator=gen, dtype=torch.float32, device=device)
    seed = torch.randint(-(1 << 31), 1 << 31, (2,), generator=gen,
                         dtype=torch.int64, device=device).to(torch.int32)
    return u, seed


def check_cdf_step_args(d: int, k: int, n: int, *, dtype, cdf_dtype,
                        noise: str, df, mode: str, tile: int, sr: int,
                        df_int) -> None:
    """The ValueErrors of ``fused_cdf_step.py:354-373``."""
    if n % tile != 0 or tile % (8 * FOLD) != 0:
        raise ValueError(f"N={n} must be divisible by tile={tile}, tile "
                         f"by {8 * FOLD} (whole query groups)")
    if n < 2 * sr * FOLD or n % FOLD != 0:
        raise ValueError(f"N={n} too small for the {sr * FOLD}-element "
                         f"window walk")
    if n > 1 << 24:
        raise ValueError(f"N={n} > 2^24: slot indices are no longer exact "
                         f"in float32")
    if max(d, k) > MAX_MXU_DIM:
        raise ValueError(f"fused cdf step supports d,k <= {MAX_MXU_DIM}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if dtype != torch.float32 or cdf_dtype != torch.float32:
        raise ValueError("fused cdf step is float32-only")
    if df_int is not None and not 1 <= df_int <= MAX_INTEGER_DF:
        raise ValueError(f"df_int={df_int} outside [1, {MAX_INTEGER_DF}]")
    if noise not in ("mvn", "mvt"):
        raise ValueError(f"unknown noise {noise!r}")
    if noise == "mvt" and df is None:
        raise ValueError("mvt noise needs df")


def fused_cdf_filter_step_plain(cdf, X, y, G, Q, F, Li, df, log_norm,
                                draws, *, noise: str = "mvn",
                                mode: str = "systematic",
                                tile: Optional[int] = None,
                                sr: int = DEFAULT_SROWS,
                                df_int: Optional[int] = None,
                                bits: Optional[BitSource] = None):
    """The plain version of the kernel, on any device; ``bits`` as in
    ``fused_step.fused_filter_step_plain``."""
    bits = philox_bits if bits is None else bits
    d, n = X.shape
    dev = X.device
    if tile is None:
        tile = cdf_auto_tile(n, max(d, F.shape[0]))
    u, seed = draws
    nrows = 1 + 2 * d + chi2_rows(noise, df_int)
    rows = bits(seed, torch.arange(n // tile, device=dev), 0, nrows,
                torch.arange(tile, device=dev)).reshape(nrows, n)
    # A true division: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, an ulp off fl(total / N) unless N is a power of 2.
    pscale = cdf[-1] / torch.tensor(float(n), dtype=torch.float32,
                                    device=dev)
    ug = to_uniform(rows[0]) if mode == "stratified" else u
    pos = (torch.arange(n, dtype=torch.float32, device=dev) + ug) * pscale
    a = torch.searchsorted(cdf, pos, right=True).clamp_(max=n - 1)
    df_t, ln_t = _scalars(df, log_norm, dev)
    x_new, ll, _ = propagate_reweight_plain(
        X.index_select(1, a), rows[1:1 + 2 * d], rows[1 + 2 * d:], y, G, Q,
        F, Li, df_t, ln_t, noise, df_int)
    return x_new, ll, a.to(torch.int32)


def fused_cdf_filter_step(cdf, X, y, G, Q, F, Li, df, log_norm, draws, *,
                          noise: str = "mvn", mode: str = "systematic",
                          tile: Optional[int] = None,
                          sr: int = DEFAULT_SROWS,
                          df_int: Optional[int] = None):
    """One fused systematic/stratified step. ``cdf`` [N] is the
    unnormalised inclusive weight cumsum (``ops/cumsum.blocked_cumsum``),
    ``X`` [d, N], ``draws = (u, seed)`` from
    ``fused_cdf_filter_step_draws``; ``df`` (None for MVN) and
    ``log_norm`` floats. Returns ``(X_new [d, N], ll [N], ancestors [N]
    int32)``.

    CUDA: the kernel (float32, contiguous); CPU: the plain version.
    ``fused_cdf_filter_step.launches`` counts kernel launches."""
    d, n = X.shape
    k = F.shape[0]
    if tile is None:
        tile = cdf_auto_tile(n, max(d, k))
    check_cdf_step_args(d, k, n, dtype=X.dtype, cdf_dtype=cdf.dtype,
                        noise=noise, df=df, mode=mode, tile=tile, sr=sr,
                        df_int=df_int)
    if not is_cuda(X, "fused_cdf_filter_step"):
        return fused_cdf_filter_step_plain(
            cdf, X, y, G, Q, F, Li, df, log_norm, draws, noise=noise,
            mode=mode, tile=tile, sr=sr, df_int=df_int)
    dev = X.device
    u, seed = draws
    require_model(X, y, G, Q, F, Li, seed)
    kernels.require(cdf, "cdf", torch.float32, 1, dev)
    kernels.require(u, "u", torch.float32, 0, dev)
    if cdf.shape[0] != n:
        raise ValueError(f"cdf [{cdf.shape[0]}] does not match N={n}")
    tiled = step_path(d, k) == "tile"
    dm, km = step_widths(d, k)
    lib = kernels.library()
    x_new = torch.empty_like(X)
    ll = torch.empty((n,), dtype=torch.float32, device=dev)
    a = torch.empty((n,), dtype=torch.int32, device=dev)
    rc = lib.cusmc_fused_cdf_step(
        cdf.data_ptr(), X.data_ptr(), y.data_ptr(), G.data_ptr(),
        Q.data_ptr(), F.data_ptr(), Li.data_ptr(), u.data_ptr(),
        seed.data_ptr(), x_new.data_ptr(), ll.data_ptr(), a.data_ptr(), n,
        tile, d, k, MODES.index(mode), int(noise == "mvt"),
        0 if df_int is None else df_int, 1.0 if df is None else float(df),
        float(log_norm), int(tiled), dm, km, kernels.stream_of(X))
    kernels.check(rc, "fused_cdf_filter_step")
    fused_cdf_filter_step.launches += 1
    return x_new, ll, a


fused_cdf_filter_step.launches = 0
