"""Inverse-CDF search and column gathers for the resamplers.

Port of ``cusmc_tpu/ops/monotone_gather.py``: ``inverse_cdf_apply``
(``:648-768``, the ``_search_kernel`` at ``:277``, with its sharded
``local_base`` mode), ``inverse_cdf_search`` (``:497-560``, the
``_search_only_kernel`` at ``:422``) and ``take_columns`` (``:575-646``,
the ``_take_kernel`` at ``:204`` and its ``jnp.take`` fallback). On a CUDA
tensor each launches its kernel in ``csrc/monotone_gather.cu``: for
``inverse_cdf_search`` and ``inverse_cdf_apply`` a block of
``SEARCH_BLOCK`` queries searched through a shared-memory window of at
most ``SEARCH_WINDOW`` floats of the stretch of the cdf between their
smallest and largest (``csrc/common.cuh``; ``window_fit_share`` says how
many blocks' stretches fit), ``inverse_cdf_apply`` then gathering each
query's d values; for ``take_columns`` one thread per output column and
band of 2 state rows, the bands in order. On a
CPU tensor each takes its plain version, ``torch.searchsorted``,
``index_select`` and a clip. ``inverse_cdf_apply`` (in both modes) and
``take_columns`` gather a float32 or a bfloat16 (mixed-precision) state
through the same kernel; the JAX wrappers send a bfloat16 state to XLA's
gather (``cusmc_tpu/ops/monotone_gather.py:96-102``), which the port does
not.

The JAX wrappers' coarse placement (an argsort over the 128-strided cdf),
merge-path windows and ``take_columns``' runtime monotonicity check are TPU
workarounds and are not ported: the window search and the gathers take
any query or ancestor order (order costs speed only). Each wrapper counts
its kernel launches in ``.launches``; ``inverse_cdf_apply`` counts
local-block launches apart, in ``.local_launches``, and launches on a
bfloat16 state apart again, in ``.bf16_launches`` (global mode) and
``.bf16_local_launches``; ``take_columns`` counts them in
``.bf16_launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels
from cusmc_tpu_torch.ops.kernels import SEARCH_BLOCK, SEARCH_WINDOW


def inverse_cdf_search_plain(cdf: torch.Tensor,
                             positions: torch.Tensor) -> torch.Tensor:
    """The plain version: searchsorted (right) clipped to N-1, int32."""
    n = cdf.shape[0]
    a = torch.searchsorted(cdf, positions.to(cdf.dtype), right=True)
    return a.clamp_(max=n - 1).to(torch.int32)


def take_columns_plain(X: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The plain version: ``X[:, clip(a, 0, n-1)]``."""
    return X.index_select(1, a.long().clamp(0, X.shape[1] - 1))


def inverse_cdf_apply_plain(cdf: torch.Tensor, positions: torch.Tensor,
                            X: torch.Tensor, local_base: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the search, then the (clipped local) gather."""
    a = inverse_cdf_search_plain(cdf, positions)
    rel = a.long()
    if local_base is not None:
        rel = (rel - local_base).clamp_(0, X.shape[1] - 1)
    return X.index_select(1, rel), a


def block_spans(cdf: torch.Tensor, positions: torch.Tensor,
                block: int = SEARCH_BLOCK, ends: bool = False) -> torch.Tensor:
    """The stretch of the cdf that each block of a block-window search can
    land on, as a count of entries: blocks of ``block`` consecutive queries,
    bounded by their min and max (``ends``: by their first and last query,
    as the fused inverse-CDF step bounds its sorted positions), span
    ``#{cdf <= max} - #{cdf <= min}``. A ragged last block is padded with
    its own first query."""
    nb = -(-positions.numel() // block)
    pad = positions[(nb - 1) * block].expand(nb * block - positions.numel())
    q = torch.cat([positions, pad]).reshape(nb, block)
    if ends:
        lo_p, hi_p = q[:, 0], q[:, -1]
    else:
        lo_p, hi_p = q.min(1).values, q.max(1).values
    lo = torch.searchsorted(cdf, lo_p.contiguous(), right=True)
    hi = torch.searchsorted(cdf, hi_p.contiguous(), right=True)
    return hi - lo


def window_fit_share(cdf: torch.Tensor, positions: torch.Tensor,
                     block: int = SEARCH_BLOCK, window: int = SEARCH_WINDOW,
                     ends: bool = False) -> float:
    """The share of a block-window search's blocks whose stretch of the cdf
    (``block_spans``) fits its shared window of ``window`` floats. The
    defaults are the search-only and search-and-apply kernels';
    ``kernels.CDF_BLOCK`` and
    ``kernels.CDF_WINDOW`` with ``ends=True`` are the fused inverse-CDF
    step's."""
    spans = block_spans(cdf, positions, block, ends)
    # A diagnostic of the kernels' inputs, off a filter run's path.
    return float((spans <= window).float().mean())


def _check_cdf(cdf: torch.Tensor, positions: torch.Tensor) -> None:
    dev = cdf.device
    kernels.require(cdf, "cdf", torch.float32, 1, dev)
    kernels.require(positions, "positions", torch.float32, 1, dev)
    if cdf.shape[0] < 1:
        raise ValueError("the cdf needs N >= 1")


def inverse_cdf_search(cdf: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Ancestors ``a[i] = #{j: cdf[j] <= positions[i]}`` clipped to N-1,
    int32 [L], over the inclusive cumsum ``cdf`` [N]; L need not equal N
    (the sharded filter searches its L queries in the gathered global
    cdf), and the queries need not be sorted. CUDA: the kernel (float32,
    contiguous); CPU: the plain version."""
    if not is_cuda(cdf, "inverse_cdf_search"):
        return inverse_cdf_search_plain(cdf, positions)
    _check_cdf(cdf, positions)
    nq = positions.shape[0]
    a = torch.empty((nq,), dtype=torch.int32, device=cdf.device)
    if nq == 0:
        return a
    rc = kernels.library().cusmc_inverse_cdf_search(
        cdf.data_ptr(), positions.data_ptr(), a.data_ptr(), cdf.shape[0], nq,
        kernels.stream_of(cdf))
    kernels.check(rc, "inverse_cdf_search")
    inverse_cdf_search.launches += 1
    return a


TAKE_MAX_ROWS = 2 * 65535  # two rows a band, one grid row a band


def take_columns(X: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``X[:, a]`` [d, M] for X [d, n] and int32 ancestors ``a`` [M] in
    any order. An index outside [0, n) is clipped to it, in the kernel and
    in the plain version alike; callers clip first. CUDA: the kernel
    (a float32 or bfloat16 X, contiguous; launches on a bfloat16 X count
    in ``.bf16_launches``); CPU: the plain version."""
    if not is_cuda(X, "take_columns"):
        return take_columns_plain(X, a)
    dev = X.device
    bf16 = kernels.require_state(X, "X", dev)
    kernels.require(a, "a", torch.int32, 1, dev)
    d, n = X.shape
    if n < 1:
        raise ValueError("take_columns needs a source of n >= 1 columns")
    if d > TAKE_MAX_ROWS:
        raise ValueError(f"take_columns takes at most {TAKE_MAX_ROWS} rows "
                         f"(the kernel's grid has one y-block a band of 2 "
                         f"rows), got {d}")
    m = a.shape[0]
    out = torch.empty((d, m), dtype=X.dtype, device=dev)
    if m == 0 or d == 0:
        return out
    rc = kernels.library().cusmc_take_columns(
        X.data_ptr(), a.data_ptr(), out.data_ptr(), n, m, d, bf16,
        kernels.stream_of(X))
    kernels.check(rc, "take_columns")
    if bf16:
        take_columns.bf16_launches += 1
    else:
        take_columns.launches += 1
    return out


def inverse_cdf_apply(cdf: torch.Tensor, positions: torch.Tensor,
                      X: torch.Tensor, local_base: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(X[:, a], a)`` with ``a[i] = #{j: cdf[j] <= positions[i]}``
    clipped to N-1, int32.

    ``cdf`` [N] is an inclusive weight cumsum, monotone, not necessarily
    normalised (scale ``positions`` by ``cdf[-1]``); ``positions`` [L];
    ``X`` [d, N] packed particles.

    ``local_base`` (an int >= 0) is the local-block mode of the sharded
    ring exchange: ``cdf`` stays the global [N] cumsum, ``positions`` are
    this shard's queries, and ``X`` [d, L] holds the global columns
    [local_base, local_base + L). Ancestors come back in global indices;
    value i is ``X[:, clip(a[i] - local_base, 0, L-1)]``, meaningful where
    the ancestor lies in the block (the caller masks the rest).

    CUDA: the kernel (float32 cdf and positions, a float32 or bfloat16
    ``X``, contiguous); CPU: the plain version. On a float32 state
    ``inverse_cdf_apply.launches`` counts global-mode launches,
    ``.local_launches`` local-block ones; ``.bf16_launches`` and
    ``.bf16_local_launches`` count them on a bfloat16 state."""
    if not is_cuda(cdf, "inverse_cdf_apply"):
        return inverse_cdf_apply_plain(cdf, positions, X, local_base)
    _check_cdf(cdf, positions)
    dev = cdf.device
    bf16 = kernels.require_state(X, "X", dev)
    n = cdf.shape[0]
    d, nloc = X.shape
    nq = positions.shape[0]
    if local_base is None:
        base = 0
        if nloc != n:
            raise ValueError(f"X {tuple(X.shape)} does not match cdf [{n}]")
    else:
        base = int(local_base)
        if base < 0 or nloc < 1:
            raise ValueError(f"local block {tuple(X.shape)} at base {base}")
    out = torch.empty((d, nq), dtype=X.dtype, device=dev)
    a = torch.empty((nq,), dtype=torch.int32, device=dev)
    if nq == 0:
        return out, a
    rc = kernels.library().cusmc_inverse_cdf_apply(
        cdf.data_ptr(), positions.data_ptr(), X.data_ptr(), out.data_ptr(),
        a.data_ptr(), n, nq, nloc, base, d, bf16, kernels.stream_of(cdf))
    kernels.check(rc, "inverse_cdf_apply")
    counter = ("bf16_" if bf16 else "") + (
        "launches" if local_base is None else "local_launches")
    setattr(inverse_cdf_apply, counter,
            getattr(inverse_cdf_apply, counter) + 1)
    return out, a


inverse_cdf_search.launches = 0
take_columns.launches = 0
take_columns.bf16_launches = 0
inverse_cdf_apply.launches = 0
inverse_cdf_apply.local_launches = 0
inverse_cdf_apply.bf16_launches = 0
inverse_cdf_apply.bf16_local_launches = 0
