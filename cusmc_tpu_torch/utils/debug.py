"""Debug and validation helpers.

Port of ``cusmc_tpu/utils/debug.py``: ``FilterDivergedError`` (``:30-42``),
``debug_mode`` (``:45-49``), ``assert_finite_weights`` (``:52-65``, the
weight guard of ``bootstrap_filter(debug_checks=True)``) and
``validate_dlm_inputs`` (``:68-89``). ``count_primitive`` (a jaxpr walk,
used by a sharded test) has no counterpart yet (ROADMAP queue 1, item 16).

``debug_mode`` stands for ``jax.debug_nans``: torch has no global switch
that raises where a NaN is made, so the filter loops check each step's
state, weights and evidence increment while the context is open
(``nan_checks_enabled``, ``raise_on_nan``) and raise ``FloatingPointError``
naming the step. The switch is a context variable: it holds for the
thread (or task) that opened the context, and closing it restores the
state before.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch


class FilterDivergedError(RuntimeError):
    """The filter state degenerated (NaN weights, a collapsed cloud).
    Carries the last step with a verified-finite state and, when a
    checkpoint was wired, the path of the snapshot to resume from."""

    def __init__(self, message: str, last_good_step: int,
                 snapshot: Optional[str] = None):
        super().__init__(message)
        self.last_good_step = last_good_step
        self.snapshot = snapshot


_NAN_CHECKS = contextvars.ContextVar("cusmc_tpu_torch_nan_checks",
                                     default=False)


@contextlib.contextmanager
def debug_mode(disable_jit: bool = False):
    """Check every filter step for NaN within the scope (the counterpart
    of ``jax.debug_nans``). ``disable_jit`` is accepted for the JAX
    package's signature; torch runs op by op already, so it changes
    nothing."""
    del disable_jit
    token = _NAN_CHECKS.set(True)
    try:
        yield
    finally:
        _NAN_CHECKS.reset(token)


def nan_checks_enabled() -> bool:
    """True inside ``debug_mode()``."""
    return _NAN_CHECKS.get()


def raise_on_nan(t: int, **tensors: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` naming step ``t`` and the tensors that
    hold a NaN (one host read for all of them)."""
    names = list(tensors)
    flags = torch.stack([torch.isnan(v).any() for v in tensors.values()]
                        ).tolist()
    bad = [name for name, flag in zip(names, flags) if flag]
    if bad:
        raise FloatingPointError(
            f"NaN in the filter's {', '.join(bad)} at step {t}")


def assert_finite_weights(logw: torch.Tensor, t=None) -> None:
    """Print a diagnostic when the weights degenerate: any NaN (a numeric
    fault upstream) or all -inf (the filter lost track). It prints and
    does not raise, as the JAX guard does; it reads two flags back to the
    host, once a call."""
    bad_nan, all_ninf = torch.stack([torch.any(torch.isnan(logw)),
                                     torch.all(torch.isneginf(logw))]
                                    ).tolist()
    if bad_nan or all_ninf:
        print(f"cusmc_tpu_torch weight guard: nan={bad_nan} "
              f"collapsed={all_ninf} at t={-1 if t is None else t}")


def validate_dlm_inputs(F, G, m0, C0, V, W, df=None, distribution="mvn"):
    """Host-side validation; raises ValueError naming the bad argument."""
    F, G, m0, C0, V, W = (np.asarray(a.detach().cpu() if isinstance(
        a, torch.Tensor) else a) for a in (F, G, m0, C0, V, W))
    d = m0.shape[0]
    k = F.shape[0]
    checks = [
        ("G", G, (d, d)), ("C0", C0, (d, d)), ("W", W, (d, d)),
        ("F", F, (k, d)), ("V", V, (k, k)),
    ]
    for name, arr, shape in checks:
        if arr.shape != shape:
            raise ValueError(f"{name} has shape {arr.shape}, expected {shape}")
    for name, arr in (("C0", C0), ("W", W), ("V", V)):
        if not np.allclose(arr, arr.T, atol=1e-6):
            raise ValueError(f"{name} is not symmetric")
        if np.linalg.eigvalsh(arr).min() < -1e-8:
            raise ValueError(f"{name} is not positive semi-definite")
    if distribution == "mvt":
        if df is None:
            raise ValueError("distribution='mvt' requires df")
        if float(df) <= 0:
            raise ValueError(f"df must be positive, got {df}")
