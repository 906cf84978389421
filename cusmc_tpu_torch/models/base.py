"""State-space model protocol.

Port of ``cusmc_tpu/models/base.py``. Any object with these methods runs
through the filter; ``DLM`` is the first instance.

Required (batch layout, x as [N, d]):
    sample_initial(gen, shape) -> x0 [*shape, d]
    propagate(gen, x_prev)     -> x  [N, d]
    observation_logpdf(y, x)   -> ll [N]
    state_dim: int

Optional (packed layout, x as [d, N]; the filter's fast path):
    sample_initial_packed(gen, n) -> [d, n]
    propagate_packed(gen, X)      -> [d, n]
    observation_logpdf_packed(y, X) -> [n]

A ``gen`` is a ``torch.Generator`` where the JAX protocol takes a key.
``CustomSSM`` adapts plain functions to the protocol; the filter runs it in
the batch layout. ``normalize_time_hook`` gives the filter's steps one
form of hook for time-invariant and time-varying models. ``draw`` calls a
sampling method on its generator or, replayed, on given noise.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable, Optional


def supports_packed(model) -> bool:
    return (hasattr(model, "sample_initial_packed")
            and hasattr(model, "propagate_packed")
            and hasattr(model, "observation_logpdf_packed"))


@dataclass(frozen=True)
class CustomSSM:
    """User functions as a state-space model (batch layout only; the
    filter's ``layout="auto"`` picks "batch" for it). Each function takes
    ``params`` first: ``sample_initial(params, gen, shape)``,
    ``propagate(params, gen, x_prev)``, ``observation_logpdf(params, y,
    x)``."""

    params: dict
    dim: int
    _sample_initial: Callable = field(repr=False)
    _propagate: Callable = field(repr=False)
    _observation_logpdf: Callable = field(repr=False)

    @classmethod
    def create(cls, dim: int, sample_initial: Callable, propagate: Callable,
               observation_logpdf: Callable,
               params: Optional[dict] = None) -> "CustomSSM":
        return cls(params=params or {}, dim=dim,
                   _sample_initial=sample_initial, _propagate=propagate,
                   _observation_logpdf=observation_logpdf)

    @property
    def state_dim(self) -> int:
        return self.dim

    def sample_initial(self, gen, shape):
        return self._sample_initial(self.params, gen, shape)

    def propagate(self, gen, x_prev):
        return self._propagate(self.params, gen, x_prev)

    def observation_logpdf(self, y, x):
        return self._observation_logpdf(self.params, y, x)


def draw(fn: Callable, gen, *args, noise=None):
    """``fn(gen, *args)``, or ``fn(None, *args, noise=noise)`` when
    ``noise`` is given: a model's sampling method on its generator, or on
    replayed draws (the models' ``noise=`` keyword)."""
    if noise is None:
        return fn(gen, *args)
    return fn(None, *args, noise=noise)


def normalize_time_hook(fn: Callable, kind: str) -> Callable:
    """A model hook in the 3-argument form of the filter's steps:
    propagate ``(gen, X, t)`` (``kind="x"``), logpdf ``(y, X, t)``
    (``kind="y"``). A hook with a parameter named ``t`` (a time-varying
    model) receives the step, 1..T-1; any other hook is called without it.
    Keyword arguments (the replayed ``noise=`` of the tests) pass through.
    The filter wraps its hooks once, before its loop.

    A hook whose signature cannot be read raises ``TypeError``: the JAX
    package treats it as time-invariant, which would silently drop ``t``
    from a time-varying one."""
    try:
        takes_t = "t" in inspect.signature(fn).parameters
    except (TypeError, ValueError) as err:
        raise TypeError(f"cannot read the signature of the {kind!r} hook "
                        f"{fn!r}, so whether it takes the step t is "
                        f"unknown; wrap it in a function that declares "
                        f"its parameters") from err
    if takes_t:
        return lambda a, x, t, **kw: fn(a, x, t=t, **kw)
    return lambda a, x, t, **kw: fn(a, x, **kw)
