"""The resampler registry.

Port of ``cusmc_tpu/resampling/__init__.py:22-41``. A resampler is
``fn(gen, log_weights, **draws) -> ancestors`` int32 [N]: it draws from
the ``torch.Generator`` ``gen`` unless its draws are given by keyword
(``u=`` for the CDF family and residual, ``j=`` and ``u=`` for
metropolis), which is how the tests replay JAX's numbers. The five
built-in keys are the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

from cusmc_tpu_torch.resampling.classic import (
    multinomial_ancestors,
    residual_ancestors,
    stratified_ancestors,
    systematic_ancestors,
)
from cusmc_tpu_torch.resampling.metropolis import metropolis_ancestors

Resampler = Callable[..., "torch.Tensor"]  # (gen, log_weights) -> [N]

RESAMPLERS: Dict[str, Resampler] = {}


def register_resampler(name: str, fn: Resampler) -> None:
    RESAMPLERS[name] = fn


def get_resampler(name: str, **kwargs) -> Resampler:
    """Look up a resampler by key; ``kwargs`` (e.g. ``num_steps`` for
    metropolis) are bound, so the result is ``fn(gen, log_weights)``."""
    if name not in RESAMPLERS:
        raise KeyError(f"unknown resampler {name!r}; have "
                       f"{sorted(RESAMPLERS)}")
    fn = RESAMPLERS[name]
    return functools.partial(fn, **kwargs) if kwargs else fn


register_resampler("metropolis", metropolis_ancestors)
register_resampler("systematic", systematic_ancestors)
register_resampler("stratified", stratified_ancestors)
register_resampler("multinomial", multinomial_ancestors)
register_resampler("residual", residual_ancestors)

__all__ = [
    "RESAMPLERS",
    "get_resampler",
    "register_resampler",
    "metropolis_ancestors",
    "systematic_ancestors",
    "stratified_ancestors",
    "multinomial_ancestors",
    "residual_ancestors",
]
