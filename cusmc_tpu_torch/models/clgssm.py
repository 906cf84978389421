"""Conditionally linear-Gaussian state-space model (CLGSSM).

Port of ``cusmc_tpu/models/clgssm.py:41-110``, the model family of the
Rao-Blackwellized particle filter (``smc/rbpf.py``)::

    u_t ~ f(u_t | u_{t-1})                                  (nonlinear, sampled)
    z_t = G(u_t) z_{t-1} + b(u_t) + w_t,  w_t ~ N(0, W(u_t))  (linear, marginalized)
    y_t = F(u_t) z_t     + c(u_t) + v_t,  v_t ~ N(0, V(u_t))

A frozen dataclass, as ``models.base.CustomSSM`` is. The nonlinear
samplers are vectorised over particles: ``sample_initial_nl(params, gen,
n) -> u0 [n, p]`` and ``propagate_nl(params, gen, u_prev [n, p]) -> u [n,
p]``, with ``gen`` a ``torch.Generator``. The conditional-matrix callables
``Fmat/Gmat/Vcov/Wcov/b/c`` take ``(params, u)`` for ONE particle's ``u
[p]`` and return ``[k, dz] / [dz, dz] / [k, k] / [dz, dz] / [dz] / [k]``;
the filter maps them over the particles with ``torch.func.vmap``. That asks
of a callable what vmap asks: torch operations on ``u`` and on tensors of
``params`` (on the model's device), no Python branching on their values,
no ``.item()`` and no in-place writes into ``u``. A callable that does not
use ``u`` (a constant matrix) is broadcast over the particles.
``mats_constant=True`` says that F, G, V and W do not depend on u (only
b and c do): the filter then evaluates them once, at a zero ``u``, and runs
one shared covariance recursion.

``params`` is a dict of tensors; ``params_from_numpy(params, device)``
carries a JAX model's params across.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from cusmc_tpu_torch.device import as_tensor, resolve_device


def params_from_numpy(params: Optional[dict], device=None) -> dict:
    """A dict of arrays (a JAX model's ``params``, say) as tensors on
    ``device`` (None: the card), each keeping its dtype. A tensor is
    moved where it lies, never routed through numpy."""
    dev = resolve_device(device)
    return {k: v.to(dev) if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in (params or {}).items()}


@dataclass(frozen=True)
class CLGSSM:
    """Immutable CLGSSM spec (see the module docstring for the callables'
    contract)."""

    params: dict
    m0: torch.Tensor               # [dz] linear-substate prior mean
    C0: torch.Tensor               # [dz, dz] its prior covariance
    nl_dim: int
    lin_dim: int
    obs_dim: int
    mats_constant: bool
    _sample_initial_nl: Callable = field(repr=False)
    _propagate_nl: Callable = field(repr=False)
    _Fmat: Callable = field(repr=False)
    _Gmat: Callable = field(repr=False)
    _Vcov: Callable = field(repr=False)
    _Wcov: Callable = field(repr=False)
    _b: Callable = field(repr=False)
    _c: Callable = field(repr=False)

    @classmethod
    def create(cls, nl_dim: int, lin_dim: int, obs_dim: int,
               sample_initial_nl: Callable, propagate_nl: Callable,
               Fmat: Callable, Gmat: Callable, Vcov: Callable, Wcov: Callable,
               m0, C0, b: Optional[Callable] = None,
               c: Optional[Callable] = None, params: Optional[dict] = None,
               mats_constant: bool = False, dtype=torch.float32,
               device=None) -> "CLGSSM":
        """``m0`` and ``C0`` go to ``device`` (None: the card, raising
        without one) as ``dtype``; b and c default to zero offsets."""
        dev = resolve_device(device)
        if b is None:
            def b(p, u):
                return torch.zeros((lin_dim,), dtype=u.dtype,
                                   device=u.device)
        if c is None:
            def c(p, u):
                return torch.zeros((obs_dim,), dtype=u.dtype,
                                   device=u.device)

        return cls(params=params or {}, m0=as_tensor(m0, dtype, dev),
                   C0=as_tensor(C0, dtype, dev), nl_dim=nl_dim,
                   lin_dim=lin_dim, obs_dim=obs_dim,
                   mats_constant=mats_constant,
                   _sample_initial_nl=sample_initial_nl,
                   _propagate_nl=propagate_nl, _Fmat=Fmat, _Gmat=Gmat,
                   _Vcov=Vcov, _Wcov=Wcov, _b=b, _c=c)

    def replace(self, **changes) -> "CLGSSM":
        """A copy with fields replaced (flax's ``replace``)."""
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.m0.device

    # --- nonlinear substate -----------------------------------------------
    def sample_initial_nl(self, gen, n: int) -> torch.Tensor:
        return self._sample_initial_nl(self.params, gen, n)

    def propagate_nl(self, gen, u_prev: torch.Tensor) -> torch.Tensor:
        return self._propagate_nl(self.params, gen, u_prev)

    # --- conditional system matrices (one particle's u [p]) ---------------
    def Fmat(self, u):
        return self._Fmat(self.params, u)

    def Gmat(self, u):
        return self._Gmat(self.params, u)

    def Vcov(self, u):
        return self._Vcov(self.params, u)

    def Wcov(self, u):
        return self._Wcov(self.params, u)

    def b(self, u):
        return self._b(self.params, u)

    def c(self, u):
        return self._c(self.params, u)
