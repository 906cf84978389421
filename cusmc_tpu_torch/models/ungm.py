"""The univariate nonlinear growth model (UNGM), the canonical nonlinear
particle-filter benchmark (Gordon, Salmond & Smith 1993; Kitagawa 1996).

Port of ``cusmc_tpu/models/ungm.py:28-80``::

    x_t = x_{t-1}/2 + 25 x_{t-1} / (1 + x_{t-1}^2) + 8 cos(1.2 t) + w,
    y_t = x_t^2 / 20 + v,     w ~ N(0, q), v ~ N(0, r).

Time enters the dynamics, so the packed hooks take ``t``: the filter's
steps pass the step through (``models.base.normalize_time_hook``). As in
the JAX package the model has only the packed methods (state [1, N]), so
``bootstrap_filter`` runs it on the fast exp-space step.

An ``nn.Module`` with 0-dim buffers ``q``, ``r`` and ``x0_std``. Each
sampling method takes a ``torch.Generator`` and, in place of its draws,
``noise=(z,)``; ``simulate`` takes ``noise=(z0 [], zx [T-1], zy [T-1])``,
the normals of JAX's key schedule (``k0, key = split(key)``; per step
``kp, ko = split(k_t)``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from cusmc_tpu_torch.device import as_tensor, resolve_device
from cusmc_tpu_torch.models.stochvol import _z
from cusmc_tpu_torch.ops.random import normal


class UNGM(nn.Module):
    """UNGM with process variance ``q``, observation variance ``r`` and
    initial standard deviation ``x0_std``, 0-dim buffers of one dtype."""

    def __init__(self, q, r, x0_std):
        super().__init__()
        for name, val in (("q", q), ("r", r), ("x0_std", x0_std)):
            self.register_buffer(name, val)

    @classmethod
    def create(cls, q: float = 10.0, r: float = 1.0, x0_std: float = 2.0,
               dtype=torch.float32, device=None) -> "UNGM":
        """The model on ``device`` (None: the card, raising without one);
        a parameter may be a tensor on any device, as in
        ``StochasticVolatility.create``."""
        dev = resolve_device(device)
        return cls(*(as_tensor(v, dtype, dev).reshape(())
                     for v in (q, r, x0_std)))

    @classmethod
    def from_jax_arrays(cls, *, q, r, x0_std, device=None) -> "UNGM":
        """Carry a JAX model's leaves across as numpy arrays."""
        dev = resolve_device(device)
        return cls(*(torch.from_numpy(np.array(v, copy=True)).to(dev)
                     for v in (q, r, x0_std)))

    @property
    def state_dim(self) -> int:
        return 1

    @property
    def device(self) -> torch.device:
        return self.q.device

    def sample_initial_packed(self, gen: Optional[torch.Generator], n: int,
                              noise: Optional[tuple] = None) -> torch.Tensor:
        return self.x0_std * _z(gen, noise, (1, n), self.q)

    def propagate_packed(self, gen: Optional[torch.Generator],
                         X: torch.Tensor, t=None,
                         noise: Optional[tuple] = None) -> torch.Tensor:
        """X [1, N] -> [1, N]; ``t`` the step (0 when absent)."""
        tt = torch.as_tensor(0.0 if t is None else t, dtype=X.dtype,
                             device=X.device)
        drift = 0.5 * X + 25.0 * X / (1.0 + X * X) \
            + 8.0 * torch.cos(1.2 * tt)
        return drift + torch.sqrt(self.q) * _z(gen, noise, X.shape, X)

    def observation_logpdf_packed(self, y: torch.Tensor, X: torch.Tensor,
                                  t=None) -> torch.Tensor:
        """y of one element, X [1, N] -> [N]."""
        mu = X[0] * X[0] / 20.0
        resid = torch.as_tensor(y, dtype=X.dtype,
                                device=X.device).reshape(()) - mu
        return -0.5 * (resid * resid / self.r
                       + torch.log(2.0 * math.pi * self.r))

    def simulate(self, gen: Optional[torch.Generator], num_steps: int,
                 noise: Optional[tuple] = None):
        """(xs [T], ys [T, 1]); row 0 holds the initial state and a zero
        placeholder observation (the filter's convention)."""
        m = num_steps - 1
        dt, dev = self.q.dtype, self.device
        if noise is None:
            noise = tuple(normal(gen, s, dt, dev) for s in ((), (m,), (m,)))
        z0, zx, zy = noise
        x = self.x0_std * z0
        xs, ys = [x], [torch.zeros((), dtype=dt, device=dev)]
        for i in range(m):
            x = self.propagate_packed(None, x.reshape(1, 1), float(i + 1),
                                      noise=(zx[i].reshape(1, 1),))[0, 0]
            xs.append(x)
            ys.append(x * x / 20.0 + torch.sqrt(self.r) * zy[i])
        return torch.stack(xs), torch.stack(ys)[:, None]
