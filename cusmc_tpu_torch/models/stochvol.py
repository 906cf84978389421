"""Stochastic volatility model, the second concrete model family.

Port of ``cusmc_tpu/models/stochvol.py:27-112``::

    x_0 ~ N(mu, sigma^2 / (1 - phi^2))          (stationary prior)
    x_t = mu + phi (x_{t-1} - mu) + sigma eta_t
    y_t ~ N(0, beta^2 exp(x_t))                 (volatility observation)

The state is univariate (d = 1). The batch methods take x [..., 1], the
packed ones X [1, N]; with the packed methods ``bootstrap_filter`` runs the
fast exp-space step, so the roll walk, or the cumsum and the
search-and-apply, see a state of one row.

``StochasticVolatility`` is an ``nn.Module`` whose four scalar parameters
are 0-dim buffers, so ``.to(device)`` moves it and ``device`` says where it
lives. Every sampling method takes a ``torch.Generator`` and, in place of
its draws, ``noise=(z,)``: the standard normals it would draw (shape of its
output), so that tests can hand in JAX's numbers. ``simulate`` takes
``noise=(z0 [1], zx [T-1, 1], zy [T-1])``, the normals of JAX's key
schedule (``k0, key = split(key)``; per step ``kp, ko = split(k_t)``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from cusmc_tpu_torch.device import as_tensor, resolve_device
from cusmc_tpu_torch.ops.random import normal

_LOG_2PI = math.log(2.0 * math.pi)


def _z(gen, noise, shape, like: torch.Tensor) -> torch.Tensor:
    """The normals of one draw: ``noise[0]`` when given, else drawn."""
    if noise is not None:
        return noise[0]
    return normal(gen, shape, like.dtype, like.device)


class StochasticVolatility(nn.Module):
    """SV-AR(1) model; ``mu``, ``phi``, ``sigma`` and ``beta`` are 0-dim
    buffers of one dtype."""

    def __init__(self, mu, phi, sigma, beta):
        super().__init__()
        for name, val in (("mu", mu), ("phi", phi), ("sigma", sigma),
                          ("beta", beta)):
            self.register_buffer(name, val)

    @classmethod
    def create(cls, mu=-1.0, phi=0.95, sigma=0.3, beta=1.0,
               dtype=torch.float32, device=None) -> "StochasticVolatility":
        """The model on ``device`` (None: the card, raising without one;
        the CPU only when asked for, ``device="cpu"``). A parameter may be
        a 0-dim (or one-element) tensor on any device, a PMMH
        ``model_builder``'s theta on the card: it is moved, never read
        back to the host."""
        dev = resolve_device(device)
        return cls(*(as_tensor(v, dtype, dev).reshape(())
                     for v in (mu, phi, sigma, beta)))

    @classmethod
    def from_jax_arrays(cls, *, mu, phi, sigma, beta,
                        device=None) -> "StochasticVolatility":
        """Carry a JAX model's leaves across as numpy arrays
        (``np.asarray(jax_model.mu)`` and so on); ``device`` as in
        ``create``."""
        dev = resolve_device(device)
        return cls(*(torch.from_numpy(np.array(v, copy=True)).to(dev)
                     for v in (mu, phi, sigma, beta)))

    @property
    def state_dim(self) -> int:
        return 1

    @property
    def obs_dim(self) -> int:
        return 1

    @property
    def device(self) -> torch.device:
        return self.mu.device

    def _stationary_sd(self) -> torch.Tensor:
        return self.sigma / torch.sqrt(1.0 - self.phi ** 2)

    # -- batch layout [N, 1] ---------------------------------------------

    def sample_initial(self, gen: Optional[torch.Generator], shape: tuple,
                       noise: Optional[tuple] = None) -> torch.Tensor:
        z = _z(gen, noise, tuple(shape) + (1,), self.mu)
        return self.mu + self._stationary_sd() * z

    def propagate(self, gen: Optional[torch.Generator], x_prev: torch.Tensor,
                  noise: Optional[tuple] = None) -> torch.Tensor:
        z = _z(gen, noise, x_prev.shape, x_prev)
        return self.mu + self.phi * (x_prev - self.mu) + self.sigma * z

    def propagate_mean(self, x_prev: torch.Tensor) -> torch.Tensor:
        """E[x_t | x_{t-1}], the auxiliary filter's lookahead point."""
        return self.mu + self.phi * (x_prev - self.mu)

    def observation_logpdf(self, y: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
        """log N(y; 0, beta^2 exp(x)) for y of one element and x [..., 1]."""
        return self._logpdf(y, x[..., 0])

    def _logpdf(self, y, x0):
        log_var = 2.0 * torch.log(self.beta) + x0
        y0 = torch.as_tensor(y, dtype=x0.dtype, device=x0.device).reshape(())
        return -0.5 * (_LOG_2PI + log_var + (y0 * y0) * torch.exp(-log_var))

    # -- packed layout [1, N] --------------------------------------------

    def sample_initial_packed(self, gen: Optional[torch.Generator], n: int,
                              noise: Optional[tuple] = None) -> torch.Tensor:
        z = _z(gen, noise, (1, n), self.mu)
        return self.mu + self._stationary_sd() * z

    def propagate_packed(self, gen: Optional[torch.Generator],
                         X: torch.Tensor,
                         noise: Optional[tuple] = None) -> torch.Tensor:
        z = _z(gen, noise, X.shape, X)
        return self.mu + self.phi * (X - self.mu) + self.sigma * z

    def observation_logpdf_packed(self, y: torch.Tensor,
                                  X: torch.Tensor) -> torch.Tensor:
        return self._logpdf(y, X[0])

    def sample_observation(self, gen: Optional[torch.Generator],
                           x: torch.Tensor,
                           noise: Optional[tuple] = None) -> torch.Tensor:
        """y | x ~ N(0, beta^2 exp(x)) for x [..., 1] -> [..., 1] (the
        forecast's predictive draw)."""
        scale = self.beta * torch.exp(0.5 * x[..., 0])
        return (scale * _z(gen, noise, scale.shape, x))[..., None]

    def simulate(self, gen: Optional[torch.Generator], num_steps: int,
                 noise: Optional[tuple] = None):
        """Latent path and observations, (xs [T, 1], ys [T, 1]); row 0 of
        ys is zero (the convention of the DLM's bundled trace)."""
        m = num_steps - 1
        if noise is None:
            noise = tuple(normal(gen, s, self.mu.dtype, self.device)
                          for s in ((1,), (m, 1), (m,)))
        z0, zx, zy = noise
        x = self.sample_initial(None, (), noise=(z0,))
        xs, ys = [x], [torch.zeros((1,), dtype=x.dtype, device=x.device)]
        for t in range(m):
            x = self.propagate(None, x, noise=(zx[t],))
            scale = self.beta * torch.exp(0.5 * x[..., 0])
            xs.append(x)
            ys.append((scale * zy[t])[None])
        return torch.stack(xs), torch.stack(ys)
