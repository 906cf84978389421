"""Structural time-series (DLM) builders: local level, trend, seasonal.

Port of ``cusmc_tpu/models/structural.py:28-113``, in float64 numpy as in
the JAX package. Each builder returns a ``Component`` in the standard block
form (West & Harrison 1997)::

    local_level():        x = [mu],            G = [1]
    local_linear_trend(): x = [mu, beta],      G = [[1,1],[0,1]]
    seasonal(s):          s-1 seasonal-effect states, sum-to-zero rotation

``combine`` superposes components block-diagonally and concatenates their
observation rows (the observation is the sum of the component levels) into
the port's ``DLM``, so every filter and smoother applies unchanged; a
monthly model (``local_linear_trend()`` + ``seasonal(12)``) is d = 13,
k = 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cusmc_tpu_torch.models.dlm import DLM


class Component:
    """A structural block: transition G [d,d], observation row f [d],
    state-noise variances diag w [d], and a name."""

    def __init__(self, name: str, G: np.ndarray, f: np.ndarray,
                 w: np.ndarray, m0: Optional[np.ndarray] = None,
                 c0: Optional[np.ndarray] = None):
        self.name = name
        self.G = np.asarray(G, np.float64)
        self.f = np.asarray(f, np.float64)
        self.w = np.asarray(w, np.float64)
        d = self.G.shape[0]
        self.m0 = np.zeros(d) if m0 is None else np.asarray(m0, np.float64)
        self.c0 = (np.full(d, 1.0) if c0 is None
                   else np.asarray(c0, np.float64))


def local_level(level_var: float = 0.01, init_level: float = 0.0,
                init_var: float = 1.0) -> Component:
    """Random-walk level: mu_t = mu_{t-1} + w, w ~ N(0, level_var)."""
    return Component("level", np.eye(1), np.ones(1),
                     np.asarray([level_var]), np.asarray([init_level]),
                     np.asarray([init_var]))


def local_linear_trend(level_var: float = 0.01, slope_var: float = 0.001,
                       init_level: float = 0.0, init_slope: float = 0.0,
                       init_var: float = 1.0) -> Component:
    """Level + slope: mu_t = mu_{t-1} + beta_{t-1} + w1, beta random walk."""
    G = np.asarray([[1.0, 1.0], [0.0, 1.0]])
    return Component("trend", G, np.asarray([1.0, 0.0]),
                     np.asarray([level_var, slope_var]),
                     np.asarray([init_level, init_slope]),
                     np.full(2, init_var))


def seasonal(period: int, seasonal_var: float = 0.001,
             init_var: float = 1.0) -> Component:
    """Sum-to-zero seasonal of the given period: s-1 states with the
    rotation G = [[-1...-1],[I 0]]; the observation reads the first
    state."""
    if period < 2:
        raise ValueError("seasonal period must be >= 2")
    d = period - 1
    G = np.zeros((d, d))
    G[0, :] = -1.0
    if d > 1:
        G[1:, :-1] = np.eye(d - 1)
    f = np.zeros(d)
    f[0] = 1.0
    w = np.zeros(d)
    w[0] = seasonal_var  # noise enters the current seasonal effect only
    return Component(f"seasonal{period}", G, f, w, np.zeros(d),
                     np.full(d, init_var))


def combine_matrices(components: Sequence[Component],
                     obs_var: float = 0.1) -> dict:
    """The float64 F [1, d], G, V [1, 1], W, m0 and C0 of the
    superposition; zero state-noise variances get a 1e-12 floor, since the
    filter samples with a covariance square root, which must exist."""
    if not components:
        raise ValueError("need at least one component")
    ds = [c.G.shape[0] for c in components]
    d = sum(ds)
    G = np.zeros((d, d))
    f, w, m0, c0 = (np.zeros(d) for _ in range(4))
    at = 0
    for c, dc in zip(components, ds):
        G[at:at + dc, at:at + dc] = c.G
        f[at:at + dc] = c.f
        w[at:at + dc] = c.w
        m0[at:at + dc] = c.m0
        c0[at:at + dc] = c.c0
        at += dc
    w = np.maximum(w, 1e-12)
    return dict(F=f[None, :], G=G, m0=m0, C0=np.diag(c0),
                V=np.asarray([[obs_var]]), W=np.diag(w))


def combine(components: Sequence[Component], obs_var: float = 0.1,
            df=None, noise: str = "mvn", dtype=torch.float32,
            device=None) -> DLM:
    """Superpose components into one univariate-observation DLM on
    ``device`` (None: the card, raising without one): state = the
    components' states concatenated; y = the sum of their observation rows
    + N(0, obs_var) (or Student-T with ``noise="mvt"``)."""
    return DLM.create(df=df, noise=noise, dtype=dtype, device=device,
                      **combine_matrices(components, obs_var))
