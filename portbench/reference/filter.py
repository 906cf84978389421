"""Plain PyTorch bootstrap particle filter: the benchmark's reference.

It runs the algorithm a cell's traffic names on the DLM

    x_0 ~ Dist(m0, C0),  x_t = G x_{t-1} + w_t,  y_t = F x_t + v_t,
    w_t ~ Dist(0, W),    v_t ~ Dist(0, V),       Dist in {MVN, MVT(df)},

with its own random draws, from the float64 matrices the benchmark hands
to both sides. Every factor (Cholesky roots, the inverse observation
root, the normaliser) is worked out here again. Each step t = 1 .. T-1
resamples all particles, propagates and reweights; the log-evidence is
the sum of ``logsumexp(ll) - log N`` and the ESS row holds the Kish ESS
of the weights each step starts from, with the initial uniform ESS first,
as the filter under test returns them.

The resampler is the law the traffic file names as its
``reference_resampler``, one file each under ``resamplers/``: the roll
walk (``metropolis`` on engines "auto" and "xla"), the windowed walk of
the fused step (``metropolis`` on engine "pallas") and ``systematic``.

``state_dtype`` and ``weight_dtype`` are float64 for the reference; the
control computes the state in bfloat16 and the weights in float32.
Imports nothing of the program: torch, numpy, the standard library and
its own folder.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from . import kalman


class Factors:
    """The model on ``device``: G, F, the roots of C0 and W, the inverse
    root of V and the log normaliser of the observation density."""

    def __init__(self, model: dict, device, state_dtype, weight_dtype):
        self.noise = model["noise"]
        self.df = model.get("df")
        F, G, V = (np.asarray(model[k], np.float64) for k in ("F", "G", "V"))
        self.k, self.d = F.shape
        v_root = np.linalg.cholesky(V)
        v_inv = np.linalg.solve(v_root, np.eye(self.k))
        half_logdet = float(np.sum(np.log(np.diag(v_root))))
        k = self.k
        if self.noise == "mvt":
            nu = float(self.df)
            self.log_norm = (math.lgamma(0.5 * (nu + k))
                             - math.lgamma(0.5 * nu)
                             - 0.5 * k * math.log(nu * math.pi) - half_logdet)
        else:
            self.log_norm = -0.5 * k * math.log(2.0 * math.pi) - half_logdet

        def s(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device
                                   ).to(state_dtype)

        def w(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device
                                   ).to(weight_dtype)

        self.G, self.F_w = s(G), w(F)
        self.m0 = s(np.asarray(model["m0"], np.float64)[:, None])
        self.C0_root = s(np.linalg.cholesky(np.asarray(model["C0"])))
        self.W_root = s(np.linalg.cholesky(np.asarray(model["W"])))
        self.V_inv = w(v_inv)
        self.state_dtype, self.weight_dtype = state_dtype, weight_dtype

    def draw(self, gen, mean, root, n):
        """mean + root z, scaled by sqrt(df / g) for MVT; [d, n]."""
        dev = mean.device
        z = torch.randn((self.d, n), generator=gen, dtype=torch.float64,
                        device=dev).to(self.state_dtype)
        noise = root @ z
        if self.noise == "mvt":
            g = chi_square(gen, float(self.df), n, dev)
            noise = noise * torch.sqrt(self.df / g).to(self.state_dtype)
        return mean + noise

    def loglik(self, y, X):
        """log p(y | x) for every column of X, in the weight dtype."""
        resid = y[:, None] - self.F_w @ X.to(self.weight_dtype)
        q = torch.sum((self.V_inv @ resid) ** 2, dim=0)
        if self.noise == "mvt":
            nu = float(self.df)
            return self.log_norm - 0.5 * (nu + self.k) * torch.log1p(q / nu)
        return self.log_norm - 0.5 * q


def chi_square(gen, df: float, n: int, device) -> torch.Tensor:
    """n chi-square(df) variates in float64, a sum of df squared normals
    (a whole df; the configurations' df is 5)."""
    if not float(df).is_integer():
        raise ValueError(f"the reference draws a whole df only, not {df}")
    z = torch.randn((int(df), n), generator=gen, dtype=torch.float64,
                    device=device)
    return torch.sum(z * z, dim=0)


def resampler(name: str):
    """``ancestors(gen, w, traffic)`` of ``resamplers/<name>.py``: the
    law of the resampler a traffic file names as its
    ``reference_resampler``."""
    return importlib.import_module(
        f"{__package__}.resamplers.{name}").ancestors


def describe(model: dict, ys: np.ndarray) -> str:
    """What the harness prints beside the comparison: for an MVN model,
    the Kalman filter's exact log-likelihood of ``ys``."""
    if model["noise"] != "mvn":
        return ""
    return f"Kalman log-likelihood {kalman.log_likelihood(model, ys)}"


def run(model: dict, ys: np.ndarray, traffic: dict, seed: int, device,
        state_dtype=torch.float64, weight_dtype=torch.float64):
    """One filter run over ``ys`` [T, k] (row 0 unused) with
    ``traffic["particles"]`` particles. Returns ``(log_evidence, ess [T])``
    as float64 numpy values."""
    n = int(traffic["particles"])
    ancestors = resampler(traffic["reference_resampler"])
    f = Factors(model, device, state_dtype, weight_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    y = torch.as_tensor(np.asarray(ys, np.float64), device=device
                        ).to(weight_dtype)
    X = f.draw(gen, f.m0, f.C0_root, n)
    logw = torch.full((n,), -math.log(n), dtype=weight_dtype, device=device)
    ess = [float(n)]
    lz = torch.zeros((), dtype=torch.float64, device=device)
    ess_steps = []
    for t in range(1, y.shape[0]):
        ess_steps.append(torch.exp(2.0 * torch.logsumexp(logw, 0)
                                   - torch.logsumexp(2.0 * logw, 0)))
        w = torch.exp(logw - torch.max(logw))
        X = X[:, ancestors(gen, w, traffic)]
        X = f.draw(gen, f.G @ X, f.W_root, n)
        ll = f.loglik(y[t], X)
        lse = torch.logsumexp(ll, 0)
        lz = lz + lse.double() - math.log(n)
        logw = ll - lse
    ess += torch.stack(ess_steps).double().cpu().tolist()
    return float(lz), np.asarray(ess)
