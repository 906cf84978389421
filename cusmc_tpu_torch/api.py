"""Public API: the reference's six functions.

Port of ``cusmc_tpu/api.py``: ``MVN``, ``MVNPDF``, ``MVT``, ``MVTPDF``,
``metropolis_hastings`` (``:43-88``) and ``run`` (``:91-147``), with the
same positional signatures and return structure; the values are torch
tensors. ``key`` is an int seed (None: 0) or a ``torch.Generator`` on the
call's device. ``device`` is the one new argument: None means the card
(it raises where there is none; CPU users pass ``"cpu"``), and a tensor
argument of the distribution functions keeps its own device. ``engine``
goes to ``bootstrap_filter`` as in the JAX package: "auto" and "xla" run
the composed path, "pallas" one fused kernel per step (metropolis,
systematic or stratified; no ESS threshold).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cusmc_tpu_torch.device import KeyLike, as_tensor, make_generator, \
    resolve_device
from cusmc_tpu_torch.distributions.mvn import mvn_logpdf_cov, mvn_sample_cov
from cusmc_tpu_torch.distributions.mvt import mvt_logpdf_cov, mvt_sample_cov
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.resampling.metropolis import metropolis_ancestors
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def MVN(mu, sigma, key: KeyLike = None, shape: tuple = (),
        method: str = "cholesky", device=None) -> torch.Tensor:
    """Draws from MVN(mu, sigma), ``shape + (d,)``; ``method`` factors
    sigma ("cholesky" or "eigh")."""
    mu = as_tensor(mu, device=device)
    return mvn_sample_cov(make_generator(key, mu.device), mu,
                          as_tensor(sigma, mu.dtype, mu.device), shape,
                          method)


def MVNPDF(x, mu, sigma, log: bool = False, device=None) -> torch.Tensor:
    """MVN density (``log``: log-density) at x [..., d]; MVNPDF(0; 0, I2)
    = 1/(2 pi)."""
    x = as_tensor(x, device=device)
    lp = mvn_logpdf_cov(x, as_tensor(mu, x.dtype, x.device),
                        as_tensor(sigma, x.dtype, x.device))
    return lp if log else torch.exp(lp)


def MVT(mu, sigma, nu, key: KeyLike = None, shape: tuple = (),
        method: str = "cholesky", per_dim_chi: bool = False,
        device=None) -> torch.Tensor:
    """Draws from MVT(mu, sigma, nu), ``shape + (d,)``; ``per_dim_chi``
    draws the reference's product-t."""
    mu = as_tensor(mu, device=device)
    return mvt_sample_cov(make_generator(key, mu.device), mu,
                          as_tensor(sigma, mu.dtype, mu.device), nu, shape,
                          method, per_dim_chi)


def MVTPDF(x, mu, sigma, nu, log: bool = False,
           device=None) -> torch.Tensor:
    """MVT density (``log``: log-density) at x [..., d]."""
    x = as_tensor(x, device=device)
    lp = mvt_logpdf_cov(x, as_tensor(mu, x.dtype, x.device),
                        as_tensor(sigma, x.dtype, x.device), nu)
    return lp if log else torch.exp(lp)


def metropolis_hastings(w, N: Optional[int] = None, B: int = 10,
                        key: KeyLike = None, log: bool = False,
                        device=None) -> torch.Tensor:
    """The Metropolis resampler alone: weights [N] -> ancestors [N] int32,
    B sweeps; ``log=True`` means ``w`` are log weights."""
    w = as_tensor(w, device=device)
    if N is not None and N != w.shape[0]:
        raise ValueError(f"N={N} != len(w)={w.shape[0]}")
    logw = w if log else torch.log(w)
    return metropolis_ancestors(make_generator(key, w.device), logw,
                                num_steps=B)


def run(N: int, d: int, timeSteps: int, Y, m0, C0, F, G, V, W,
        df: float = 4.0, resampler: str = "metropolis",
        distribution: str = "mvn", p: int = 0,
        key: KeyLike = None, output_dir: Optional[str] = None,
        ess_threshold: Optional[float] = None, dtype=torch.float32,
        sqrt_method: str = "cholesky", return_diagnostics: bool = False,
        engine: str = "auto", B: int = 10, device=None):
    """Full bootstrap particle-filter run.

    N particles, d state dim, timeSteps T, Y observations [k, T] (column
    t = y_t; [T, k] also accepted), prior (m0, C0), transition (G, W),
    observation (F, V), MVT df, resampler/distribution names, tracked
    particle p (for ``output_dir``), ``key`` an int seed or a
    ``torch.Generator``.

    ``engine``: "auto" or "xla" (the composed path) or "pallas" (the fused
    step kernels; ``B`` is then the windowed Metropolis sweep count).

    Returns ``weights`` [T, N] raw observation densities, ``posterior_x``
    [T, N, d], ``ess`` [T] and ``log_evidence``; with
    ``return_diagnostics`` also ``ancestors`` and ``obs_loglik``.
    """
    dev = resolve_device(device)
    Y = _host(Y)
    k_obs = _host(F).shape[0]
    if Y.shape == (k_obs, timeSteps):
        ys = Y.T
    elif Y.shape == (timeSteps, k_obs):
        ys = Y
    else:
        raise ValueError(
            f"Y shape {Y.shape} matches neither (k,T)=({k_obs},{timeSteps}) "
            f"nor (T,k)")
    model = DLM.create(F=_host(F), G=_host(G), m0=_host(m0), C0=_host(C0),
                       V=_host(V), W=_host(W),
                       df=df if distribution == "mvt" else None,
                       noise=distribution, sqrt_method=sqrt_method,
                       dtype=dtype, device=dev)
    resampler_kwargs = {"num_steps": B} if resampler == "metropolis" else None
    result = bootstrap_filter(
        key, model, torch.as_tensor(np.ascontiguousarray(ys), dtype=dtype), N,
        resampler=resampler, resampler_kwargs=resampler_kwargs,
        ess_threshold=ess_threshold, return_history=True, engine=engine)

    weights = torch.exp(result.obs_loglik)  # raw densities
    out = {
        "weights": weights,
        "posterior_x": result.particles,
        "ess": result.ess,
        "log_evidence": result.log_evidence,
    }
    if return_diagnostics:
        out["ancestors"] = result.ancestors
        out["obs_loglik"] = result.obs_loglik
    if output_dir is not None:
        from cusmc_tpu_torch.io.data import write_output

        write_output(output_dir, ys, _host(weights), _host(result.particles),
                     p)
    return out
