"""MCMC convergence diagnostics: split R-hat and autocorrelation ESS.

Port of ``cusmc_tpu/diagnostics/mcmc.py:24-147`` (Vehtari et al. 2021):
split R-hat, the FFT-based multi-chain autocorrelation ESS with Geyer's
initial-positive and initial-monotone truncation (a vectorised mask, a
cumulative product of pair positivity, not a data-dependent loop),
rank-normalised R-hat, tail ESS and a summary. Pure functions of a
[T, C] or [T, C, d] sample tensor, on its device.

Quantiles (the median of the folded R-hat, the tail ESS's bounds) take
the linear interpolation of ``jnp.quantile`` from one sort
(``torch.quantile`` refuses inputs over 2^24 elements), and the ranks take
a stable sort, as ``jnp.argsort`` does.
"""

from __future__ import annotations

import math

import torch


def _split_chains(samples: torch.Tensor) -> torch.Tensor:
    """[T, C, ...] -> [T//2, 2C, ...] (the odd last draw dropped)."""
    t = samples.shape[0] - (samples.shape[0] % 2)
    half = t // 2
    return torch.cat([samples[:half], samples[half:t]], dim=1)


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split potential-scale-reduction R-hat of [T, C] or [T, C, d]
    samples: a 0-dim tensor or [d]. Near 1 for mixed chains."""
    x = _split_chains(torch.as_tensor(samples))
    n = x.shape[0]
    chain_mean = torch.mean(x, dim=0)
    chain_var = torch.var(x, dim=0, correction=1)
    w = torch.mean(chain_var, dim=0)                     # within
    b = n * torch.var(chain_mean, dim=0, correction=1)   # between
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / w)


def _autocov_fft(x: torch.Tensor) -> torch.Tensor:
    """Each chain's biased autocovariance by FFT: x [T, C, ...] -> [T, C,
    ...], lag along axis 0, normalised by T."""
    t = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    nfft = 2 * t  # zero-padded against circular wrap
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:t]
    return acov / t


def effective_sample_size_chains(samples: torch.Tensor) -> torch.Tensor:
    """Multi-chain autocorrelation ESS of [T, C] or [T, C, d] samples (a
    0-dim tensor or [d]): the number of independent draws that the T C
    dependent ones are worth."""
    x = _split_chains(torch.as_tensor(samples))
    n, m = x.shape[0], x.shape[1]
    acov = _autocov_fft(x)                               # [n, m, ...]
    chain_var = acov[0] * n / (n - 1.0)
    w = torch.mean(chain_var, dim=0)
    mean_acov = torch.mean(acov, dim=1)                  # [n, ...]
    b_over_n = torch.var(torch.mean(x, dim=0), dim=0, correction=1)
    var_plus = (n - 1.0) / n * w + b_over_n
    rho = 1.0 - (w - mean_acov) / var_plus               # [n, ...]

    # Geyer's pairs P_k = rho_2k + rho_2k+1: initial-positive (stop at the
    # first non-positive pair) and initial-monotone (running minimum)
    # truncation; tau = -1 + 2 sum P_k.
    npair = n // 2
    p = rho[:2 * npair]
    pair = p[0::2] + p[1::2]
    pos = torch.cumprod((pair > 0.0).to(x.dtype), dim=0)
    inf = torch.full_like(pair, math.inf)
    pair_mono = torch.cummin(torch.where(pos > 0, pair, inf), dim=0).values
    tau = -1.0 + 2.0 * torch.sum(
        torch.where(pos > 0, torch.clamp(pair_mono, min=0.0),
                    torch.zeros_like(pair)), dim=0)
    tau = torch.clamp(tau, min=1.0 / math.log10(n * m))
    return n * m / tau


def _quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(flat, q, axis=0)`` (linear interpolation) from one
    sort along axis 0."""
    s = torch.sort(flat, dim=0).values
    pos = q * (s.shape[0] - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, s.shape[0] - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def _rank_normalize(x: torch.Tensor) -> torch.Tensor:
    """Fractional ranks over all draws (per trailing dim), through the
    normal quantile function with Blom's offsets."""
    t, c = x.shape[0], x.shape[1]
    flat = x.reshape((t * c,) + tuple(x.shape[2:]))
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True).to(x.dtype) + 1.0
    z = torch.special.ndtri((ranks - 0.375) / (t * c + 0.25))
    return z.reshape(x.shape)


def rank_normalized_rhat(samples: torch.Tensor) -> torch.Tensor:
    """The R-hat that Vehtari et al. (2021) recommend: the larger of the
    split R-hat of the rank-normalised draws (location) and of the
    rank-normalised folded draws |x - median| (scale)."""
    samples = torch.as_tensor(samples)
    bulk = split_rhat(_rank_normalize(samples))
    med = _quantile(samples.reshape((-1,) + tuple(samples.shape[2:])), 0.5)
    folded = split_rhat(_rank_normalize(torch.abs(samples - med)))
    return torch.maximum(bulk, folded)


def ess_tail(samples: torch.Tensor, prob: float = 0.05) -> torch.Tensor:
    """Tail ESS: the smaller ESS of the indicators I(x <= q_prob) and
    I(x >= q_{1-prob})."""
    samples = torch.as_tensor(samples)
    flat = samples.reshape((-1,) + tuple(samples.shape[2:]))
    qlo = _quantile(flat, prob)
    qhi = _quantile(flat, 1.0 - prob)
    dt = samples.dtype
    lo = effective_sample_size_chains((samples <= qlo).to(dt))
    hi = effective_sample_size_chains((samples >= qhi).to(dt))
    return torch.minimum(lo, hi)


def mcmc_summary(samples: torch.Tensor) -> dict:
    """Per-dimension summary of [T, C, d] samples: mean, sd, the
    rank-normalised R-hat, bulk ESS (rank-normalised), tail ESS and bulk
    ESS per draw."""
    samples = torch.as_tensor(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    ess = effective_sample_size_chains(_rank_normalize(samples))
    return {
        "mean": torch.mean(flat, dim=0),
        "sd": torch.std(flat, dim=0, correction=1),
        "rhat": rank_normalized_rhat(samples),
        "ess": ess,
        "ess_tail": ess_tail(samples),
        "ess_per_draw": ess / (samples.shape[0] * samples.shape[1]),
    }
