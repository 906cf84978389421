"""Distributions as objects, and their string-keyed registry.

Port of ``cusmc_tpu/distributions/base.py:27-120``: ``Distribution``,
``MVN``, ``MVT``, ``DISTRIBUTIONS``, ``register_distribution`` and
``make_distribution``, with the registry keys "mvn" and "mvt". The JAX
classes are flax pytrees that trace through ``jit``; here they are plain
dataclasses of tensors, which live on the device ``make_distribution``
puts them on (the card unless asked otherwise, as every entry point of
the port). Sampling takes a ``torch.Generator`` in place of a key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from cusmc_tpu_torch.device import as_tensor
from cusmc_tpu_torch.distributions.mvn import mvn_logpdf, mvn_sample
from cusmc_tpu_torch.distributions.mvt import mvt_logpdf, mvt_sample
from cusmc_tpu_torch.utils.linalg import cov_sqrt


@dataclass
class Distribution:
    """A location-family distribution with a linear scale: ``mean`` [d],
    ``scale`` [d, d] (any square root of the covariance; lower Cholesky by
    default). Subclasses implement ``log_prob`` (batched over the leading
    axes of x) and ``sample``."""

    mean: torch.Tensor
    scale: torch.Tensor

    @property
    def dim(self) -> int:
        return self.scale.shape[-1]

    def log_prob(self, x: torch.Tensor,
                 mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, gen: Optional[torch.Generator], shape: tuple = (),
               mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def prob(self, x: torch.Tensor) -> torch.Tensor:
        """The density itself, exp(log_prob)."""
        return torch.exp(self.log_prob(x))


@dataclass
class MVN(Distribution):
    """Multivariate normal."""

    def log_prob(self, x, mean=None):
        return mvn_logpdf(x, self.mean if mean is None else mean, self.scale)

    def sample(self, gen, shape=(), mean=None):
        return mvn_sample(gen, self.mean if mean is None else mean,
                          self.scale, shape)


@dataclass
class MVT(Distribution):
    """Multivariate Student-T with ``df`` degrees of freedom;
    ``per_dim_chi`` draws the reference's product-t (one chi-square per
    component)."""

    df: Optional[torch.Tensor] = None
    per_dim_chi: bool = False

    def log_prob(self, x, mean=None):
        return mvt_logpdf(x, self.mean if mean is None else mean, self.scale,
                          self.df)

    def sample(self, gen, shape=(), mean=None):
        return mvt_sample(gen, self.mean if mean is None else mean,
                          self.scale, self.df, shape, self.per_dim_chi)


DistributionFactory = Callable[..., Distribution]

# The string-keyed factory registry.
DISTRIBUTIONS: Dict[str, DistributionFactory] = {}


def register_distribution(name: str, factory: DistributionFactory) -> None:
    DISTRIBUTIONS[name] = factory


def make_distribution(name: str, mean, cov, df=None, *,
                      sqrt_method: str = "cholesky", dtype=None, device=None,
                      **kwargs) -> Distribution:
    """Build a distribution from a covariance matrix, by registry key.
    ``mean`` and ``cov`` go through ``device.as_tensor`` (``device=None``:
    a tensor's own device, else the card)."""
    if name not in DISTRIBUTIONS:
        raise KeyError(f"unknown distribution {name!r}; have "
                       f"{sorted(DISTRIBUTIONS)}")
    mean = as_tensor(mean, dtype, device)
    cov = as_tensor(cov, mean.dtype, mean.device)
    scale = cov_sqrt(cov, sqrt_method)
    return DISTRIBUTIONS[name](mean=mean, scale=scale, df=df, **kwargs)


def _mvn_factory(mean, scale, df=None, **kwargs):
    del df
    return MVN(mean=mean, scale=scale, **kwargs)


def _mvt_factory(mean, scale, df=None, **kwargs):
    if df is None:
        raise ValueError("MVT requires df (degrees of freedom)")
    return MVT(mean=mean, scale=scale,
               df=torch.as_tensor(df, dtype=scale.dtype, device=scale.device),
               **kwargs)


register_distribution("mvn", _mvn_factory)
register_distribution("mvt", _mvt_factory)
