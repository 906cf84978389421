"""Declarative run configuration.

Port of ``cusmc_tpu/config.py``: ``FilterConfig`` with the same twelve
fields, defaults and dict round trip (``from_dict`` refuses unknown keys
with the JAX package's message), so a JSON file written for ``python -m
cusmc_tpu run`` runs unchanged under ``python -m cusmc_tpu_torch run``.
``build_model`` and ``run_filter`` take the one new argument ``device``
(None: the card; ``"cpu"`` on a machine without one).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class FilterConfig:
    """Everything needed to reproduce a bootstrap-filter run."""

    num_particles: int
    model: Dict[str, Any]                 # F, G, m0, C0, V, W [, df]
    distribution: str = "mvn"             # registry key
    resampler: str = "metropolis"         # registry key
    resampler_kwargs: Optional[Dict[str, Any]] = None
    ess_threshold: Optional[float] = None
    seed: int = 0
    layout: str = "auto"
    engine: str = "auto"
    return_history: bool = True
    sqrt_method: str = "cholesky"
    dtype: str = "float32"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FilterConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["model"] = {k: np.asarray(v).tolist()
                        for k, v in self.model.items()}
        return out


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("float32", "float64", ...) as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def build_model(config: FilterConfig, device=None):
    """The configured DLM on ``device`` (None: the card): the one place
    that turns a config into a model, for ``run_filter`` and the CLI's
    streaming and sharded paths."""
    from cusmc_tpu_torch.models.dlm import DLM

    m = dict(config.model)
    return DLM.create(noise=config.distribution, df=m.pop("df", None),
                      sqrt_method=config.sqrt_method,
                      dtype=torch_dtype(config.dtype), device=device, **m)


def run_filter(config: FilterConfig, ys, device=None):
    """Run a configured filter on observations ``ys`` [T, k]; returns a
    ``FilterResult``."""
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    model = build_model(config, device)
    return bootstrap_filter(
        config.seed, model,
        torch.as_tensor(np.asarray(ys), dtype=torch_dtype(config.dtype)),
        config.num_particles, resampler=config.resampler,
        resampler_kwargs=config.resampler_kwargs,
        ess_threshold=config.ess_threshold,
        return_history=config.return_history,
        layout=config.layout, engine=config.engine)
