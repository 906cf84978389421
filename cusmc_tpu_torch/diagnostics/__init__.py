"""Diagnostics of the PyTorch port (see ``cusmc_tpu.diagnostics``; the MCMC
diagnostics are not ported yet)."""

from cusmc_tpu_torch.diagnostics.metrics import (
    effective_sample_size,
    filter_diagnostics,
    log_normalize,
    unique_ancestor_fraction,
)

__all__ = [
    "effective_sample_size",
    "filter_diagnostics",
    "log_normalize",
    "unique_ancestor_fraction",
]
