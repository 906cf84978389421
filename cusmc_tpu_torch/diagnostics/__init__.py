"""Diagnostics of the PyTorch port (see ``cusmc_tpu.diagnostics``)."""

from cusmc_tpu_torch.diagnostics.mcmc import (
    effective_sample_size_chains,
    ess_tail,
    mcmc_summary,
    rank_normalized_rhat,
    split_rhat,
)
from cusmc_tpu_torch.diagnostics.metrics import (
    effective_sample_size,
    filter_diagnostics,
    log_normalize,
    unique_ancestor_fraction,
)

__all__ = [
    "effective_sample_size_chains",
    "ess_tail",
    "rank_normalized_rhat",
    "mcmc_summary",
    "split_rhat",
    "effective_sample_size",
    "filter_diagnostics",
    "log_normalize",
    "unique_ancestor_fraction",
]
