"""Models of the PyTorch port (see ``cusmc_tpu.models``)."""

from cusmc_tpu_torch.models.base import (
    CustomSSM,
    normalize_time_hook,
    supports_packed,
)
from cusmc_tpu_torch.models.clgssm import CLGSSM
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.models.stochvol import StochasticVolatility
from cusmc_tpu_torch.models.ungm import UNGM

__all__ = ["CLGSSM", "CustomSSM", "DLM", "StochasticVolatility", "UNGM",
           "normalize_time_hook", "supports_packed"]
