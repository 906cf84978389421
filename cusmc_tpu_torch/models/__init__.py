"""Models of the PyTorch port (see ``cusmc_tpu.models``)."""

from cusmc_tpu_torch.models.base import (
    CustomSSM,
    normalize_time_hook,
    supports_packed,
)
from cusmc_tpu_torch.models.dlm import DLM

__all__ = ["CustomSSM", "DLM", "normalize_time_hook", "supports_packed"]
