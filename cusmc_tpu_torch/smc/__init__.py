"""smc of the PyTorch port (see ``cusmc_tpu.smc``)."""

from cusmc_tpu_torch.smc.enkf import EnKFResult, ensemble_kalman_filter
from cusmc_tpu_torch.smc.forecast import forecast
from cusmc_tpu_torch.smc.kalman import kalman_filter
from cusmc_tpu_torch.smc.liu_west import LiuWestResult, liu_west_filter
from cusmc_tpu_torch.smc.particle_filter import FilterResult, bootstrap_filter
from cusmc_tpu_torch.smc.rbpf import RBPFResult, rao_blackwell_filter
from cusmc_tpu_torch.smc.smc2 import SMC2Result, smc2

__all__ = ["EnKFResult", "FilterResult", "LiuWestResult", "RBPFResult",
           "SMC2Result", "bootstrap_filter", "ensemble_kalman_filter",
           "forecast", "kalman_filter", "liu_west_filter",
           "rao_blackwell_filter", "smc2"]
