"""ops of the PyTorch port (see the matching cusmc_tpu.ops)."""

from cusmc_tpu_torch.ops.packed import matvec, quadform
from cusmc_tpu_torch.ops.random import fast_chi2, fast_gamma

__all__ = ["fast_chi2", "fast_gamma", "matvec", "quadform"]
