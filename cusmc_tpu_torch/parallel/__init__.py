"""The particle-sharded filter on ``torch.distributed``.

Port of the particle-axis part of ``cusmc_tpu/parallel``. The
chain-sharded MCMC samplers, the EnKF and the replicated filters are not
ported yet (ROADMAP queue 1, item 15).
"""

from cusmc_tpu_torch.parallel.filter import sharded_bootstrap_filter
from cusmc_tpu_torch.parallel.mesh import PARTICLE_AXIS, ParticleAxis
from cusmc_tpu_torch.parallel.multihost import (
    initialize_distributed,
    process_info,
)

__all__ = [
    "PARTICLE_AXIS",
    "ParticleAxis",
    "initialize_distributed",
    "process_info",
    "sharded_bootstrap_filter",
]
