"""The sharded filters of the port on ``torch.distributed``.

Port of ``cusmc_tpu/parallel``: the particle-sharded filter, the
ensemble-sharded EnKF, replicated sharded filters on a 2-D ``Mesh``
(``make_mesh``'s counterpart) and the process-group setup. The
chain-sharded MCMC samplers (``parallel/mcmc.py``) are not ported yet
(ROADMAP queue 1).
"""

from cusmc_tpu_torch.parallel.enkf import sharded_ensemble_kalman_filter
from cusmc_tpu_torch.parallel.filter import sharded_bootstrap_filter
from cusmc_tpu_torch.parallel.mesh import CHAIN_AXIS, PARTICLE_AXIS, Mesh, \
    ParticleAxis
from cusmc_tpu_torch.parallel.multihost import (
    initialize_distributed,
    process_info,
)
from cusmc_tpu_torch.parallel.replicated import replicated_sharded_filters

__all__ = [
    "CHAIN_AXIS",
    "Mesh",
    "PARTICLE_AXIS",
    "ParticleAxis",
    "initialize_distributed",
    "process_info",
    "replicated_sharded_filters",
    "sharded_bootstrap_filter",
    "sharded_ensemble_kalman_filter",
]
