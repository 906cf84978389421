"""The sharded filters of the port on ``torch.distributed``.

Port of ``cusmc_tpu/parallel``: the particle-sharded filter, the
ensemble-sharded EnKF, replicated sharded filters on a 2-D ``Mesh``
(``make_mesh``'s counterpart), the chain-sharded MCMC samplers
(``parallel/mcmc.py``) and the process-group setup.
"""

from cusmc_tpu_torch.parallel.enkf import sharded_ensemble_kalman_filter
from cusmc_tpu_torch.parallel.filter import sharded_bootstrap_filter
from cusmc_tpu_torch.parallel.mcmc import (
    sharded_chees_sampler,
    sharded_mh_sampler,
    sharded_pt_sampler,
    sharded_stretch_sampler,
)
from cusmc_tpu_torch.parallel.mesh import CHAIN_AXIS, PARTICLE_AXIS, Mesh, \
    ParticleAxis
from cusmc_tpu_torch.parallel.multihost import (
    initialize_distributed,
    joined_group,
    process_info,
)
from cusmc_tpu_torch.parallel.replicated import replicated_sharded_filters

__all__ = [
    "CHAIN_AXIS",
    "Mesh",
    "PARTICLE_AXIS",
    "ParticleAxis",
    "initialize_distributed",
    "joined_group",
    "process_info",
    "replicated_sharded_filters",
    "sharded_bootstrap_filter",
    "sharded_chees_sampler",
    "sharded_ensemble_kalman_filter",
    "sharded_mh_sampler",
    "sharded_pt_sampler",
    "sharded_stretch_sampler",
]
