"""Multi-chain MCMC of the PyTorch port (see ``cusmc_tpu.mcmc``): random-walk
Metropolis-Hastings, adaptive Metropolis, MALA and HMC over [C, d] chains;
ChEES-HMC, the affine-invariant stretch move and parallel tempering; the
convergence driver (``sample_to_convergence``); and PMMH, parameter
inference through the bootstrap filter. The chain-sharded samplers are in
``cusmc_tpu_torch.parallel``."""

from cusmc_tpu_torch.mcmc.adaptive import AMResult, AMState, \
    adaptive_mh_sampler
from cusmc_tpu_torch.mcmc.chees import (
    ChEESResult,
    ChEESState,
    chees_hmc_sampler,
)
from cusmc_tpu_torch.mcmc.driver import ConvergenceRun, sample_to_convergence
from cusmc_tpu_torch.mcmc.ensemble import EnsembleResult, \
    stretch_move_sampler
from cusmc_tpu_torch.mcmc.hmc import (
    HMCResult,
    HMCState,
    hmc_init,
    hmc_sampler,
    hmc_step,
)
from cusmc_tpu_torch.mcmc.mala import (
    MALAResult,
    MALAState,
    mala_init,
    mala_sampler,
    mala_step,
)
from cusmc_tpu_torch.mcmc.metropolis import (
    MHResult,
    MHState,
    metropolis_hastings_sampler,
    mh_init,
    mh_step,
)
from cusmc_tpu_torch.mcmc.pmmh import PMMHResult, pmmh
from cusmc_tpu_torch.mcmc.tempering import (
    PTResult,
    PTState,
    geometric_ladder,
    parallel_tempering_sampler,
)

__all__ = [
    "EnsembleResult",
    "stretch_move_sampler",
    "ConvergenceRun",
    "sample_to_convergence",
    "ChEESResult",
    "ChEESState",
    "chees_hmc_sampler",
    "PTResult",
    "PTState",
    "geometric_ladder",
    "parallel_tempering_sampler",
    "AMResult",
    "AMState",
    "HMCResult",
    "HMCState",
    "MALAResult",
    "MALAState",
    "MHResult",
    "MHState",
    "PMMHResult",
    "adaptive_mh_sampler",
    "hmc_init",
    "hmc_sampler",
    "hmc_step",
    "mala_init",
    "mala_sampler",
    "mala_step",
    "metropolis_hastings_sampler",
    "mh_init",
    "mh_step",
    "pmmh",
]
