"""Multi-chain MCMC of the PyTorch port (see ``cusmc_tpu.mcmc``): random-walk
Metropolis-Hastings, adaptive Metropolis, MALA and HMC over [C, d] chains.
ChEES, the ensemble and tempering samplers, the convergence driver and
PMMH are not ported yet (ROADMAP queue 1)."""

from cusmc_tpu_torch.mcmc.adaptive import AMResult, AMState, \
    adaptive_mh_sampler
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

__all__ = [
    "AMResult",
    "AMState",
    "HMCResult",
    "HMCState",
    "MALAResult",
    "MALAState",
    "MHResult",
    "MHState",
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
]
