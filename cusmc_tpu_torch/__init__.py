"""cusmc_tpu_torch — the PyTorch and CUDA port of cusmc_tpu.

A second package beside the JAX reference ``cusmc_tpu``, with the same
module paths: ``cusmc_tpu/x/y.py`` has its counterpart at
``cusmc_tpu_torch/x/y.py``, and each module's docstring names the JAX lines
it replaces. It imports torch and numpy, never jax and never cusmc_tpu.

The port so far has the reference's public API (``run``, ``MVN``,
``MVNPDF``, ``MVT``, ``MVTPDF``, ``metropolis_hastings``) and the bootstrap
particle filter: the packed [d, N] fast path over the DLM, with
hand-written Hopper kernels (``csrc/*.cu``, built by ``nvcc`` at first
use) for the prefix sum, the inverse-CDF search-and-apply, the
roll-Metropolis walk and the take-columns gather; ``engine="pallas"``, one
fused resample-propagate-reweight kernel per step (windowed Metropolis, or
systematic/stratified inverse CDF) with Philox bits made in the kernel;
the generic log-space step (``layout="batch"``, models without packed
methods such as ``CustomSSM``, time-varying hooks, the resampler registry
``get_resampler``/``register_resampler``, ``debug_checks``); mixed
precision; the particle-sharded filter (``cusmc_tpu_torch.parallel``); the
streaming filter with checkpoints and snapshot-and-halt
(``smc/streaming.py``, ``checkpoint.py``) over the native host stores of
``native/`` (``io/native_store.py``, ``io/disk_store.py``); and the
headless runner, ``python -m cusmc_tpu_torch demo|run`` (``config.py``);
the other model families (``models/{stochvol,ungm,structural,clgssm}.py``)
and the auxiliary filters and smoothers (``smc/{apf,liu_west,rbpf,csmc,
enkf,ffbs,smoothing,forecast}.py``, ``kalman.rts_smoother``), which run the
existing kernels or plain torch, as their JAX counterparts run XLA; and
multi-chain MCMC (``mcmc/``: random-walk and adaptive Metropolis, MALA,
HMC, ChEES-HMC, the stretch move, parallel tempering, the convergence
driver and PMMH) with its convergence diagnostics
(``diagnostics/mcmc.py``), the chain-sharded samplers
(``parallel/mcmc.py``), the tempered SMC sampler and SMC^2
(``smc/{smc_sampler,smc2}.py``): plain torch as well, but for PMMH's
filter runs, which launch the filter's kernels.
On a CUDA tensor each kernel wrapper launches its kernel or raises; only a
CPU tensor takes the plain PyTorch version.

TF32 is turned off here: the quadratic form feeds the weights, and TF32
would cost about three digits there.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from cusmc_tpu_torch.api import (  # noqa: E402
    MVN,
    MVNPDF,
    MVT,
    MVTPDF,
    metropolis_hastings,
    run,
)
from cusmc_tpu_torch.device import resolve_device  # noqa: E402
from cusmc_tpu_torch.mcmc.metropolis import (  # noqa: E402
    metropolis_hastings_sampler,
)
from cusmc_tpu_torch.models.base import CustomSSM  # noqa: E402
from cusmc_tpu_torch.models.clgssm import CLGSSM  # noqa: E402
from cusmc_tpu_torch.models.dlm import DLM  # noqa: E402
from cusmc_tpu_torch.resampling import (  # noqa: E402
    get_resampler,
    register_resampler,
)
from cusmc_tpu_torch.smc.enkf import (  # noqa: E402
    EnKFResult,
    ensemble_kalman_filter,
)
from cusmc_tpu_torch.smc.kalman import kalman_filter  # noqa: E402
from cusmc_tpu_torch.smc.liu_west import (  # noqa: E402
    LiuWestResult,
    liu_west_filter,
)
from cusmc_tpu_torch.smc.particle_filter import (  # noqa: E402
    FilterResult,
    bootstrap_filter,
)
from cusmc_tpu_torch.smc.rbpf import (  # noqa: E402
    RBPFResult,
    rao_blackwell_filter,
)
from cusmc_tpu_torch.smc.smc2 import SMC2Result, smc2  # noqa: E402
from cusmc_tpu_torch.smc.smc_sampler import smc_sampler  # noqa: E402

__all__ = ["CLGSSM", "CustomSSM", "DLM", "EnKFResult", "FilterResult",
           "LiuWestResult", "MVN", "MVNPDF", "MVT", "MVTPDF", "RBPFResult",
           "SMC2Result", "bootstrap_filter", "ensemble_kalman_filter",
           "get_resampler", "kalman_filter", "liu_west_filter",
           "metropolis_hastings", "metropolis_hastings_sampler",
           "rao_blackwell_filter", "register_resampler", "resolve_device",
           "run", "smc2", "smc_sampler"]
