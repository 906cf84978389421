"""The advanced MCMC stack: fast log-prob closures, ChEES-HMC with
diagonal-mass preconditioning, parallel tempering for a multimodal
target, and convergence diagnostics (split R-hat / multi-chain ESS); the
PyTorch port of ``examples/07_advanced_mcmc.py``.

Run: python examples/torch/07_advanced_mcmc.py [--device cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))  # run from anywhere

import argparse
import math

import torch

from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.diagnostics import mcmc_summary
from cusmc_tpu_torch.distributions import make_mvt_logprob
from cusmc_tpu_torch.mcmc import chees_hmc_sampler, \
    parallel_tempering_sampler

SEP = 4.0


def mixture(x):
    """Two unit Gaussians at -SEP and +SEP in every coordinate."""
    a = -0.5 * torch.sum((x + SEP) ** 2, dim=-1)
    b = -0.5 * torch.sum((x - SEP) ** 2, dim=-1)
    return torch.logaddexp(a, b)


def main(device=None, d=16, chains=128, steps=2000, pt_chains=64,
         pt_steps=4000, seed=0) -> dict:
    dev = resolve_device(device)

    def seeded(s):
        gen = torch.Generator(device=dev)
        gen.manual_seed(s)
        return gen

    # --- 1. ChEES-HMC on an anisotropic MVT (the NUTS-class workflow) --
    stds = torch.linspace(1.0, 10.0, d, device=dev)
    cov = torch.diag(stds ** 2)
    # precomputed-inverse closure: each density eval is one matmul
    log_prob = make_mvt_logprob(torch.zeros(d, device=dev), cov, df=8.0)

    # JAX's hardware key, jax.random.key(0, impl="rbg"), has no
    # counterpart: every sampler draws from a torch.Generator (Philox).
    init = stds * torch.randn((chains, d), generator=seeded(seed + 1),
                              device=dev)
    res = chees_hmc_sampler(seed, log_prob, init, steps, step_size=0.3,
                            init_traj=0.6)

    summ = mcmc_summary(res.samples[steps // 2:])
    mvt_sd = stds.double() * math.sqrt(8.0 / (8.0 - 2.0))  # t marginal sd
    out = {"chees_accept": float(res.accept_rate),
           "mean_leapfrog": float(res.mean_leapfrog),
           "traj_length": float(res.traj_length),
           "max_rhat": float(summ["rhat"].max()),
           "min_ess": float(summ["ess"].min()),
           "sd_ratio": (summ["sd"].double() / mvt_sd).cpu().numpy()}
    print("ChEES-HMC:")
    print("  accept", round(out["chees_accept"], 3),
          "| mean leapfrog/step", round(out["mean_leapfrog"], 1),
          "| learned traj", round(out["traj_length"], 2))
    print("  max R-hat", round(out["max_rhat"], 4),
          "| min ESS", int(out["min_ess"]),
          "of", steps // 2 * chains, "draws")
    print("  sd recovered / true (first 4):", out["sd_ratio"][:4].round(3))

    # --- 2. Parallel tempering across a 2-mode target -----------------
    init2 = -SEP + 0.5 * torch.randn((pt_chains, 2),
                                     generator=seeded(seed + 2), device=dev)
    pt = parallel_tempering_sampler(
        seed, mixture, init2, pt_steps, num_rungs=8, beta_min=0.02,
        step_size=0.6, noise_dtype=torch.bfloat16)
    s = pt.samples[pt_steps // 2:]
    out["right_share"] = float((s[..., 0] > 0).double().mean())
    out["swap_rate"] = pt.swap_rate.float().cpu().numpy()
    print("\nParallel tempering (all chains start in the LEFT mode):")
    print("  fraction of cold-chain mass in the right mode:",
          round(out["right_share"], 3), "(target 0.5)")
    print("  adjacent-rung swap rates:", out["swap_rate"].round(2))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    main(parser.parse_args().device)
