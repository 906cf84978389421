"""Multi-chain random-walk Metropolis-Hastings on an MVT target with
Robbins-Monro step-size adaptation (BASELINE configs 1/2 shape), then
MALA, HMC and adaptive MH on the same target; the PyTorch port of
``examples/02_mcmc.py``.

Run: python examples/torch/02_mcmc.py [--device cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))  # run from anywhere

import argparse
import math

import torch

from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.distributions import make_mvt_logprob
from cusmc_tpu_torch.mcmc import adaptive_mh_sampler, hmc_sampler, \
    mala_sampler, metropolis_hastings_sampler


def _var(samples) -> float:
    """Mean over dimensions of the per-dimension variance of the second
    half of [T, C, d] samples."""
    s = samples[samples.shape[0] // 2:].reshape(-1, samples.shape[-1])
    return float(s.double().var(dim=0, correction=0).mean())


def main(device=None, d=16, chains=256, steps=5000, mala_steps=2000,
         hmc_steps=1000, am_steps=3000, seed=0) -> dict:
    dev = resolve_device(device)
    df = 8.0
    # mvt_logpdf_cov(x, 0, I, df), its Cholesky factor taken once: the
    # JAX example runs under one jax.jit, eager torch would factor cov
    # again at every density call (the same values, 5x the time).
    log_prob = make_mvt_logprob(torch.zeros(d, device=dev),
                                torch.eye(d, device=dev), df)

    # an int seed where JAX passes jax.random.key(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = torch.randn((chains, d), generator=gen, device=dev)
    result = metropolis_hastings_sampler(
        seed, log_prob, init, steps, step_size=2.38 / math.sqrt(d),
        adapt_rate=0.05)

    expect = df / (df - 2.0)
    out = {"expect": expect,
           "mh": {"acceptance": float(result.accept_rate),
                  "step_size": float(result.step_size),
                  "var": _var(result.samples)}}
    print("acceptance:", out["mh"]["acceptance"],
          "adapted step:", out["mh"]["step_size"])
    print("sample var (expect", expect, "):", out["mh"]["var"])

    # --- gradient-based + adaptive samplers on the same target ----------
    for name, fn in [
        ("MALA", lambda: mala_sampler(seed, log_prob, init, mala_steps)),
        ("HMC", lambda: hmc_sampler(seed, log_prob, init, hmc_steps,
                                    num_leapfrog=12)),
        ("adaptive-MH", lambda: adaptive_mh_sampler(seed, log_prob, init,
                                                    am_steps)),
    ]:
        r = fn()
        out[name] = {"acceptance": float(r.accept_rate),
                     "var": _var(r.samples)}
        print(f"{name}: acceptance {out[name]['acceptance']:.3f}, "
              f"sample var {out[name]['var']:.3f} (expect {expect:.3f})")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    main(parser.parse_args().device)
