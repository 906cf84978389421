"""Parameter inference with particle marginal MH: infer a DLM's
observation-noise variance from data (capability absent in the
reference); the PyTorch port of ``examples/03_pmmh.py``.

Run: python examples/torch/03_pmmh.py [--device cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))  # run from anywhere

import argparse

import torch

from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.mcmc.pmmh import pmmh
from cusmc_tpu_torch.models import DLM


def main(device=None, N=1024, steps=400, T=201, seed=2) -> dict:
    dev = resolve_device(device)
    i1 = torch.eye(1, device=dev)
    zero = torch.zeros(1, device=dev)
    true_model = DLM.create(F=i1, G=0.9 * i1, m0=zero, C0=i1, V=0.04 * i1,
                            W=0.01 * i1, device=dev)
    # a torch.Generator where JAX passes jax.random.key(11)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    _, ys = true_model.simulate(gen, T)

    def builder(th):
        return DLM.create(F=i1, G=0.9 * i1, m0=zero, C0=i1,
                          V=torch.exp(th[0]) * i1, W=0.01 * i1, device=dev)

    def log_prior(th):
        return -0.5 * torch.sum(th ** 2) / 9.0

    result = pmmh(seed, builder, log_prior, torch.zeros(1, device=dev), ys,
                  num_particles=N, num_steps=steps, step_size=0.3)

    post_v = torch.exp(result.thetas[steps // 2:, 0].double())
    out = {"acceptance": float(result.accept_rate),
           "median_V": float(post_v.median())}
    print("acceptance:", out["acceptance"])
    print("posterior V median:", out["median_V"], "(true 0.04)")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    main(parser.parse_args().device)
