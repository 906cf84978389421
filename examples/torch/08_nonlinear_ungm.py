"""Nonlinear/non-Gaussian filtering: the UNGM benchmark (bimodal
posteriors, time-varying drift — the regime where the Kalman filter is
inapplicable and bootstrap particle filtering is the textbook answer);
the PyTorch port of ``examples/08_nonlinear_ungm.py``.

Run: python examples/torch/08_nonlinear_ungm.py [--device cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))  # run from anywhere

import argparse

import torch

from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.models import UNGM
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter


def main(device=None, N=16384, T=200, seed=0, data_seed=7) -> dict:
    dev = resolve_device(device)
    model = UNGM.create(q=10.0, r=1.0, device=dev)
    # a torch.Generator where JAX passes jax.random.key(7)
    gen = torch.Generator(device=dev)
    gen.manual_seed(data_seed)
    xs_true, ys = model.simulate(gen, T)

    res = bootstrap_filter(seed, model, ys, N, resampler="systematic",
                           return_history=True)

    hist = res.particles[..., 0].double()               # [T, N]
    ll = res.obs_loglik.double()
    w = torch.exp(ll - ll.max(dim=1, keepdim=True).values)
    w = w / w.sum(dim=1, keepdim=True)
    pf_mean = (w * hist).sum(-1)
    x = xs_true.reshape(-1).double()
    # bimodality: share of steps where the cloud straddles both signs
    straddle = ((w * (hist > 0)).sum(-1) * (w * (hist < 0)).sum(-1)
                > 0.05).double().mean()
    out = {"log_evidence": float(res.log_evidence),
           "final_ess": float(res.ess[-1]),
           "rmse": float(torch.sqrt(torch.mean((pf_mean[1:] - x[1:]) ** 2))),
           "straddle": float(straddle)}
    print(f"UNGM bootstrap filter (N={N}, T={T}):")
    print("  logZ:", round(out["log_evidence"], 1),
          "| final ESS:", int(out["final_ess"]))
    print("  RMSE(posterior mean, truth):", round(out["rmse"], 3),
          " (obs noise sd = 1; y = x^2/20 makes the sign unidentifiable,",
          "so the error is dominated by the bimodal steps)")
    print("  fraction of steps with mass on BOTH modes:",
          round(out["straddle"], 2))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    main(parser.parse_args().device)
