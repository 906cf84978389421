"""Marginalized and online-learning filters; the PyTorch port of
``examples/05_rbpf_liu_west.py``.

1. Rao-Blackwellized particle filter on a conditionally linear-Gaussian
   model: a scalar random-walk phase u_t enters the observation offset;
   the 3-D linear substate is marginalized by per-particle Kalman banks.
2. Liu-West filter: learn a DLM's transition coefficient ONLINE while
   filtering its state.

Run: python examples/torch/05_rbpf_liu_west.py [--device cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))  # run from anywhere

import argparse
import math

import numpy as np
import torch

from cusmc_tpu_torch import CLGSSM, liu_west_filter, rao_blackwell_filter
from cusmc_tpu_torch.device import resolve_device


def main(device=None, rbpf_N=4096, lw_N=8192, rbpf_T=200, lw_T=300,
         seed=0) -> dict:
    dev = resolve_device(device)

    # --- 1. RBPF ----------------------------------------------------------
    D, K = 3, 2
    G = 0.9 * torch.eye(D, device=dev)
    F = torch.as_tensor(np.random.default_rng(0).standard_normal((K, D)),
                        dtype=torch.float32, device=dev)
    V = 0.5 * torch.eye(K, device=dev)
    W = 0.3 * torch.eye(D, device=dev)

    # callables draw from a torch.Generator where JAX's take a key
    model = CLGSSM.create(
        nl_dim=1, lin_dim=D, obs_dim=K,
        sample_initial_nl=lambda p, g, n: 0.1 * torch.randn(
            (n, 1), generator=g, device=dev),
        propagate_nl=lambda p, g, u: u + 0.15 * torch.randn(
            u.shape, generator=g, device=dev),
        Fmat=lambda p, u: F,
        Gmat=lambda p, u: G,
        Vcov=lambda p, u: V,
        Wcov=lambda p, u: W,
        c=lambda p, u: torch.stack([torch.sin(u[0]), torch.cos(u[0])]),
        m0=np.zeros(D), C0=np.eye(D),
        mats_constant=True,  # F/G/V/W fixed -> shared-covariance fast path
        device=dev)

    ys = np.random.default_rng(1).standard_normal((rbpf_T, K)).astype(
        np.float32)
    res = rao_blackwell_filter(seed, model, torch.as_tensor(ys, device=dev),
                               num_particles=rbpf_N)
    out = {"rbpf_log_evidence": float(res.log_evidence),
           "rbpf_final_ess": float(res.ess[-1]),
           "rbpf_final_mean": res.filtered_mean[-1].cpu().numpy()}
    print(f"RBPF: log-evidence {out['rbpf_log_evidence']:.2f}, "
          f"final ESS {out['rbpf_final_ess']:.0f}/{rbpf_N}, "
          f"E[z_T] = {out['rbpf_final_mean'].round(3)}")

    # --- 2. Liu-West ------------------------------------------------------
    G_TRUE, W_VAR, V_VAR = 0.8, 0.3, 0.5
    rng = np.random.default_rng(3)
    x, ys2 = 0.0, np.zeros((lw_T, 1), np.float32)
    for t in range(1, lw_T):
        x = G_TRUE * x + rng.normal(0, np.sqrt(W_VAR))
        ys2[t, 0] = x + rng.normal(0, np.sqrt(V_VAR))
    w_sd = math.sqrt(W_VAR)
    log_norm = 0.5 * math.log(2 * math.pi * V_VAR)

    lw = liu_west_filter(
        seed,
        sample_initial=lambda g, n, th: torch.randn((n, 1), generator=g,
                                                    device=dev),
        propagate=lambda g, xs, th: th[:, :1] * xs + w_sd * torch.randn(
            xs.shape, generator=g, device=dev),
        propagate_mean=lambda xs, th: th[:, :1] * xs,
        observation_logpdf=lambda y, xs, th: (
            -0.5 * (y[0] - xs[:, 0]) ** 2 / V_VAR - log_norm),
        theta_prior_sample=lambda g, n: 0.5 + 0.2 * torch.randn(
            (n, 1), generator=g, device=dev),
        ys=torch.as_tensor(ys2, device=dev), num_particles=lw_N, device=dev)
    traj = lw.theta_mean[::60, 0].cpu().numpy()
    out["lw_theta_mean"] = traj
    out["lw_theta_final"] = float(lw.theta_mean[-1, 0])
    print(f"Liu-West: E[g | y_1:t] trajectory {traj.round(3)} "
          f"(truth {G_TRUE})")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    main(parser.parse_args().device)
