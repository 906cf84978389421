"""Bootstrap particle filter on the bundled trace — the reference's main
workflow (CuSMC::run) in one call, plus the diagnostics; the PyTorch
port of ``examples/01_particle_filter.py``.

Run: python examples/torch/01_particle_filter.py [--device cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))  # run from anywhere

import argparse

import torch

import cusmc_tpu_torch
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim


def main(device=None, N=10_000, T=1001, seed=0) -> dict:
    p = demo_model_params()
    ys = load_y_sim()[:T]

    # key: an int seed (a torch.Generator also works) where JAX takes a key
    out = cusmc_tpu_torch.run(
        N=N, d=2, timeSteps=T, Y=ys,
        m0=p["m0"], C0=p["C0"], F=p["F"], G=p["G"], V=p["V"], W=p["W"],
        df=5.0, resampler="metropolis", distribution="mvt", key=seed,
        device=device)

    w = out["weights"].double()
    px = out["posterior_x"]
    wn = w / w.sum(dim=1, keepdim=True)
    posterior_mean = (wn[:, :, None] * px.double()).sum(dim=1)
    y = torch.as_tensor(ys, dtype=torch.float64, device=px.device)
    result = {
        "posterior_x": tuple(px.shape),
        "log_evidence": float(out["log_evidence"]),
        "mean_ess": float(out["ess"].double().mean()),
        "rmse": float(torch.sqrt(((posterior_mean[10:] - y[10:]) ** 2)
                                 .mean())),
    }
    print("posterior_x:", result["posterior_x"])
    print("log evidence:", result["log_evidence"])
    print("mean ESS:", result["mean_ess"])
    print("tracking RMSE vs observations:", result["rmse"])
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    main(parser.parse_args().device)
