"""Particle-sharded filtering over a process group; the PyTorch port of
``examples/04_sharded.py``. Ranks are processes: one card a rank on the
card (NCCL), or processes on the CPU (gloo). Run alone it forms a
one-rank group and still runs. In place of JAX's
XLA_FLAGS=--xla_force_host_platform_device_count=8, start 8 CPU ranks
with ``torchrun --nproc-per-node 8 examples/torch/04_sharded.py --device
cpu``.

Run: python examples/torch/04_sharded.py [--device cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))  # run from anywhere

import argparse

import torch

from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models import DLM
from cusmc_tpu_torch.parallel import Mesh, joined_group, \
    sharded_bootstrap_filter


def main(device=None, N=16384, T=501, seed=0) -> dict:
    dev = resolve_device(device)
    with joined_group(dev):
        dev = resolve_device(device)  # the rank's card, once joined
        model = DLM.create(noise="mvt", df=5.0, dtype=torch.float32,
                           device=dev, **demo_model_params())
        ys = load_y_sim()[:T]

        # Mesh({"particles": P}) where JAX builds make_mesh
        mesh = Mesh()
        axis = mesh.axes["particles"]
        n_ranks = axis.size
        n = N * n_ranks
        result = sharded_bootstrap_filter(seed, model, ys, n, axis,
                                          resampler="metropolis")
        out = {"ranks": n_ranks, "particles": n,
               "log_evidence": float(result.log_evidence),
               "final_ess": float(result.ess[-1])}
        if axis.index == 0:
            print(f"ranks: {n_ranks}, particles: {n}")
            print("log evidence:", out["log_evidence"])
            print("final ESS:", out["final_ess"])
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    main(parser.parse_args().device)
