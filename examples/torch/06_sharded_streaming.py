"""A particle-sharded STREAMING filter (out-of-device history,
checkpointed, failure-guarded) with ESS-adaptive resampling, plus the
ESS-conditioned Metropolis sweep schedule; the PyTorch port of
``examples/06_sharded_streaming.py``.

Runs anywhere: the particles shard over the ranks of a process group,
one card a rank (NCCL) or processes on the CPU (gloo); run alone it
forms a one-rank group. In place of JAX's
XLA_FLAGS=--xla_force_host_platform_device_count=8, start 8 CPU ranks
with ``torchrun --nproc-per-node 8 examples/torch/06_sharded_streaming.py
--device cpu``.

Run: python examples/torch/06_sharded_streaming.py [--device cpu]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))  # run from anywhere

import argparse

import torch

from cusmc_tpu_torch.device import resolve_device
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.parallel import Mesh, joined_group
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter
from cusmc_tpu_torch.smc.streaming import streaming_bootstrap_filter


def main(device=None, N=4096, auto_N=8192, T=501, seed=0) -> dict:
    dev = resolve_device(device)
    ys = load_y_sim()[:T]
    with joined_group(dev):
        dev = resolve_device(device)  # the rank's card, once joined
        model = DLM.create(noise="mvt", df=5.0, dtype=torch.float32,
                           device=dev, **demo_model_params())

        # --- 1. Sharded streaming filter: the carry stays sharded on the
        # ranks between chunks; only history blocks cross to the host
        # store. Mesh({"particles": P}) where JAX builds make_mesh.
        axis = Mesh().axes["particles"]
        n_ranks = axis.size
        n = N * n_ranks
        res, store = streaming_bootstrap_filter(
            seed, model, ys, n, chunk_steps=64, resampler="systematic",
            ess_threshold=0.5, axis=axis)
        rank0 = axis.index == 0
        out = {"ranks": n_ranks,
               "streaming_log_evidence": float(res.log_evidence),
               "history": (None if store is None
                           else tuple(store.view().shape)),
               "min_ess": float(res.ess.min())}
        if rank0:
            print(f"sharded streaming over {n_ranks} rank(s): logZ "
                  f"{out['streaming_log_evidence']:.1f}, history "
                  f"{out['history']}, min ESS {out['min_ess']:.0f}")

    # --- 2. ESS-conditioned Metropolis sweeps: the full B=10 budget only
    # on sharp-weight steps, B=5 or B=3 where the weights are flat.
    res2 = bootstrap_filter(seed, model, ys, auto_N, resampler="metropolis",
                            resampler_kwargs={"num_steps": "auto"},
                            return_history=False)
    out["auto_log_evidence"] = float(res2.log_evidence)
    if rank0:
        print(f"auto-sweep metropolis: logZ {out['auto_log_evidence']:.1f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a card (default: the card)")
    main(parser.parse_args().device)
