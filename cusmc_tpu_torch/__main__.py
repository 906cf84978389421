"""Command-line runner: ``python -m cusmc_tpu_torch <command>``.

Port of ``cusmc_tpu/__main__.py``, with its subcommands, flags, defaults,
refusals and output:

    python -m cusmc_tpu_torch demo [--device cpu]
        Run the bootstrap filter on the bundled ``y_sim`` trace with the
        demo DLM; prints one JSON diagnostics line.

    python -m cusmc_tpu_torch run --config cfg.json --data y.csv \\
           [--output-dir out/] [--mesh P] [--track p] \\
           [--stream CHUNK --checkpoint DIR [--resume]] [--device cpu]
        Run a filter configured by a ``config.FilterConfig`` JSON file (a
        file written for ``python -m cusmc_tpu run`` runs unchanged) on a
        [T, k] observation CSV. ``--output-dir`` writes the reference's
        CSV pair (``y_t.csv`` and the tracked particle's ``x_t_N{p}.csv``);
        ``--stream CHUNK`` runs the streaming filter
        (``smc/streaming.py``) in chunks of CHUNK steps, with periodic
        snapshots and snapshot-and-halt in ``--checkpoint DIR`` and
        ``--resume`` from the latest one.

``--device`` is the port's own flag: where to run (default: the card;
``cpu`` on a machine without one). ``--mesh P`` shards the particles over
a ``torch.distributed`` group of P ranks: in a group started by a
launcher (``torchrun --nproc-per-node P``, which sets ``WORLD_SIZE``,
``RANK`` and the rendezvous address) it joins that group; with no launcher
and P = 1 it starts a one-rank group itself (NCCL on the card, gloo on the
CPU); any other P is refused with exit code 2.

The diagnostics go to stdout as ONE JSON line (rank 0's, in a group), with
the JAX runner's keys; everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cmd_demo(args) -> int:
    from cusmc_tpu_torch.api import run
    from cusmc_tpu_torch.device import resolve_device
    from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim

    dev = resolve_device(args.device)
    p = demo_model_params()
    ys = load_y_sim()[:args.steps]
    t0 = time.perf_counter()
    out = run(args.particles, 2, ys.shape[0], ys, p["m0"], p["C0"],
              p["F"], p["G"], p["V"], p["W"], df=5.0,
              resampler=args.resampler, distribution="mvt",
              key=args.seed, output_dir=args.output_dir, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    print(f"cusmc_tpu_torch demo on {_device_name(dev)}", file=sys.stderr)
    print(json.dumps({
        "command": "demo",
        "log_evidence": float(out["log_evidence"]),
        "final_ess": float(out["ess"][-1]),
        "wall_s": wall,
        "particle_steps_per_sec":
            args.particles * (ys.shape[0] - 1) / wall,
    }))
    return 0


def _device_name(dev) -> str:
    import torch

    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


class _Refused(Exception):
    """A request the runner refuses with exit code 2."""


def _cmd_run(args) -> int:
    try:
        return _run(args)
    except _Refused as e:
        print(str(e), file=sys.stderr)
        return 2


def _run(args) -> int:
    import numpy as np
    import torch

    from cusmc_tpu_torch.config import FilterConfig, build_model, \
        run_filter, torch_dtype
    from cusmc_tpu_torch.device import resolve_device
    from cusmc_tpu_torch.io.data import load_csv, write_output

    with open(args.config) as f:
        cfg = FilterConfig.from_dict(json.load(f))
    ys = load_csv(args.data)
    if args.stream and args.output_dir:
        raise _Refused("--stream keeps history out of HBM; use --checkpoint "
                       "for durable state instead of --output-dir")
    if args.resume and not args.checkpoint:
        raise _Refused("--resume requires --checkpoint")
    if (args.checkpoint or args.resume) and not args.stream:
        # Checkpointing belongs to the streaming filter: a silently ignored
        # --checkpoint would lose the user's resume point.
        raise _Refused("--checkpoint/--resume require --stream CHUNK")
    if args.output_dir is not None and not (
            0 <= args.track < cfg.num_particles):
        raise _Refused(f"--track {args.track} out of range for "
                       f"num_particles={cfg.num_particles}")

    dev = resolve_device(args.device)
    axis = None
    with contextlib.ExitStack() as group:
        if args.mesh:
            from cusmc_tpu_torch.parallel import ParticleAxis, joined_group

            try:
                group.enter_context(joined_group(dev, args.mesh))
            except ValueError as e:
                raise _Refused(f"--mesh {args.mesh} {e}") from None
            axis = ParticleAxis()
            dev = resolve_device(args.device)  # the rank's card, once joined
        dtype = torch_dtype(cfg.dtype)
        ys_t = torch.as_tensor(np.asarray(ys), dtype=dtype)
        t0 = time.perf_counter()
        if args.stream:
            from cusmc_tpu_torch.smc.streaming import \
                streaming_bootstrap_filter

            ckpt = None
            if args.checkpoint:
                from cusmc_tpu_torch.checkpoint import FilterCheckpoint

                ckpt = FilterCheckpoint(args.checkpoint, use_orbax=False)
            result, _ = streaming_bootstrap_filter(
                cfg.seed, build_model(cfg, dev), ys_t, cfg.num_particles,
                chunk_steps=args.stream, resampler=cfg.resampler,
                resampler_kwargs=cfg.resampler_kwargs,
                ess_threshold=cfg.ess_threshold, store_particles=False,
                checkpoint=ckpt, resume=args.resume, axis=axis)
        elif axis is not None:
            from cusmc_tpu_torch.parallel import sharded_bootstrap_filter

            result = sharded_bootstrap_filter(
                cfg.seed, build_model(cfg, dev), ys_t, cfg.num_particles,
                axis, resampler=cfg.resampler,
                resampler_kwargs=cfg.resampler_kwargs,
                ess_threshold=cfg.ess_threshold,
                # the history dominates device memory at sharded scales;
                # keep it only when the CSV export needs it
                return_history=(cfg.return_history
                                and args.output_dir is not None))
        else:
            result = run_filter(cfg, ys, dev)
        _sync(dev)
        wall = time.perf_counter() - t0

        rank0 = axis is None or axis.index == 0
        if args.output_dir is not None:
            if result.particles is None:
                raise _Refused("--output-dir needs return_history=true in "
                               "the config")
            particles, loglik = result.particles, result.obs_loglik
            if axis is not None and axis.size > 1:  # the global history
                particles = axis.all_gather(
                    particles.transpose(0, 1).contiguous()).transpose(0, 1)
                loglik = axis.all_gather(loglik.T.contiguous()).T
            if rank0:
                write_output(args.output_dir, ys,
                             torch.exp(loglik).cpu().numpy(),
                             particles.cpu().numpy(), args.track)
        if rank0:
            print(f"cusmc_tpu_torch run on {_device_name(dev)}",
                  file=sys.stderr)
            print(json.dumps({
                "command": "run",
                "config": args.config,
                "num_particles": cfg.num_particles,
                "timesteps": int(ys.shape[0]),
                "resampler": cfg.resampler,
                "mesh": args.mesh,
                "stream": args.stream,
                "log_evidence": float(result.log_evidence),
                "final_ess": float(result.ess[-1]),
                "wall_s": wall,
                "particle_steps_per_sec":
                    cfg.num_particles * (ys.shape[0] - 1) / wall,
            }))
        return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cusmc_tpu_torch",
        description="SMC runner of the PyTorch port "
                    "(see cusmc_tpu_torch/__main__.py)")
    sub = parser.add_subparsers(dest="command", required=True)

    d = sub.add_parser("demo", help="smoke-run on the bundled y_sim")
    d.add_argument("--particles", type=int, default=10_000)
    d.add_argument("--steps", type=int, default=200)
    d.add_argument("--resampler", default="metropolis")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--output-dir", default=None)
    d.add_argument("--device", default=None,
                   help="where to run (default: the card; 'cpu')")
    d.set_defaults(fn=_cmd_demo)

    r = sub.add_parser("run", help="run a configured filter on a CSV")
    r.add_argument("--config", required=True,
                   help="FilterConfig JSON file")
    r.add_argument("--data", required=True,
                   help="[T, k] observation CSV (header row ok)")
    r.add_argument("--output-dir", default=None,
                   help="write the reference-style CSV output pair")
    r.add_argument("--mesh", type=int, default=None,
                   help="shard particles over a torch.distributed group "
                        "of this many ranks")
    r.add_argument("--track", type=int, default=0,
                   help="tracked particle index for the trajectory CSV")
    r.add_argument("--stream", type=int, default=None, metavar="CHUNK",
                   help="streaming mode: run CHUNK steps per host "
                        "round trip (long runs; composes with --mesh)")
    r.add_argument("--checkpoint", default=None,
                   help="snapshot directory (streaming mode): periodic "
                        "checkpoints + snapshot-and-halt on divergence")
    r.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint snapshot")
    r.add_argument("--device", default=None,
                   help="where to run (default: the card; 'cpu')")
    r.set_defaults(fn=_cmd_run)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
