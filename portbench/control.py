#!/usr/bin/env python3
"""The readings that the limits of ``compare.py`` are set from: a cell's
compared numbers on sound runs of the program over many seeds (the lower
reading) and on its control (the upper reading), in one process.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ...

Each seed runs one window of the cell's own traffic for ``--seconds``
and the reference, as a benchmark run does, and prints its numbers. The
control is the cell's ``control`` entry: the program's own bfloat16 state
(``{"kind": "port", "state_dtype": "bfloat16"}``) or, where the program
has no such path, the reference filter with a bfloat16 state and float32
weights put in the program's place (``{"kind": "reference", ...}``). The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import run  # noqa: E402


class ReferenceProgram:
    """The reference filter in the program's place, in the given
    precision."""

    def __init__(self, model, ys, traffic, device, state_dtype,
                 weight_dtype):
        self.reference = run.reference(traffic)
        self.args = (model, ys, traffic)
        self.device = device
        self.dtypes = (state_dtype, weight_dtype)

    def run(self, key: int):
        return self.reference.run(*self.args, key, self.device,
                                  *self.dtypes)


def control_program(traffic: dict):
    """A ``make_program`` for ``run.execute``: the cell's control."""
    c = traffic["control"]
    if c["kind"] == "port":
        return run.program(traffic, c["state_dtype"])
    state = run.DTYPES[c["state_dtype"]]
    weight = run.DTYPES[c.get("weight_dtype", "float32")]
    return lambda model, ys, tr, dev: ReferenceProgram(model, ys, tr, dev,
                                                       state, weight)


def readings(prog, prep, seeds, seconds, device, label):
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        w = run.window(prog, seed, seconds, prep["n"], prep["steps"])
        found, correct = run.judge(w, prep, seed, device)
        row = {"kind": label, "seed": seed, "runs": len(w["logz"]),
               "failed": w["failed"], "correct": correct,
               "seconds": time.perf_counter() - t0, **found}
        print("reading " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--particles", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    args = p.parse_args(argv)
    overrides = {k: v for k, v in (("particles", args.particles),
                                   ("steps", args.steps)) if v}
    first = (args.seeds or args.control_seeds)[0]
    prep = run.prepare(args.workload, first, args.device, overrides)
    out = []
    for seeds, label, make in (
            (args.seeds, "sound", run.program(prep["traffic"])),
            (args.control_seeds, "control",
             control_program(prep["traffic"]))):
        if not seeds:
            continue
        prog = make(prep["model"], prep["ys"], prep["traffic"], args.device)
        prog.run(run.key(seeds[0], run.WARM, 0))
        out += readings(prog, prep, seeds, args.seconds, args.device, label)
        del prog
        if args.device == "cuda":
            torch.cuda.empty_cache()
    for label in ("sound", "control"):
        rows = [r for r in out if r["kind"] == label]
        if rows:
            print(f"{label}: " + ", ".join(
                f"{k} max {max(r[k] for r in rows):.4g} min "
                f"{min(r[k] for r in rows):.4g}" for k in run.compare.NUMBERS),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
