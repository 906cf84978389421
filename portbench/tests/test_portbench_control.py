"""What the comparison must catch, on the CPU at a size a test run holds:
each cell's control (its state in bfloat16: the program's own mixed
precision, or the reference in its place where the program has none)
and each fault the cell can have, planted under a run that skips the
look for a chip and runs the rest. Each must make ``correct`` false,
where the sound program, at the same size, is correct. The controls also
run on the card at each cell's own size (marker ``cuda``; they skip
without a card).

The faults are planted in the filter's step (``filter_setup``'s step
function, which every engine's step goes through):

- ``state_unchanged``: the step returns the state it was given;
- ``half_left_out``: half of the particles left out of the new weights,
  the evidence taken as the mean over the rest;
- ``answer_altered``: one step's evidence increment produced without its
  ``- log N`` (a sum where the mean belongs).

One card holds one shard, so no exchange between chips can be left out.
"""

import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import control, run  # noqa: E402

CELLS = ("demo_d2_metropolis", "monthly_d13_fused", "demo_d2_systematic",
         "monthly_d13_composed")
SIZE = {"particles": 16384, "steps": 40, "reference_runs": 16,
        "tile": 4096}
SECONDS = 6.0
SEED = 2**31 + 101


def broken_setup(fault):
    from cusmc_tpu_torch.smc import particle_filter as pf

    original = pf.filter_setup

    def setup(*args, **kwargs):
        s = original(*args, **kwargs)
        step = s.step

        def broken(x, w, y_t, streams=None, draws=None, t=None):
            x_new, w_new, ess, lz, ll, a = step(x, w, y_t, streams,
                                                draws=draws, t=t)
            n = ll.shape[0]
            if fault == "state_unchanged":
                x_new = x
            elif fault == "half_left_out":
                h = n // 2
                lse = torch.logsumexp(ll[:h], 0)
                lz = lse - math.log(h)
                w_new = w_new.clone()
                if s.log_carry:
                    w_new[:h] = ll[:h] - lse
                    w_new[h:] = -math.inf
                else:
                    w_new[h:] = 0.0
            elif fault == "answer_altered" and t == 1:
                lz = lz + math.log(n)
            return x_new, w_new, ess, lz, ll, a

        return s._replace(step=broken)

    return pf, setup


def execute(cell, **kw):
    return run.execute(cell, SEED, SECONDS, False, device="cpu",
                       overrides=SIZE, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct_at_this_size(cell):
    result = execute(cell)
    assert result["correct"], result["compared"]


# The control moves the demo cells' ESS by about 0.5%: at 2^16 particles
# and 80 steps that is some 15 standard errors, at the faults' size about
# 8, under the limit. On the monthly cells a bfloat16 state costs little
# until the level has drifted over many months, so their controls are held
# on the card at the cells' own size alone.
CONTROL_SIZE = {"particles": 65536, "steps": 80, "reference_runs": 16}


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if not c.startswith("monthly")])
def test_the_control_is_not_correct(cell):
    traffic = run.spec.load_cell(cell)["traffic"]
    result = run.execute(cell, SEED, 20.0, False, device="cpu",
                         overrides=CONTROL_SIZE,
                         make_program=control.control_program(traffic))
    assert not result["correct"], result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    traffic = run.spec.load_cell(cell)["traffic"]
    seconds = run.spec.benchmark()["run_seconds"]
    result = run.execute(cell, SEED, seconds, False,
                         make_program=control.control_program(traffic))
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("fault", ("state_unchanged", "half_left_out",
                                   "answer_altered"))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    pf, setup = broken_setup(fault)
    monkeypatch.setattr(pf, "filter_setup", setup)
    result = execute(cell)
    assert not result["correct"], (fault, result["compared"])
