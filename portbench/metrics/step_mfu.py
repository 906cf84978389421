"""The whole filter step's share of the chip's peak: its least time
(``models.step_work``: the larger of its bytes and its operations at
their published rates, the same whichever engine runs it) over the
measured time a step, the window's wall seconds over the steps it
completed."""

from portbench import models, work


def read(ctx):
    if not ctx["step_seconds"]:
        return None
    least = work.least_seconds(*models.step_work(ctx["cell"]))
    return 100.0 * least / ctx["step_seconds"]
