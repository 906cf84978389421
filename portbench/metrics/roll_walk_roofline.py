"""The roll walk's share of its roofline: the least time of one call
(``work.roll_bytes`` over the HBM rate) over the roll kernels' device
time a call (one call a step, one or two launches)."""

from portbench import work
from portbench.peaks import HBM_BYTES_PER_S


def read(ctx):
    g = ctx["groups"].get("roll_walk")
    if not g or g["seconds"] <= 0:
        return None
    c = ctx["cell"]
    least = work.roll_bytes(c["particles"], c["d"], c["num_sweeps"]) \
        / HBM_BYTES_PER_S
    return 100.0 * least / (g["seconds"] / ctx["steps"])
