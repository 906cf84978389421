"""The fused Metropolis step's share of its roofline: the least time of
``work.fused_bound("step", d, k, N)`` over the kernel's device time a
call (one a step)."""

from portbench import work


def read(ctx):
    g = ctx["groups"].get("fused_step")
    if not g or g["seconds"] <= 0:
        return None
    c = ctx["cell"]
    nbytes, flops, peak, ops = work.fused_bound(
        "step", c["d"], c["k"], c["particles"], num_sweeps=c["num_sweeps"],
        noise=c["noise"], df_int=work.integer_df(c["df"]))
    least = work.least_seconds(nbytes, flops, peak, ops)
    return 100.0 * least / (g["seconds"] / ctx["steps"])
