"""The CDF resample's share of its roofline: the least time of the
cumsum and the search-and-apply of one step (their bytes over the HBM
rate) over the two kernels' device time a step."""

from portbench import work
from portbench.peaks import HBM_BYTES_PER_S


def read(ctx):
    cum = ctx["groups"].get("cdf_cumsum")
    search = ctx["groups"].get("cdf_search")
    if not cum or not search:
        return None
    c = ctx["cell"]
    n = c["particles"]
    least = (work.cumsum_bytes(n) + work.search_apply_bytes(n, c["d"])) \
        / HBM_BYTES_PER_S
    return 100.0 * least / ((cum["seconds"] + search["seconds"])
                            / ctx["steps"])
