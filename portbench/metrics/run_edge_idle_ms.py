"""Device idle milliseconds a run at its edges (``spans.idle_split``):
the gaps not ended by an operation launched inside a
``cusmc.filter.step`` (set-up, finish, the read-back) and the time from
the run's start to its first device operation, over the host-traced run
of ``spans.readings``."""

from portbench import spans


def read(ctx):
    return spans.value(ctx, "edge_idle_ms")
