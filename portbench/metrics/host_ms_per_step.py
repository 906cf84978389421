"""Host milliseconds a filter step inside the program's
``cusmc.filter.step`` spans, from ``record_spans()`` over the host probe
of ``spans.readings`` (the cell's program at ``spans.PROBE_PARTICLES``
particles, where the device waits on the host, no profiler)."""

from portbench import spans


def read(ctx):
    return spans.value(ctx, "host_ms", spans.STEP)
