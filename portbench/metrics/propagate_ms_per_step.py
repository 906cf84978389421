"""Device milliseconds a filter step of the operations launched inside
the program's ``cusmc.propagate`` spans (``spans.device_by_span`` over the
host-traced run of ``spans.readings``)."""

from portbench import spans


def read(ctx):
    return spans.value(ctx, "device_ms", "cusmc.propagate")
