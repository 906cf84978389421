"""Reads back to the host a filter run: the program's counter
``host_scalar.reads`` over the host probe's runs of ``spans.readings``,
a mean a run."""

from portbench import spans


def read(ctx):
    return spans.value(ctx, "reads_per_run")
