"""The device's idle share over the traced window: 1 - (the union of
device operations on the device timeline) / (the window's wall time)."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
