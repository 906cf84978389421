"""The mean over the steps of every compared run of ESS / N: each of the
T - 1 steps' Kish ESS of the weights its resample starts from, as the
filter returns its ESS row (``run.step_ess``): the resampler's useful
share of the particles."""


def read(ctx):
    fr = ctx["ess_fractions"]
    return 100.0 * sum(fr) / len(fr) if fr else None
