"""The comparison that decides ``correct``.

A filter run is random, so its answers are compared in law: the port's
runs of the window (log-evidence L_i, mean ESS fraction E_i) against
the reference filter's runs of the same algorithm on the same inputs
with its own draws (L'_j, E'_j). Each number is a distance in standard
errors, so it reads the same at any N and run count while the program
is sound:

- ``logz_mean_z``: |mean L - mean L'| over the pooled standard error of
  the difference of the two means (a two-sample t statistic);
- ``ess_mean_z``: the same for E;
- ``logz_run_max_z``: the largest |L_i - mean L'| over all runs of the
  port, in pooled standard deviations of one run against the reference
  mean: one run that says the wrong thing shows here.

A run whose log-evidence is not finite, or that raised, is failed, and
a failed run makes the result not correct. A cell compares the numbers
its traffic file gives limits for, each limit its own; PERF.md gives the
readings each was set from.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("logz_mean_z", "ess_mean_z", "logz_run_max_z")


def _pooled(a, b) -> float:
    na, nb = len(a), len(b)
    ss = np.var(a, ddof=1) * (na - 1) + np.var(b, ddof=1) * (nb - 1)
    return math.sqrt(ss / (na + nb - 2))


def _mean_z(a, b) -> float:
    s = _pooled(a, b)
    se = s * math.sqrt(1.0 / len(a) + 1.0 / len(b))
    gap = abs(float(np.mean(a)) - float(np.mean(b)))
    if se == 0.0:
        return 0.0 if gap == 0.0 else math.inf
    return gap / se


def numbers(port_logz, port_ess, ref_logz, ref_ess) -> dict:
    """The compared numbers of finite runs; ``*_ess`` are mean ESS
    fractions, one a run."""
    L, E = np.asarray(port_logz, float), np.asarray(port_ess, float)
    Lr, Er = np.asarray(ref_logz, float), np.asarray(ref_ess, float)
    if len(L) < 2 or len(Lr) < 2:
        return {name: math.inf for name in NUMBERS}
    s = _pooled(L, Lr) * math.sqrt(1.0 + 1.0 / len(Lr))
    worst = float(np.max(np.abs(L - np.mean(Lr))))
    return {"logz_mean_z": _mean_z(L, Lr),
            "ess_mean_z": _mean_z(E, Er),
            "logz_run_max_z": worst / s if s > 0 else math.inf}


def verdict(found: dict, limits: dict, failed: int) -> bool:
    """Correct: no failed run, and each number the cell compares (the
    keys of its ``limits``) finite and within its limit."""
    return failed == 0 and all(
        math.isfinite(found[k]) and found[k] <= limit
        for k, limit in limits.items())
