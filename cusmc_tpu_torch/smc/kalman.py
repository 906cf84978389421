"""Exact Kalman filter — the correctness oracle for the linear-Gaussian DLM.

Port of ``cusmc_tpu/smc/kalman.py:16-52`` in float64 numpy: it runs on the
host at CPU-sized problems, is not a performance path, and is what the
tests and ``chip_smoke.py`` hold the filter's log-evidence against.
"""

from __future__ import annotations

import numpy as np


def kalman_filter(ys, F, G, V, W, m0, C0):
    """Filtering means/covariances for x_t | y_{1:t}.

    ys [T, k] with row 0 ignored (t=0 is the prior). Returns (means [T, d],
    covs [T, d, d], loglik) where row 0 is the prior (m0, C0) and loglik
    is sum_t log p(y_t | y_{1:t-1}).
    """
    def f64(a):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float64)

    ys, F, G, V, W, m0, C0 = map(f64, (ys, F, G, V, W, m0, C0))
    k = F.shape[0]
    m, c, ll = m0, C0, 0.0
    means, covs = [m0], [C0]
    for y in ys[1:]:
        m_pred = G @ m
        c_pred = G @ c @ G.T + W
        s = F @ c_pred @ F.T + V
        resid = y - F @ m_pred
        sol_resid = np.linalg.solve(s, resid)
        gain = np.linalg.solve(s, F @ c_pred).T
        m = m_pred + gain @ resid
        c = c_pred - gain @ s @ gain.T
        ll += -0.5 * (resid @ sol_resid + np.linalg.slogdet(s)[1]
                      + k * np.log(2.0 * np.pi))
        means.append(m)
        covs.append(c)
    return np.stack(means), np.stack(covs), float(ll)
