"""Exact Kalman filter — the correctness oracle for the linear-Gaussian DLM.

Port of ``cusmc_tpu/smc/kalman.py:16-77`` (``kalman_filter`` and the
Rauch-Tung-Striebel ``rts_smoother``) in float64 numpy: they run on the
host at CPU-sized problems, are not a performance path, and are what the
tests and ``chip_smoke.py`` hold the filters' log-evidence, the smoothers'
means (FFBS, genealogy smoothing, particle Gibbs) against.
"""

from __future__ import annotations

import numpy as np


def _f64(a):
    # The exact oracle runs in NumPy on the host, off a particle filter
    # run's path: its inputs cross once, not through ``host_scalar``.
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def kalman_filter(ys, F, G, V, W, m0, C0):
    """Filtering means/covariances for x_t | y_{1:t}.

    ys [T, k] with row 0 ignored (t=0 is the prior). Returns (means [T, d],
    covs [T, d, d], loglik) where row 0 is the prior (m0, C0) and loglik
    is sum_t log p(y_t | y_{1:t-1}).
    """
    ys, F, G, V, W, m0, C0 = map(_f64, (ys, F, G, V, W, m0, C0))
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


def rts_smoother(ys, F, G, V, W, m0, C0):
    """Rauch-Tung-Striebel smoother: the exact E[x_t | y_{1:T}] of the
    linear-Gaussian DLM, the oracle of the particle smoothers. Returns
    (smoothed means [T, d], covs [T, d, d])."""
    means, covs, _ = kalman_filter(ys, F, G, V, W, m0, C0)
    G, W = _f64(G), _f64(W)
    m_s, c_s = means[-1], covs[-1]
    sm, sc = [m_s], [c_s]
    for m_t, c_t in zip(means[-2::-1], covs[-2::-1]):
        pred_cov = G @ c_t @ G.T + W
        gain = np.linalg.solve(pred_cov, G @ c_t).T
        m_s = m_t + gain @ (m_s - G @ m_t)
        c_s = c_t + gain @ (c_s - pred_cov) @ gain.T
        sm.append(m_s)
        sc.append(c_s)
    return np.stack(sm[::-1]), np.stack(sc[::-1])
