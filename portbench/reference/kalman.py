"""The Kalman filter's log-likelihood of a linear Gaussian DLM, in float64
NumPy: the exact value that a bootstrap filter's log-evidence estimates
on an MVN model. It checks the reference filter (the harness tests) and
is printed beside the comparison of an MVN cell."""

from __future__ import annotations

import numpy as np


def log_likelihood(model: dict, ys: np.ndarray) -> float:
    """log p(y_1 .. y_{T-1}) with x_0 ~ N(m0, C0); row 0 of ``ys`` unused."""
    F, G, V, W, C0 = (np.asarray(model[k], np.float64)
                      for k in ("F", "G", "V", "W", "C0"))
    m = np.asarray(model["m0"], np.float64)
    C = C0
    k = F.shape[0]
    total = 0.0
    for y in np.asarray(ys, np.float64)[1:]:
        a = G @ m
        R = G @ C @ G.T + W
        f = F @ a
        Q = F @ R @ F.T + V
        e = y - f
        L = np.linalg.cholesky(Q)
        z = np.linalg.solve(L, e)
        total += (-0.5 * k * np.log(2.0 * np.pi)
                  - np.sum(np.log(np.diag(L))) - 0.5 * z @ z)
        K = np.linalg.solve(Q, F @ R).T
        m = a + K @ e
        C = R - K @ Q @ K.T
        C = 0.5 * (C + C.T)
    return float(total)
