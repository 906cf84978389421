"""``"kind": "structural"``: the superposition of a local linear trend
and a sum-to-zero seasonal (West & Harrison 1997; Durbin & Koopman 2012
section 3.2), built from its variances: ``{"components": [...],
"obs_var": v}``, each component ``{"type", its variances, "init_var"}``.
"""

from __future__ import annotations

import numpy as np

# Zero state-noise variances get this floor: both filters draw through a
# square root of W, which must exist.
VARIANCE_FLOOR = 1e-12


def _trend(c):
    G = np.array([[1.0, 1.0], [0.0, 1.0]])
    return G, np.array([1.0, 0.0]), np.array([c["level_var"],
                                              c["slope_var"]])


def _seasonal(c):
    d = int(c["period"]) - 1
    G = np.zeros((d, d))
    G[0, :] = -1.0
    G[1:, :-1] = np.eye(d - 1)
    f = np.zeros(d)
    f[0] = 1.0
    w = np.zeros(d)
    w[0] = c["seasonal_var"]
    return G, f, w


COMPONENTS = {"local_linear_trend": _trend, "seasonal": _seasonal}


def matrices(spec: dict) -> dict:
    blocks = [(COMPONENTS[c["type"]](c), c.get("init_var", 1.0))
              for c in spec["components"]]
    d = sum(G.shape[0] for (G, _, _), _ in blocks)
    G = np.zeros((d, d))
    f, w, c0 = np.zeros(d), np.zeros(d), np.zeros(d)
    at = 0
    for (Gc, fc, wc), init_var in blocks:
        dc = Gc.shape[0]
        G[at:at + dc, at:at + dc] = Gc
        f[at:at + dc] = fc
        w[at:at + dc] = wc
        c0[at:at + dc] = init_var
        at += dc
    return dict(F=f[None, :], G=G, m0=np.zeros(d), C0=np.diag(c0),
                V=np.array([[spec["obs_var"]]]),
                W=np.diag(np.maximum(w, VARIANCE_FLOOR)))
