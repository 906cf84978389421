"""``"kind": "dlm"``: a dynamic linear model given whole, the matrices
F [k, d], G [d, d], m0 [d], C0, V and W as nested lists."""

from __future__ import annotations

import numpy as np


def matrices(spec: dict) -> dict:
    return {k: np.asarray(spec[k], np.float64)
            for k in ("F", "G", "m0", "C0", "V", "W")}
