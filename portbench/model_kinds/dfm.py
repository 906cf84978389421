"""``"kind": "dfm"``: the approximate dynamic factor model of Stock &
Watson (2002), r factors seen through a panel of k series,

    f_t = Phi f_{t-1} + u_t,  u_t ~ N(0, W),
    y_t = Lambda f_t + e_t,   e_t ~ N(0, Psi),  Psi diagonal,

a DLM with F = Lambda [k, r], G = Phi, V = Psi and d = r. It is built
from ``{"factors": r, "series": k, "phi": phi, "loading_var": s2,
"psi_low": a, "psi_high": b, "seed": s}``: Phi = phi I and W = (1 -
phi^2) I, so that each factor has unit stationary variance, m0 = 0 and
C0 = I (the stationary law); Lambda's entries i.i.d. N(0, s2) and the
idiosyncratic variances psi_i i.i.d. Uniform(a, b), drawn in that order
in NumPy (PCG64) from ``seed``. Its observations are the default linear
path of ``models.simulate``.

``step_work`` counts the least work of a filter step of this model,
whatever engine runs it: ``work.step_work``'s bytes and draws, and the
flops the model needs, 2 d^2 for Phi f, 2 d^2 for W^(1/2) z, 2 k d for
Lambda f and 3 k for the diagonal whitening, the squares and their sum.
``work.step_ops`` charges a DLM the dense 2 k^2 of the inverse root of V
in place of the 3 k, 94% of the step at k = 134, which a diagonal Psi
does not need. ``loglik_work`` is the least work of the log-likelihood
alone, which ``metrics/obs_loglik_roofline.py`` reads through
``models.kind``.
"""

from __future__ import annotations

import numpy as np

from portbench import work


def matrices(spec: dict) -> dict:
    r, k = int(spec["factors"]), int(spec["series"])
    phi = float(spec["phi"])
    rng = np.random.Generator(np.random.PCG64(int(spec["seed"])))
    loadings = rng.normal(0.0, np.sqrt(float(spec["loading_var"])), (k, r))
    psi = rng.uniform(float(spec["psi_low"]), float(spec["psi_high"]), k)
    eye = np.eye(r)
    return dict(F=loadings, G=phi * eye, m0=np.zeros(r), C0=eye.copy(),
                V=np.diag(psi), W=(1.0 - phi * phi) * eye)


def loglik_flops(d: int, k: int) -> int:
    """Flops of one particle's log-likelihood: Lambda f, then each
    residual whitened by its own scale, squared and summed."""
    return 2 * k * d + 3 * k


def loglik_work(cell: dict):
    """``(bytes, flops)`` of one step's log-likelihood of the cell's
    particles: X read (float32), the log-likelihoods written, y_t read;
    ``cell`` as ``step_work`` takes it."""
    d, k, n = cell["d"], cell["k"], cell["particles"]
    return (4 * d + 4) * n + 4 * k, loglik_flops(d, k) * n


def step_work(cell: dict):
    """``(bytes, flops, peak, ops)`` of one whole filter step (see the
    module's docstring): ``work.step_work``'s with this model's flops;
    ``cell`` as it takes it."""
    nbytes, _, peak, ops = work.step_work(cell)
    d, k, n = cell["d"], cell["k"], cell["particles"]
    flops = float(2 * d * d + 2 * d * d + loglik_flops(d, k)) * n
    return nbytes, flops, peak, ops
