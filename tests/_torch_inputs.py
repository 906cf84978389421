"""Inputs shared by the PyTorch-port tests, made with numpy from a seed.

Imports neither jax nor cusmc_tpu, so tests/test_torch_cuda.py can use it
on a machine that has only the port's dependencies.
"""

import numpy as np


def search_inputs(rng, case, n, d):
    """A monotone float32 cdf, sorted systematic positions scaled by its
    total, and a packed state [d, n], for the inverse-CDF search: weights
    "uniform" (random), "concentrated" (one particle holds ~all the mass)
    or "zero-runs" (floor counts of sharp weights, mostly zeros)."""
    if case == "uniform":
        logw = rng.standard_normal(n)
        w = np.exp(logw - logw.max())
    elif case == "concentrated":
        w = np.full(n, np.exp(-20.0))
        w[0] = 1.0
    else:
        p = np.exp(3.0 * rng.standard_normal(n))
        w = np.floor(n * p / p.sum())
    cdf = np.cumsum(w.astype(np.float32), dtype=np.float32)
    u = np.float32(rng.uniform())
    pos = ((np.arange(n, dtype=np.float32) + u) / np.float32(n)
           * cdf[-1]).astype(np.float32)
    X = rng.standard_normal((d, n)).astype(np.float32)
    return cdf, pos, X


def monthly_dlm(device, noise="mvn"):
    """The monthly structural DLM of chip_smoke.py's phase 4g (a local
    linear trend and a 12-period seasonal: d = 13, k = 1), on ``device``;
    MVT with df=5 for ``noise="mvt"``."""
    import chip_smoke

    return chip_smoke.monthly_model(device, noise)


def monthly_mats():
    """G, Q, F, Li of the monthly structural DLM (d = 13, k = 1) on the
    CPU, as contiguous float32 numpy arrays."""
    from cusmc_tpu_torch.models import structural

    m = structural.combine([structural.local_linear_trend(init_var=0.01),
                            structural.seasonal(12, init_var=0.01)],
                           device="cpu")
    return tuple(np.ascontiguousarray(t.numpy(), dtype=np.float32)
                 for t in (m.G, m.W_sqrt, m.F, m.V_chol_inv))


def offset_clgssm(device, mats_constant):
    """The offset CLGSSM of benchmarks/bench_subsystems.py:43-66 (the demo
    DLM, d = k = 2, with a [sin u, cos u] observation offset), as
    chip_smoke.py's phase 4g builds it."""
    import chip_smoke

    return chip_smoke.bench_clgssm(mats_constant, device)


def dense_dlm(d, k, noise, df, device, state_dtype=None):
    """A DLM of state width d and observation width k made from a seed,
    with every factor dense: G a damped rotation, F [k, d] of scale 0.3,
    W and V full covariances (so W_sqrt and V^-1/2 are full triangles),
    m0 = 0, C0 = I; ``noise`` and ``df`` as ``DLM.create`` takes them."""
    from cusmc_tpu_torch.models.dlm import DLM

    rng = np.random.default_rng(100 * d + k)
    a = rng.standard_normal((d, d))
    b = rng.standard_normal((k, k))
    return DLM.create(F=0.3 * rng.standard_normal((k, d)),
                      G=0.9 * np.linalg.qr(rng.standard_normal((d, d)))[0],
                      m0=np.zeros(d), C0=np.eye(d),
                      V=0.01 * (b @ b.T / k + np.eye(k)),
                      W=0.001 * (a @ a.T / d + np.eye(d)), noise=noise,
                      df=df, state_dtype=state_dtype, device=device)
