"""Bundled demo dataset and CSV IO.

Port of ``cusmc_tpu/io/data.py:28-123`` (``demo_model_params``,
``load_csv``, ``load_y_sim``, ``write_output``) in plain numpy. The bundled
1001-step trace is read by file path from the JAX package's data directory
(``cusmc_tpu/io/_data/y_sim.csv``): it is neither copied nor regenerated
here, and ``cusmc_tpu`` is not imported. The native C++ CSV parser is not
used.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

Y_SIM_PATH = (Path(__file__).resolve().parent.parent.parent / "cusmc_tpu"
              / "io" / "_data" / "y_sim.csv")


def demo_model_params(d: int = 2, dtype=np.float64) -> dict:
    """The demo DLM of the bundled trace: a slowly rotating, slightly
    damped latent state observed directly with small noise."""
    theta = 0.05
    rot = np.eye(d, dtype=dtype)
    rot[0, 0] = np.cos(theta)
    rot[0, 1] = -np.sin(theta)
    rot[1, 0] = np.sin(theta)
    rot[1, 1] = np.cos(theta)
    return dict(
        F=np.eye(d, dtype=dtype),
        G=(0.999 * rot).astype(dtype),
        m0=np.zeros(d, dtype=dtype),
        C0=np.eye(d, dtype=dtype),
        V=(0.001 * np.eye(d, dtype=dtype)),
        W=(0.001 * np.eye(d, dtype=dtype)),
    )


def load_csv(path) -> np.ndarray:
    """Load a headered CSV of floats -> [rows, cols] float64 array."""
    return np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64)


def load_y_sim(path: Optional[str] = None) -> np.ndarray:
    """The bundled observation trace [T, 2] (T=1001, first row zeros)."""
    path = Path(path) if path is not None else Y_SIM_PATH
    if not path.exists():
        raise FileNotFoundError(
            f"{path}: the bundled trace ships with the cusmc_tpu package")
    return load_csv(path)


def write_output(out_dir: str, ys: np.ndarray, weights: np.ndarray,
                 posterior_x: np.ndarray, p: int = 0) -> None:
    """Export run results: ``y_t.csv`` (observations) and ``x_t_N{p}.csv``
    with columns ``w,x...`` = first-particle weight then particle p's
    state per step."""
    os.makedirs(out_dir, exist_ok=True)
    ys = np.asarray(ys)
    weights = np.asarray(weights)
    posterior_x = np.asarray(posterior_x)
    d = ys.shape[1]
    header = ",".join(f"y{j}" for j in range(d))
    np.savetxt(os.path.join(out_dir, "y_t.csv"), ys, delimiter=",",
               header=header, comments="", fmt="%.6g")
    tracked = np.concatenate([weights[:, :1], posterior_x[:, p, :]], axis=1)
    np.savetxt(os.path.join(out_dir, f"x_t_N{p}.csv"), tracked, delimiter=",",
               header="w," + ",".join(["x"] * posterior_x.shape[2]),
               comments="", fmt="%.6g")
