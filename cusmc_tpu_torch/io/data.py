"""Bundled demo dataset and CSV IO.

Port of ``cusmc_tpu/io/data.py`` (``demo_model_params``,
``generate_y_sim``, ``load_csv``, ``load_y_sim``, ``write_sim_output``,
``write_output``) in plain numpy, the files byte for byte the JAX
package's given the same arrays. The bundled 1001-step trace ships with
this package (``_data/y_sim.csv``, a byte-for-byte copy of the JAX
package's), so the port reads it wherever it is installed. It is not
regenerated: ``generate_y_sim`` takes the file to write as a required
argument; its trace comes from ``DLM.simulate`` on a ``torch.Generator``
(Philox), the same law as the bundled one but other numbers. ``load_csv`` parses with
the native C++ parser of ``native/`` (``io/native.py``) when the library
is built (``make -C native``), as the JAX package does, and with numpy
otherwise.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

Y_SIM_PATH = Path(__file__).resolve().parent / "_data" / "y_sim.csv"


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


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def generate_y_sim(path, num_steps: int = 1001, seed: int = 0,
                   device=None) -> np.ndarray:
    """Simulate the demo DLM (MVN, float32) for ``num_steps`` steps on
    ``device`` (None: the card) and write its observations to ``path`` in
    the bundled trace's format: header ``y0,y1``, a zero first row,
    ``%.6g``. Returns them [T, 2]."""
    import torch

    from cusmc_tpu_torch.models.dlm import DLM

    model = DLM.create(noise="mvn", dtype=torch.float32, device=device,
                       **demo_model_params())
    gen = torch.Generator(device=model.device).manual_seed(seed)
    _, ys = model.simulate(gen, num_steps)
    ys = _host(ys)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = ",".join(f"y{j}" for j in range(ys.shape[1]))
    np.savetxt(path, ys, delimiter=",", header=header, comments="",
               fmt="%.6g")
    return ys


def load_csv(path, force_numpy: bool = False) -> np.ndarray:
    """Load a headered CSV of floats -> [rows, cols] float64 array,
    through the native parser when it is built (unless ``force_numpy``);
    where the native parser fails, numpy parses (and reports) instead, as
    in the JAX package."""
    if not force_numpy:
        from cusmc_tpu_torch.io.native import load_csv_native

        try:
            out = load_csv_native(path)
        except OSError:
            out = None
        if out is not None:
            return out
    return np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64)


def load_y_sim(path: Optional[str] = None) -> np.ndarray:
    """The bundled observation trace [T, 2] (T=1001, first row zeros)."""
    path = Path(path) if path is not None else Y_SIM_PATH
    if not path.exists():
        raise FileNotFoundError(
            f"{path}: the bundled trace ships with the package")
    return load_csv(path)


def write_sim_output(out_dir: str, prior_x, ys, weights, posterior_x,
                     p: int = 0) -> None:
    """Export a simulated run's traces: ``prior_x_t.csv`` (the latent
    path, header ``x0,x1,...``) and the files of ``write_output``."""
    os.makedirs(out_dir, exist_ok=True)
    prior_x = _host(prior_x)
    header = ",".join(f"x{j}" for j in range(prior_x.shape[1]))
    np.savetxt(os.path.join(out_dir, "prior_x_t.csv"), prior_x,
               delimiter=",", header=header, comments="", fmt="%.6g")
    write_output(out_dir, ys, weights, posterior_x, p)


def write_output(out_dir: str, ys, weights, posterior_x,
                 p: int = 0) -> None:
    """Export run results: ``y_t.csv`` (observations) and ``x_t_N{p}.csv``
    with columns ``w,x...`` = first-particle weight then particle p's
    state per step. Arrays or tensors (on any device)."""
    os.makedirs(out_dir, exist_ok=True)
    ys = _host(ys)
    weights = _host(weights)
    posterior_x = _host(posterior_x)
    d = ys.shape[1]
    header = ",".join(f"y{j}" for j in range(d))
    np.savetxt(os.path.join(out_dir, "y_t.csv"), ys, delimiter=",",
               header=header, comments="", fmt="%.6g")
    tracked = np.concatenate([weights[:, :1], posterior_x[:, p, :]], axis=1)
    np.savetxt(os.path.join(out_dir, f"x_t_N{p}.csv"), tracked, delimiter=",",
               header="w," + ",".join(["x"] * posterior_x.shape[2]),
               comments="", fmt="%.6g")
