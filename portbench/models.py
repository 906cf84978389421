"""A configuration file as the model and observations a run hands to
both sides, in float64 NumPy.

A configuration's ``model`` names its kind, ``{"kind": <kind>, ...}``,
and ``portbench/model_kinds/<kind>.py`` builds its matrices from the
rest (``matrices(spec)``). A kind may also bring ``simulate(model,
steps, seed)``, where its observations are simulated and the linear
Gaussian path below is not its own, and ``step_work(cell)``, where
``work.step_work``'s count of a DLM step is not its own. Every model
carries ``noise`` ("mvn" or "mvt") and, for MVT, ``df``.

``observations`` is ``{"file": path, "rows": T}`` (a CSV with a header,
row 0 the unused zero row; its first T rows are the configuration's
data) or ``{"simulate": true, "rows": T}``: a path of the model itself,
drawn in NumPy, row 0 zero. A traffic file's ``steps`` takes the first
``steps`` of those rows.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench import spec, work

ROOT = Path(__file__).resolve().parent.parent


def kind(name: str):
    return spec.module("model_kinds", name)


def matrices(cfg: dict) -> dict:
    """The model dict: its kind's matrices (float64), noise and df."""
    model = cfg["model"]
    mats = kind(model["kind"]).matrices(model)
    mats["noise"] = model["noise"]
    mats["df"] = model.get("df")
    return mats


def simulate(model: dict, steps: int, seed: int) -> np.ndarray:
    """ys [steps, k] of an MVN linear model's own path; row 0 zero."""
    if model["noise"] != "mvn":
        raise ValueError("observations are simulated from MVN models only")
    rng = np.random.Generator(np.random.PCG64(seed))
    F, G = model["F"], model["G"]
    w_root = np.linalg.cholesky(model["W"])
    v_root = np.linalg.cholesky(model["V"])
    x = model["m0"] + np.linalg.cholesky(model["C0"]) @ rng.standard_normal(
        G.shape[0])
    ys = np.zeros((steps, F.shape[0]))
    for t in range(1, steps):
        x = G @ x + w_root @ rng.standard_normal(G.shape[0])
        ys[t] = F @ x + v_root @ rng.standard_normal(F.shape[0])
    return ys


def observations(cfg: dict, model: dict, steps: int, seed: int) -> np.ndarray:
    """The first ``steps`` of the configuration's ``rows`` observations."""
    src = cfg["observations"]
    rows = int(src["rows"])
    if steps > rows:
        raise ValueError(f"{steps} steps asked of a configuration with "
                         f"{rows} rows")
    if "file" in src:
        ys = np.loadtxt(ROOT / src["file"], delimiter=",", skiprows=1,
                        ndmin=2)
        if ys.shape[0] < rows:
            raise ValueError(f"{src['file']} has {ys.shape[0]} rows, "
                             f"{rows} named")
        return np.ascontiguousarray(ys[:steps])
    draw = getattr(kind(cfg["model"]["kind"]), "simulate", simulate)
    return draw(model, rows, seed)[:steps]


def step_work(cell: dict):
    """``(bytes, flops, peak, ops)`` of one whole filter step of ``cell``
    (``run.flat_cell``): its kind's own count, else a DLM step's."""
    own = getattr(kind(cell["kind"]), "step_work", work.step_work)
    return own(cell)
