"""Checkpoint and resume of a running filter.

Port of ``cusmc_tpu/checkpoint.py``. The carry of the streaming filter
(``smc/streaming.py``) at a chunk boundary is the resume point: the
particles in the public [N, d] layout, their normalised log weights, the
state of the generator(s) the run draws from (``utils/rng.py``; it takes
the place of JAX's ``key_data``), the step t and the log-evidence so far.

Orbax belongs to JAX, so the port always writes the JAX package's numpy
fallback: one ``step_{t}.npz`` a snapshot. ``use_orbax`` is accepted for
the JAX package's signature and changes nothing.

Two entries the JAX snapshot lacks: ``generator_state`` (uint8 [S, B]:
the state of each of S generators, one for a single-device run; for a
sharded run the common stream, then every rank's stream in rank order)
and, when the caller passes them, the per-step evidence increments whose
sum the log-evidence is. With them a resumed run sums the same increments
as an uninterrupted one and so returns the same log-evidence, bit for bit.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class FilterCheckpoint:
    """Snapshots of a running filter in the directory ``path``."""

    def __init__(self, path: str, use_orbax: bool = True):
        del use_orbax  # orbax is JAX's; the port writes .npz files
        self.path = path

    def save(self, t: int, particles, log_weights, generator_state,
             log_evidence, increments=None) -> str:
        """Write the snapshot of step ``t``; returns its path.
        ``particles`` [N, d], ``log_weights`` [N] (arrays or tensors on any
        device), ``generator_state`` one state or a sequence of states of
        ``utils.rng.generator_state``, ``log_evidence`` the evidence so
        far, ``increments`` (optional) the per-step increments it sums."""
        states = generator_state
        if isinstance(states, np.ndarray) and states.ndim == 1:
            states = [states]
        state = {
            "t": np.asarray(t),
            "particles": _host(particles),
            "log_weights": _host(log_weights),
            "generator_state": np.stack([np.asarray(s, np.uint8)
                                         for s in states]),
            "log_evidence": np.asarray(float(log_evidence)),
        }
        if increments is not None:
            state["increments"] = _host(increments)
        os.makedirs(self.path, exist_ok=True)
        fp = self.snapshot_path(t)
        np.savez(fp, **state)
        return fp

    def snapshot_path(self, t: int) -> str:
        """The file that ``save`` writes for step ``t``."""
        return os.path.join(self.path, f"step_{t}.npz")

    def latest(self) -> Optional[str]:
        """The snapshot of the highest step, or None."""
        if not os.path.isdir(self.path):
            return None
        steps = []
        for name in os.listdir(self.path):
            stem = name.replace(".npz", "")
            if stem.startswith("step_"):
                try:
                    steps.append((int(stem.split("_")[1]), name))
                except ValueError:
                    pass
        if not steps:
            return None
        return os.path.join(self.path, max(steps)[1])

    def restore(self, snapshot: Optional[str] = None) -> dict:
        """Load a snapshot (default: the latest). Returns a dict with
        ``t``, ``particles``, ``log_weights``, ``generator_state`` (uint8
        [S, B]), ``log_evidence`` and ``increments`` (None when the
        snapshot has none); the arrays are numpy."""
        snapshot = snapshot or self.latest()
        if snapshot is None:
            raise FileNotFoundError(f"no checkpoints under {self.path}")
        with np.load(snapshot) as data:
            data = dict(data)
        return {
            "t": int(data["t"]),
            "particles": data["particles"],
            "log_weights": data["log_weights"],
            "generator_state": data["generator_state"],
            "log_evidence": float(data["log_evidence"]),
            "increments": data.get("increments"),
        }


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)
