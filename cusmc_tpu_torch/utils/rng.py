"""The port's generator discipline, in one place.

Counterpart of ``cusmc_tpu/utils/rng.py``. The JAX package derives every
draw from a key tree (``:15-27``): ``step_key(key, t)`` folds the step into
the run's key, ``phase_keys(key, n)`` splits a step's key into one key per
phase (resample, propagate), and ``shard_key(key, axis)`` folds a shard's
index in. The port draws from ``torch.Generator``s instead:

- ``make_generator(seed, device)`` (``device.py``) is the one generator of
  a single-device run, seeded with the run's int seed. The filter draws
  from it in a fixed order: the initial cloud, then per step the resample
  draws (when it resamples) and the propagation noise. So the order of
  the draws is the schedule: ``step_key`` and ``phase_keys`` have no
  counterpart, and a run cut into chunks draws what the whole run draws.
- ``rank_seed(seed, p)`` and ``make_streams(seed, axis, device)``
  (``parallel/mesh.py``) are ``shard_key``'s counterpart: a common stream
  seeded with the run's seed, the same on every rank, and a rank stream
  seeded with a splitmix64 mix of the seed and the rank.
- ``generator_state(gen)`` and ``set_generator_state(gen, state)`` read
  and restore a generator's state as bytes; in a checkpoint they take the
  place of JAX's ``key_data``. A CPU generator's state is its mt19937
  state (5056 bytes), a CUDA generator's its Philox seed and offset (16
  bytes, read without a device sync). A state restores only into a
  generator of the same device type.
- ``resume_seed(seed, t)`` seeds streams anew where a snapshot's streams
  cannot be restored as they were (a sharded run resumed on another group
  size): ``make_streams(resume_seed(seed, t), axis, device)``.
"""

from __future__ import annotations

import numpy as np
import torch

from cusmc_tpu_torch.device import make_generator
from cusmc_tpu_torch.parallel.mesh import make_streams, rank_seed

__all__ = ["generator_state", "make_generator", "make_streams",
           "rank_seed", "resume_seed", "set_generator_state"]


def generator_state(gen: torch.Generator) -> np.ndarray:
    """The generator's state as a uint8 array (a copy)."""
    return gen.get_state().numpy().copy()


def set_generator_state(gen: torch.Generator, state) -> None:
    """Restore a state of ``generator_state`` into ``gen``. Raises
    ``ValueError`` when the state is not one of ``gen``'s kind (a CPU
    state into a CUDA generator, say)."""
    state = torch.as_tensor(np.asarray(state, dtype=np.uint8))
    if state.numel() != gen.get_state().numel():
        raise ValueError(
            f"a {state.numel()}-byte generator state cannot restore a "
            f"{gen.device.type} generator "
            f"({gen.get_state().numel()} bytes)")
    gen.set_state(state.clone())


def resume_seed(seed: int, t: int) -> int:
    """A seed for streams drawn anew at step ``t`` of a run seeded with
    ``seed``: ``rank_seed``'s splitmix64 step at the rank -(t + 1), which
    no rank stream takes."""
    return rank_seed(seed, -(int(t) + 1))
