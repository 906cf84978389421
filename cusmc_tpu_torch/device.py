"""Device and generator helpers for the PyTorch port.

The JAX package picks its platform through ``jax.default_backend()``
(``cusmc_tpu/ops/cumsum.py:91``, ``ops/monotone_gather.py:103``); the port
names its device explicitly on every entry point instead. ``None`` means
the card, and a request for the card on a machine without one raises: the
port never moves work to the CPU behind the caller's back. CPU users and
the tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]
KeyLike = Union[int, torch.Generator, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA card; ``"cpu"`` -> the CPU. A CUDA
    device, named or by default, raises when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def as_tensor(a, dtype: Optional[torch.dtype] = None,
              device: DeviceLike = None) -> torch.Tensor:
    """An entry point's array argument as a tensor. A tensor keeps its
    device (unless ``device`` names one) and its dtype (unless ``dtype``
    does); anything else goes to ``resolve_device(device)``, as float32
    when ``dtype`` is None, the JAX package's default type."""
    if isinstance(a, torch.Tensor):
        dev = a.device if device is None else resolve_device(device)
        return a.to(device=dev, dtype=dtype or a.dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype or torch.float32,
                           device=resolve_device(device))


def make_generator(key: KeyLike, device: torch.device) -> torch.Generator:
    """An int seed (``None`` -> 0) becomes a fresh ``torch.Generator`` on
    ``device``; a Generator is checked to live on that device type."""
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(f"generator on {key.device} cannot draw for "
                             f"{device}")
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if key is None else int(key))
    return gen


def is_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise.
    Kernel wrappers take their plain version only when this is False."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
