"""Host-side trajectory store: a native arena with a numpy fallback.

Port of ``cusmc_tpu/io/native_store.py``. The streaming filter
(``smc/streaming.py``) copies each chunk's [k, N, d] history to the host
and appends it here, into one arena allocated up front for ``max_steps``
steps (``native/trajectory_store.cpp``: one 64-byte-aligned allocation, a
memcpy an append). ``force_numpy=True``, or a missing library, keeps the
same arena in numpy.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from cusmc_tpu_torch.io.native import get_lib


def _bind_store(lib) -> bool:
    try:
        lib.csmc_store_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.csmc_store_create.restype = ctypes.c_void_p
        lib.csmc_store_append.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int64]
        lib.csmc_store_append.restype = ctypes.c_int
        lib.csmc_store_size.argtypes = [ctypes.c_void_p]
        lib.csmc_store_size.restype = ctypes.c_int64
        lib.csmc_store_data.argtypes = [ctypes.c_void_p]
        lib.csmc_store_data.restype = ctypes.c_void_p
        lib.csmc_store_destroy.argtypes = [ctypes.c_void_p]
        lib.csmc_store_destroy.restype = None
    except AttributeError:
        return False
    return True


class _NativeArena:
    """Owns one native arena and frees it when the last reference goes:
    the store and every numpy view of the arena hold one, so no view
    outlives the memory it reads."""

    def __init__(self, lib, step_bytes: int, max_steps: int):
        self.lib = lib
        self.handle = lib.csmc_store_create(step_bytes, max_steps)

    def __del__(self):
        if self.handle:
            self.lib.csmc_store_destroy(self.handle)
            self.handle = None


class TrajectoryStore:
    """Append-only [max_steps, *step_shape] host buffer.

    ``append(block)`` takes [k, *step_shape] arrays; ``view()`` returns the
    filled [size, *step_shape] array (no copy on the native path).
    ``start_step`` is the timestep of row 0 (set by the streaming filter:
    a resumed run does not replay the history before its snapshot)."""

    def __init__(self, step_shape: Tuple[int, ...], max_steps: int,
                 dtype=np.float32, force_numpy: bool = False):
        self.step_shape = tuple(int(s) for s in step_shape)
        self.max_steps = int(max_steps)
        self.dtype = np.dtype(dtype)
        self.start_step = 0
        step_elems = int(np.prod(self.step_shape)) if self.step_shape else 1
        self._step_bytes = step_elems * self.dtype.itemsize
        self._native = None
        self._lib = None if force_numpy else get_lib()
        if self._lib is not None and _bind_store(self._lib):
            native = _NativeArena(self._lib, self._step_bytes,
                                  self.max_steps)
            if native.handle:
                self._native = native
        if self._native is not None:
            buf = (ctypes.c_char * (self._step_bytes * self.max_steps)
                   ).from_address(self._lib.csmc_store_data(
                       self._native.handle))
            buf.owner = self._native  # views keep the arena alive
            self._arena = np.frombuffer(buf, dtype=self.dtype).reshape(
                (self.max_steps,) + self.step_shape)
            self._size = None  # kept by the library
        else:
            self._arena = np.empty((self.max_steps,) + self.step_shape,
                                   self.dtype)
            self._size = 0

    @property
    def native(self) -> bool:
        """True when the arena is the native library's."""
        return self._native is not None

    @property
    def size(self) -> int:
        if self._native is not None:
            return int(self._lib.csmc_store_size(self._native.handle))
        return self._size

    def append(self, block: np.ndarray) -> None:
        block = np.ascontiguousarray(block, dtype=self.dtype)
        if block.shape[1:] != self.step_shape:
            raise ValueError(f"block shape {block.shape[1:]} != "
                             f"{self.step_shape}")
        k = block.shape[0]
        if self.size + k > self.max_steps:
            raise ValueError(f"store full: {self.size}+{k} > {self.max_steps}")
        if self._native is not None:
            rc = self._lib.csmc_store_append(
                self._native.handle, block.ctypes.data_as(ctypes.c_void_p), k)
            if rc != 0:
                raise RuntimeError("native append failed")
        else:
            self._arena[self._size:self._size + k] = block
            self._size += k

    def view(self) -> np.ndarray:
        return self._arena[:self.size]

    def close(self) -> None:
        """Keep a numpy copy of the history and let the native arena go
        (freed once no earlier ``view()`` of it is left)."""
        if self._native is not None:
            n = self.size
            self._arena = self._arena[:n].copy()
            self._size = n
            self._native = None
