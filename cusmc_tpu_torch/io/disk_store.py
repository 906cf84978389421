"""Out-of-core trajectory store: particle history spilled to disk through
the native asynchronous writer.

Port of ``cusmc_tpu/io/disk_store.py``. The same append interface as
``TrajectoryStore`` (``io/native_store.py``), but the arena is a file:
each [k, *step_shape] block is copied into a buffer of the writer's pool
and appended to the file by a background thread
(``native/async_writer.cpp``), so the streaming loop goes back to the
card at once. Use it when T x N x d outgrows host memory.
``force_python=True``, or a missing library, writes synchronously from
Python instead, to the same bytes.

``view()`` memory-maps the finished file read-only; a JSON sidecar
(``path + ".json"``) records the shape, dtype, size and start step, so
``DiskTrajectoryStore.open(path)`` reopens a store later.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Tuple

import numpy as np

from cusmc_tpu_torch.io.native import get_lib


def _bind_writer(lib) -> bool:
    if lib is None:
        return False
    try:
        lib.csmc_writer_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.csmc_writer_create.restype = ctypes.c_void_p
        lib.csmc_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int64]
        lib.csmc_writer_submit.restype = ctypes.c_int
        lib.csmc_writer_flush.argtypes = [ctypes.c_void_p]
        lib.csmc_writer_flush.restype = ctypes.c_int
        lib.csmc_writer_error.argtypes = [ctypes.c_void_p]
        lib.csmc_writer_error.restype = ctypes.c_int
        lib.csmc_writer_destroy.argtypes = [ctypes.c_void_p]
        lib.csmc_writer_destroy.restype = None
    except AttributeError:
        return False
    return True


class DiskTrajectoryStore:
    """Append-only on-disk [steps, *step_shape] history.

    ``append(block)`` takes [k, *step_shape] arrays and returns without
    waiting for the disk (native path); ``finish()`` drains the queue,
    fsyncs and writes the sidecar; ``view()`` returns a read-only memmap
    of the written history."""

    def __init__(self, path: str, step_shape: Tuple[int, ...],
                 dtype=np.float32, queue_depth: int = 4,
                 force_python: bool = False):
        self.path = path
        self.step_shape = tuple(int(s) for s in step_shape)
        self.dtype = np.dtype(dtype)
        self.size = 0
        self.start_step = 0
        self._finished = False
        self._handle = None
        self._fh = None
        self._lib = None if force_python else get_lib()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if _bind_writer(self._lib):
            self._handle = self._lib.csmc_writer_create(
                path.encode(), int(queue_depth))
        if not self._handle:
            self._handle = None
            self._fh = open(path, "wb")  # the synchronous fallback

    @property
    def native(self) -> bool:
        return self._handle is not None

    def append(self, block: np.ndarray) -> None:
        if self._finished:
            raise RuntimeError("store already finished")
        block = np.ascontiguousarray(block, self.dtype)
        if block.shape[1:] != self.step_shape:
            raise ValueError(f"block shape {block.shape[1:]} != step shape "
                             f"{self.step_shape}")
        if self._handle is not None:
            rc = self._lib.csmc_writer_submit(
                self._handle, block.ctypes.data_as(ctypes.c_void_p),
                block.nbytes)
            if rc != 0:
                raise OSError(rc, f"async writer failed: errno {rc}")
        else:
            self._fh.write(block.tobytes())
        self.size += block.shape[0]

    def finish(self) -> None:
        """Drain the queue, fsync, write the JSON sidecar."""
        if self._finished:
            return
        if self._handle is not None:
            rc = self._lib.csmc_writer_flush(self._handle)
            if rc != 0:
                raise OSError(rc, f"async writer flush failed: errno {rc}")
            self._lib.csmc_writer_destroy(self._handle)
            self._handle = None
        else:
            self._fh.close()
            self._fh = None
        with open(self.path + ".json", "w") as f:
            json.dump({"step_shape": list(self.step_shape),
                       "dtype": self.dtype.name, "size": self.size,
                       "start_step": self.start_step}, f)
        self._finished = True

    def view(self) -> np.ndarray:
        """Read-only memmap [size, *step_shape] of the written history."""
        self.finish()
        return np.memmap(self.path, dtype=self.dtype, mode="r",
                         shape=(self.size,) + self.step_shape)

    # The TrajectoryStore name of the same view.
    array = view

    @classmethod
    def open(cls, path: str) -> np.ndarray:
        """Reopen a finished store's history as a read-only memmap."""
        with open(path + ".json") as f:
            meta = json.load(f)
        return np.memmap(path, dtype=np.dtype(meta["dtype"]), mode="r",
                         shape=(meta["size"],) + tuple(meta["step_shape"]))

    def close(self) -> None:
        self.finish()

    def __del__(self):
        try:
            if self._handle is not None:
                self._lib.csmc_writer_destroy(self._handle)
            if self._fh is not None:
                self._fh.close()
        except Exception:
            pass
