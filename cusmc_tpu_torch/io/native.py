"""ctypes bindings to the C++ host runtime, ``native/build/libcusmc_host.so``.

Port of ``cusmc_tpu/io/native.py`` over the same library (build it with
``make -C native``), bound here anew because the JAX package's module
imports JAX. The library parses and writes float CSVs
(``native/csv.cpp``), keeps a host arena for streamed history
(``native/trajectory_store.cpp``, bound in ``io/native_store.py``) and
spills history to disk on a background thread (``native/async_writer.cpp``,
``io/disk_store.py``). Every entry point has a numpy or Python fallback,
so the port works without the compiled library: ``get_lib()`` is then
None.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent


def lib_path() -> Optional[Path]:
    """The built library of the checkout, or None."""
    for cand in (_ROOT / "native" / "build" / "libcusmc_host.so",
                 _ROOT / "native" / "libcusmc_host.so"):
        if cand.exists():
            return cand
    return None


def get_lib():
    """The loaded library with its CSV entry points bound, or None while it
    is not built (a later call finds a library built since)."""
    path = lib_path()
    return None if path is None else _load(str(path))


@functools.cache
def _load(path: str):
    """Load a library once a process and bind its CSV entry points."""
    lib = ctypes.CDLL(path)
    lib.csmc_csv_dims.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_long),
                                  ctypes.POINTER(ctypes.c_long)]
    lib.csmc_csv_dims.restype = ctypes.c_int
    lib.csmc_csv_read.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_long, ctypes.c_long]
    lib.csmc_csv_read.restype = ctypes.c_int
    lib.csmc_csv_write.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.c_long, ctypes.c_long]
    lib.csmc_csv_write.restype = ctypes.c_int
    return lib


def load_csv_native(path) -> Optional[np.ndarray]:
    """Parse a headered float CSV with the native parser -> [rows, cols]
    float64; None when the library is not built."""
    lib = get_lib()
    if lib is None:
        return None
    name = str(path).encode()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    if lib.csmc_csv_dims(name, ctypes.byref(rows), ctypes.byref(cols)) != 0:
        raise IOError(f"native csv dims failed for {path}")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    if lib.csmc_csv_read(name, ptr, rows.value, cols.value) != 0:
        raise IOError(f"native csv read failed for {path}")
    return out


def write_csv_native(path, header: str, data: np.ndarray) -> bool:
    """Write a headered float CSV natively; False when the library is not
    built."""
    lib = get_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim != 2:
        raise ValueError(f"expected a 2-d array, got shape {data.shape}")
    ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.csmc_csv_write(str(path).encode(), header.encode(), ptr,
                            data.shape[0], data.shape[1])
    if rc != 0:
        raise IOError(f"native csv write failed for {path}")
    return True
