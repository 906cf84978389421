"""Build and bind the hand-written CUDA kernels (``cusmc_tpu_torch/csrc``).

The ``.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``: one ``nvcc -c``
per source, all started together, then one link. The build happens at
first use, never on import, into ``build/cusmc_tpu_torch/`` beside the
package; the file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library. A failing ``nvcc``
raises with its output.

Each C entry launches on the stream it is given (PyTorch's current stream)
and returns ``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "cusmc_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17")
COMPILE_FLAGS = ARCH_FLAGS + ("-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                              "-c")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every pointer and the stream are c_void_p.
SIGNATURES = {
    "cusmc_blocked_cumsum": (_P, _P, _P, _LL, _P),
    # cdf, pos, X, out, anc, n, nq, nloc, base, d, stream
    "cusmc_inverse_cdf_apply": (_P,) * 5 + (_LL,) * 4 + (_I, _P),
    "cusmc_inverse_cdf_search": (_P, _P, _P, _LL, _LL, _P),
    # X, a, out, n, m, d, stream
    "cusmc_take_columns": (_P, _P, _P, _LL, _LL, _I, _P),
    "cusmc_roll_metropolis": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P),
    "cusmc_cumsum_tile": (),
    # X, logw, y, G, Q, F, Li, s, seed, Xo, ll, anc, n, tile, d, k,
    # num_sweeps, num_window_tiles, noise, df_int, df, log_norm, stream
    "cusmc_fused_step": (_P,) * 12 + (_LL, _LL) + (_I,) * 6 + (_F, _F, _P),
    # cdf, X, y, G, Q, F, Li, u, seed, Xo, ll, anc, n, tile, d, k, mode,
    # noise, df_int, df, log_norm, stream
    "cusmc_fused_cdf_step": (_P,) * 12 + (_LL, _LL) + (_I,) * 5
    + (_F, _F, _P),
}

# Filled by ``library()``: the build's wall time and nvcc's output (ptxas
# register and spill report), for chip_smoke.py to print.
build_info: dict = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of cusmc_tpu_torch are built from source at first use")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcusmc_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise with the output of the first
    that fails, else return all their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], None
    for cmd, proc in zip(cmds, procs):
        try:
            out, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed with code {rc}:\n{' '.join(cmd)}\n"
                           f"{out}")
    return "".join(logs)


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        build_info.update(seconds=0.0, log="(cached)", path=str(out))
        return out
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    tmp = out.with_name(f"{tag}.tmp.so")
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
                        for src, obj in zip(cu, objs)])
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(out))
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.cusmc_error_string.argtypes = [ctypes.c_int]
    lib.cusmc_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().cusmc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
