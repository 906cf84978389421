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
# The block-window searches' sizes (csrc/common.cuh), known only here and
# compiled into the kernels as -D defines: the search-only and the
# search-and-apply kernels' queries a block and their shared cdf window in
# floats (csrc/monotone_gather.cu), the
# fused inverse-CDF step's slots a block and its window
# (csrc/fused_cdf_step.cu). Whatever reports on the window reads them here;
# PERF.md says how they were chosen on the H100.
SEARCH_BLOCK = 512
SEARCH_WINDOW = 4096
CDF_BLOCK = 128
CDF_WINDOW = 2048
DEFINES = tuple(f"-DCUSMC_{name}={value}" for name, value in (
    ("SEARCH_BLOCK", SEARCH_BLOCK), ("SEARCH_WINDOW", SEARCH_WINDOW),
    ("CDF_BLOCK", CDF_BLOCK), ("CDF_WINDOW", CDF_WINDOW)))
COMPILE_FLAGS = ARCH_FLAGS + DEFINES + ("-O3", "-Xcompiler", "-fPIC",
                                        "-Xptxas", "-v", "-c")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every pointer and the stream are c_void_p.
SIGNATURES = {
    # w, cdf, state, state_words, n, ticket_base, epoch, stream
    "cusmc_blocked_cumsum": (_P, _P, _P, _LL, _LL, _LL, _I, _P),
    # cdf, pos, X, out, anc, n, nq, nloc, base, d, bf16, stream
    "cusmc_inverse_cdf_apply": (_P,) * 5 + (_LL,) * 4 + (_I, _I, _P),
    "cusmc_inverse_cdf_search": (_P, _P, _P, _LL, _LL, _P),
    # X, a, out, n, m, d, bf16, stream
    "cusmc_take_columns": (_P, _P, _P, _LL, _LL, _I, _I, _P),
    # w, shifts, u, X, out, anc, n, num_sweeps, d, bf16, band_rows, stream
    "cusmc_roll_metropolis": (_P,) * 6 + (_LL, _I, _I, _I, _I, _P),
    # X, logw, y, G, Q, F, Li, s, seed, Xo, ll, anc, n, tile, d, k,
    # num_sweeps, num_window_tiles, noise, df_int, df, log_norm, tiled,
    # dm, km, bf16, stream
    "cusmc_fused_step": (_P,) * 12 + (_LL, _LL) + (_I,) * 6
    + (_F, _F, _I, _I, _I, _I, _P),
    # cdf, X, y, G, Q, F, Li, u, seed, Xo, ll, anc, n, tile, d, k, mode,
    # noise, df_int, df, log_norm, tiled, dm, km, stream
    "cusmc_fused_cdf_step": (_P,) * 12 + (_LL, _LL) + (_I,) * 5
    + (_F, _F, _I, _I, _I, _P),
    # X, ldx, z, ldz, u, ldu, zc, G, Q, Xo, n, d, noise, df_int, df, dm,
    # stream
    "cusmc_packed_propagate": (_P, _LL, _P, _LL, _P, _LL) + (_P,) * 4
    + (_LL, _I, _I, _I, _F, _I, _P),
    # X, ldx, y, F, Li, log_norm, ll, n, d, k, noise, df, dm, km, stream
    "cusmc_packed_loglik": (_P, _LL) + (_P,) * 5
    + (_LL, _I, _I, _I, _F, _I, _I, _P),
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


# The particle state's types: float32, or bfloat16 under mixed precision.
STATE_DTYPES = (torch.float32, torch.bfloat16)


def require_state(X: torch.Tensor, name: str, device: torch.device) -> int:
    """Validate a particle state [d, N] of either state type; returns the
    kernels' ``bf16`` flag (1 for bfloat16, 0 for float32)."""
    if X.dtype not in STATE_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {X.dtype}")
    require(X, name, X.dtype, 2, device)
    return int(X.dtype == torch.bfloat16)


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
