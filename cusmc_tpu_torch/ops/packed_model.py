"""The DLM's composed packed step: propagate and log-likelihood.

``DLM.propagate_packed`` and ``DLM.observation_logpdf_packed``
(``models/dlm.py``) run here. The plain versions, ``packed_propagate_plain``
and ``packed_loglik_plain``, are the port of ``cusmc_tpu/models/dlm.py``'s
packed methods (``:155-207``), held to the JAX package on the CPU: on the
card each is cuBLAS products (``ops/packed.matvec``) and some ten
elementwise and reduction kernels, each writing a [d, N] or [N]
intermediate. ``packed_propagate`` and ``packed_loglik`` launch one
hand-written kernel each instead (``csrc/packed_model.cu``: a particle's
products and the chain around them in registers); on a CPU tensor they
take their plain versions. ``.launches`` counts each kernel's launches.

The composed step takes the kernels where ``takes_kernel`` holds: a
float32 state and weights on the card, d and k at most
``MAX_KERNEL_WIDTH``, a state with a unit inner stride (a column slice is
read through its row stride) and one chi-square a particle. Everywhere
else it keeps the plain version: on the CPU, for a bfloat16 state (whose
rounding law is the plain version's), past 16 (where the products are
large enough for ``torch.matmul``) and with ``per_dim_chi``.

The kernels draw nothing: ``packed_propagate`` takes the draws of
``DLM.packed_noise``, so a seed gives the same draws on both paths. For
an integer df it takes the chi-square's uniform and normal rows and runs
``chi2_integer_df_transform`` in the kernel; for another df it takes g
from the plain ``chi2_transform`` (the four Marsaglia-Tsang rounds stay
in PyTorch). Each elementwise operation is rounded as the plain version
rounds it; the products are FMA chains over the columns in order, where
cuBLAS sums in its own order.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from cusmc_tpu_torch.device import is_cuda
from cusmc_tpu_torch.ops import kernels
from cusmc_tpu_torch.ops.fused_step import THREAD_BUCKET_DIMS, step_widths
from cusmc_tpu_torch.ops.packed import matvec, quadform
from cusmc_tpu_torch.ops.random import chi2_transform

# The widest d and k the kernels take: the "thread" design's largest
# width bucket.
MAX_KERNEL_WIDTH = THREAD_BUCKET_DIMS[-1]


def takes_kernel(device, state_dtype: torch.dtype, weight_dtype: torch.dtype,
                 d: int, k: int, n: int, inner_stride: int,
                 per_dim_chi: bool) -> bool:
    """Whether the composed step of a DLM runs the kernels on a state
    [d, n] of ``state_dtype`` on ``device`` whose particles lie
    ``inner_stride`` apart."""
    return (torch.device(device).type == "cuda"
            and state_dtype == torch.float32
            and weight_dtype == torch.float32
            and d <= MAX_KERNEL_WIDTH and k <= MAX_KERNEL_WIDTH
            and n < 1 << 31 and inner_stride == 1 and not per_dim_chi)


def sample_packed_plain(model, mean: torch.Tensor, scale: torch.Tensor,
                        noise: tuple) -> torch.Tensor:
    """mean [d, n] (or [d, 1]) + scale @ z in the state dtype (``scale``
    may be a float32 copy), on the draws ``noise`` of
    ``model.packed_noise``; MVT applies the chi-square scale mixture along
    the particle axis, its factor ``sqrt(df / g)`` computed in the weight
    dtype and cast once to the state dtype."""
    z = noise[0]
    sdtype = model.state_dtype
    if model.noise != "mvt":
        return mean + matvec(scale, z, out_dtype=sdtype)
    lz = matvec(scale, z, out_dtype=sdtype)
    g = chi2_transform(model.df_value, model.df_int, noise[1])
    return mean + lz * torch.sqrt(torch.div(model.df, g)).to(sdtype)


def packed_propagate_plain(model, X: torch.Tensor,
                           noise: tuple) -> torch.Tensor:
    """The plain version of ``packed_propagate``: G @ X plus the noise."""
    mean = matvec(model.G_f32, X, out_dtype=X.dtype)
    return sample_packed_plain(model, mean, model.W_sqrt_f32, noise)


def packed_loglik_plain(model, y: torch.Tensor,
                        X: torch.Tensor) -> torch.Tensor:
    """The plain version of ``packed_loglik``, in the weight dtype (``F X``
    is taken in it whatever the state dtype)."""
    wdtype = model.V_chol.dtype
    resid = y[:, None].to(wdtype) - matvec(model.F_f32, X, out_dtype=wdtype)
    quad = quadform(model.V_chol_inv, resid)
    if model.noise == "mvt":
        k = model.obs_dim
        return model.log_norm - 0.5 * (model.df_value + k) * torch.log1p(
            quad / model.df)
    return model.log_norm - 0.5 * quad


def _rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Draws [r, n] (or [r, 1, n]) with a unit inner stride, and the
    stride of their rows."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


@functools.lru_cache(maxsize=None)
def _widths(d: int, k: int) -> Tuple[int, int, int]:
    """The propagate's width bucket and the likelihood's (DM, KM)."""
    return (step_widths(d, 1)[0],) + step_widths(d, k)


def _check_state(model, X: torch.Tensor, name: str) -> None:
    """Raises unless ``X`` is a float32 [d, N] state on the model's device
    with a unit inner stride, N < 2^31, of a model the kernels take."""
    d = model.state_dim
    if (X.dtype != torch.float32 or X.dim() != 2 or X.shape[0] != d
            or X.stride(1) != 1 or X.shape[1] >= 1 << 31
            or X.device != model.G_f32.device):
        raise ValueError(f"{name}: X must be a float32 [{d}, N] state on "
                         f"{model.G_f32.device} with a unit inner stride "
                         f"and N < 2^31, got {X.dtype} {tuple(X.shape)} "
                         f"on {X.device}")
    if (model.V_chol.dtype != torch.float32
            or max(d, model.obs_dim) > MAX_KERNEL_WIDTH):
        raise ValueError(f"{name}: float32 weights and d, k <= "
                         f"{MAX_KERNEL_WIDTH} only")


def packed_propagate(model, X: torch.Tensor, noise: tuple) -> torch.Tensor:
    """X_t | X_{t-1} for packed ``X`` [d, N] (float32, any row stride) on
    the draws ``noise`` of ``model.packed_noise``: ``G X + (W_sqrt z) s``
    -> a contiguous [d, N]. CUDA: the kernel; CPU: the plain version."""
    if not is_cuda(X, "packed_propagate"):
        return packed_propagate_plain(model, X, noise)
    _check_state(model, X, "packed_propagate")
    d, n = X.shape
    z, ldz = _rows(noise[0])
    if z.shape[0] != d or z.shape[1] != n or z.dtype != torch.float32:
        raise ValueError("packed_propagate: z must be float32 [d, N]")
    mvt = model.noise == "mvt"
    u = zc = None
    if mvt:
        if model.per_dim_chi:
            raise ValueError("packed_propagate: one chi-square a particle "
                             "only")
        if model.df_int is None:
            u = chi2_transform(model.df_value, None, noise[1])
        else:
            u, zc = noise[1]
    u, ldu = (None, 0) if u is None else _rows(u)
    zc = None if zc is None else _rows(zc)[0]
    G = model.G_f32.contiguous()
    Q = model.W_sqrt_f32.contiguous()
    lib = kernels.library()
    out = torch.empty((d, n), dtype=torch.float32, device=X.device)
    rc = lib.cusmc_packed_propagate(
        X.data_ptr(), X.stride(0), z.data_ptr(), ldz,
        None if u is None else u.data_ptr(), ldu,
        None if zc is None else zc.data_ptr(), G.data_ptr(), Q.data_ptr(),
        out.data_ptr(), n, d, int(mvt), (model.df_int or 0) if mvt else 0,
        model.df_value if mvt else 1.0, _widths(d, model.obs_dim)[0],
        kernels.stream_of(X))
    kernels.check(rc, "packed_propagate")
    packed_propagate.launches += 1
    return out


def packed_loglik(model, y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """log p(y | x) for packed ``X`` [d, N] (float32, any row stride) ->
    [N] float32, through the inverse Cholesky factor of V. CUDA: the
    kernel; CPU: the plain version."""
    if not is_cuda(X, "packed_loglik"):
        return packed_loglik_plain(model, y, X)
    _check_state(model, X, "packed_loglik")
    d, n = X.shape
    k = model.obs_dim
    y = y.to(device=X.device, dtype=torch.float32).contiguous()
    if y.shape != (k,):
        raise ValueError(f"packed_loglik: y must be [{k}]")
    mvt = model.noise == "mvt"
    _, dm, km = _widths(d, k)
    F = model.F_f32.contiguous()
    Li = model.V_chol_inv.contiguous()
    lib = kernels.library()
    ll = torch.empty((n,), dtype=torch.float32, device=X.device)
    rc = lib.cusmc_packed_loglik(
        X.data_ptr(), X.stride(0), y.data_ptr(), F.data_ptr(), Li.data_ptr(),
        model.log_norm.data_ptr(), ll.data_ptr(), n, d, k, int(mvt),
        model.df_value if mvt else 1.0, dm, km, kernels.stream_of(X))
    kernels.check(rc, "packed_loglik")
    packed_loglik.launches += 1
    return ll


packed_propagate.launches = 0
packed_loglik.launches = 0
