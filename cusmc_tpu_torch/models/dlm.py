"""Dynamic linear model (state-space model) specification.

Port of ``cusmc_tpu/models/dlm.py``: ``DLM.create`` (``:57-100``, with
the ``df_int`` dispatch at ``:80-87``), the packed [d, N] methods
(``:155-207``), the batch [N, d] methods of the model protocol
(``sample_initial``, ``propagate``, ``propagate_mean``,
``lookahead_logpdf``, ``observation_logpdf``, ``sample_observation``,
``:112-146, 211-217``) and ``simulate`` (``:219-239``)::

    x_0 ~ Dist(m0, C0)
    x_t = G x_{t-1} + w_t,  w_t ~ Dist(0, W)
    y_t = F x_t + v_t,      v_t ~ Dist(0, V)

with Dist in {MVN, MVT(df)}. ``DLM`` is an ``nn.Module`` whose factors are
buffers, so ``.to(device)`` moves the whole model. The MVT normaliser and
the half log-determinant of V are computed once, as buffers, instead of on
every step.

Randomness: every sampling method takes a ``torch.Generator``. The packed
methods also take ``noise=``, the draws of ``packed_noise``, so that tests
can hand them the numbers JAX drew (JAX's ``_sample_packed`` splits its key as
``kz, kg``: z from ``kz``, the chi-square draws from ``kg``). The batch
methods take ``noise=(z,)`` or ``(z, g)`` with ``g`` the chi-square
variates themselves, since the JAX batch sampler draws them with
``jax.random.gamma``, which the port does not reproduce.

Mixed precision (``create(state_dtype=torch.bfloat16)``, ``:58-99``): the
particle state and the transition factors (``F``, ``G``, ``m0``,
``C0_sqrt``, ``W_sqrt``) are bfloat16, factored in ``dtype`` and cast
once; the weight side (``V_chol``, ``V_chol_inv``, ``df``, the chi-square
draws, the log-densities) stays in ``dtype``. The state's normals take
``jax.random.normal``'s bfloat16 law (``ops/random.normal``), products
are taken in float32 and rounded once (``ops/packed.matvec``), and each
elementwise operation rounds to bfloat16, as XLA computes them.
``per_dim_chi=True`` draws one chi-square per state component
(``:192``); the fused engines refuse it.

The packed step's propagate and log-density are ``ops/packed_model``'s:
on the card, for a float32 state with d, k <= 16 (``runs_kernels``), two
hand-written kernels; elsewhere the composed expressions, its plain
versions.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from cusmc_tpu_torch.device import as_tensor, resolve_device
from cusmc_tpu_torch.distributions.mvn import mvn_logpdf, mvn_sample
from cusmc_tpu_torch.distributions.mvt import mvt_logpdf, mvt_sample
from cusmc_tpu_torch.ops.packed import matvec
from cusmc_tpu_torch.ops.packed_model import packed_loglik, \
    packed_loglik_plain, packed_propagate, packed_propagate_plain, \
    sample_packed_plain, takes_kernel
from cusmc_tpu_torch.ops.random import chi2_draws, integer_df, normal
from cusmc_tpu_torch.utils.linalg import chol_sqrt, cov_sqrt


class DLM(nn.Module):
    """DLM with precomputed covariance factors, held as buffers.

    ``noise`` selects the family for the prior, transition and
    observation noise alike; ``df`` is used only for "mvt". ``df_int``
    is the integer df when it is a small integer (the exact one-log
    chi-square path), else None. The transition factors hold the state
    dtype, ``V_chol`` and ``V_chol_inv`` the weight dtype.
    """

    def __init__(self, F, G, m0, C0_sqrt, W_sqrt, V_chol, V_chol_inv,
                 df=None, noise: str = "mvn", df_int: Optional[int] = None,
                 per_dim_chi: bool = False):
        super().__init__()
        if noise not in ("mvn", "mvt"):
            raise ValueError(f"unknown noise family {noise!r}")
        if noise == "mvt" and df is None:
            raise ValueError("mvt noise requires df")
        self.noise = noise
        self.df_int = df_int
        self.per_dim_chi = bool(per_dim_chi)
        self.df_value = None if df is None else float(df)
        for name, val in (("F", F), ("G", G), ("m0", m0),
                          ("C0_sqrt", C0_sqrt), ("W_sqrt", W_sqrt),
                          ("V_chol", V_chol), ("V_chol_inv", V_chol_inv)):
            self.register_buffer(name, val)
        # The factors of the composed step's products, widened to float32
        # once here rather than on every step (``ops/packed.matvec``
        # multiplies a bfloat16 operand in float32).
        for name in ("F", "G", "W_sqrt"):
            self.register_buffer(name + "_f32", getattr(self, name).float(),
                                 persistent=False)
        wdtype = V_chol.dtype
        self.register_buffer(
            "df", None if df is None else torch.tensor(float(df), dtype=wdtype,
                                                       device=V_chol.device))
        k = F.shape[-2]
        half_logdet = torch.sum(torch.log(torch.diagonal(V_chol)))
        if noise == "mvt":
            log_norm = (torch.lgamma(0.5 * (self.df + k))
                        - torch.lgamma(0.5 * self.df)
                        - 0.5 * k * (torch.log(self.df) + math.log(math.pi))
                        - half_logdet)
        else:
            log_norm = -0.5 * k * math.log(2.0 * math.pi) - half_logdet
        self.register_buffer("log_norm", log_norm)

    # -- construction ----------------------------------------------------

    @classmethod
    def create(cls, F, G, m0, C0, V, W, df=None, noise: str = "mvn",
               sqrt_method: str = "cholesky", dtype=torch.float32,
               per_dim_chi: bool = False, state_dtype=None,
               device=None) -> "DLM":
        """Factor the covariances in ``dtype`` and build the model on
        ``device`` (None: the card, raising without one; the CPU only when
        asked for, ``device="cpu"``). ``state_dtype`` (e.g.
        ``torch.bfloat16``) is the dtype of the state and the transition
        factors (None: ``dtype``).

        Each argument may be a tensor on any device, as the JAX function
        takes traced arrays (a PMMH ``model_builder`` builds the model
        from the chain's theta on every step): a tensor is never routed
        through numpy, and its factor is taken where it lives, on the card
        with ``torch.linalg.cholesky_ex`` (``utils/linalg.chol_sqrt``: no
        host read of the info flag, and a covariance that is not positive
        definite gives a NaN factor, as in JAX, so PMMH rejects it).
        Numpy arrays, lists and scalars are factored on the CPU, and a CPU
        tensor gives a model bitwise equal to the one built from the same
        numbers as numpy. A tensor ``df`` is read once to the host (the
        port's ``df`` is a Python float) and keeps ``df_int`` as
        ``integer_df`` gives it; the JAX function drops ``df_int`` for a
        traced df."""
        if noise == "mvt" and df is None:
            raise ValueError("mvt noise requires df")
        sdtype = dtype if state_dtype is None else state_dtype

        def t(a, to=dtype):  # a tensor stays where it lies
            return as_tensor(a, to, None if isinstance(a, torch.Tensor)
                             else "cpu")

        V_chol = chol_sqrt(t(V))
        eye_k = torch.eye(V_chol.shape[-1], dtype=dtype,
                          device=V_chol.device)
        V_chol_inv = torch.linalg.solve_triangular(V_chol, eye_k, upper=False)
        # A tensor df is read once, when the model is built: off a run's
        # path, so not through ``host_scalar``.
        df_f = None if noise != "mvt" else float(df)
        model = cls(F=t(F, sdtype), G=t(G, sdtype), m0=t(m0, sdtype),
                    C0_sqrt=cov_sqrt(t(C0), sqrt_method).to(sdtype),
                    W_sqrt=cov_sqrt(t(W), sqrt_method).to(sdtype),
                    V_chol=V_chol, V_chol_inv=V_chol_inv, df=df_f,
                    noise=noise,
                    df_int=integer_df(df_f) if noise == "mvt" else None,
                    per_dim_chi=per_dim_chi)
        return model.to(resolve_device(device))

    @classmethod
    def from_jax_arrays(cls, *, F, G, m0, C0_sqrt, W_sqrt, V_chol,
                        V_chol_inv, df=None, noise: str = "mvn",
                        df_int: Optional[int] = None,
                        per_dim_chi: bool = False, device=None) -> "DLM":
        """Carry a JAX ``DLM``'s parameters across WITHOUT re-factorising:
        each field is given as a numpy array (``np.asarray(jax_model.F)``
        and so on), so both packages compute with the same factors. A
        bfloat16 array (numpy dtype ``bfloat16``, which ``torch.from_numpy``
        refuses) crosses as its 16-bit words. ``device`` as in ``create``."""
        def t(a):
            a = np.array(a, copy=True)
            if a.dtype.name == "bfloat16":
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(a)

        df_f = None if df is None else float(np.asarray(df))
        model = cls(F=t(F), G=t(G), m0=t(m0), C0_sqrt=t(C0_sqrt),
                    W_sqrt=t(W_sqrt), V_chol=t(V_chol),
                    V_chol_inv=t(V_chol_inv), df=df_f, noise=noise,
                    df_int=df_int, per_dim_chi=per_dim_chi)
        return model.to(resolve_device(device))

    @property
    def state_dim(self) -> int:
        return self.G.shape[-1]

    @property
    def obs_dim(self) -> int:
        return self.F.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.G.device

    @property
    def state_dtype(self) -> torch.dtype:
        return self.G.dtype

    # -- batch layout (x as [..., d]) -------------------------------------

    def sample_initial(self, gen: Optional[torch.Generator], shape: tuple,
                       noise: Optional[tuple] = None) -> torch.Tensor:
        """x_0 draws, ``shape + (d,)``."""
        return self._sample(gen, self.m0, self.C0_sqrt, shape, noise)

    def propagate(self, gen: Optional[torch.Generator], x_prev: torch.Tensor,
                  noise: Optional[tuple] = None) -> torch.Tensor:
        """x_t | x_{t-1} for a batch [..., d]: G x plus Dist(0, W)."""
        return self._sample(gen, self.propagate_mean(x_prev), self.W_sqrt,
                            x_prev.shape[:-1], noise)

    def propagate_mean(self, x_prev: torch.Tensor) -> torch.Tensor:
        """E[x_t | x_{t-1}] = G x, the auxiliary filter's lookahead point."""
        return matvec(x_prev, self.G.T)

    def lookahead_logpdf(self, y: torch.Tensor,
                         x_prev: torch.Tensor) -> torch.Tensor:
        """The predictive log p(y_t | x_{t-1}) = N(y; F G x, F W F' + V):
        exact for MVN noise, a Gaussian lookahead for MVT."""
        FW = matvec(self.F, self.W_sqrt)
        pred_cov = matvec(matvec(FW, self.W_sqrt.T), self.F.T) \
            + self.V_chol @ self.V_chol.T
        chol = torch.linalg.cholesky_ex(pred_cov).L  # no host read
        return mvn_logpdf(y - matvec(self.propagate_mean(x_prev), self.F.T),
                          0.0, chol)

    def observation_logpdf(self, y: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
        """log p(y | x) = log Dist(y - F x; 0, V) for x [..., d], ``F x``
        taken in the weight dtype whatever the state dtype."""
        resid = y - matvec(x, self.F.T, out_dtype=self.V_chol.dtype)
        if self.noise == "mvt":
            return mvt_logpdf(resid, 0.0, self.V_chol, self.df_value)
        return mvn_logpdf(resid, 0.0, self.V_chol)

    def sample_observation(self, gen: Optional[torch.Generator],
                           x: torch.Tensor,
                           noise: Optional[tuple] = None) -> torch.Tensor:
        """y | x ~ Dist(F x, V) for x [..., d] -> [..., k]."""
        zero_k = torch.zeros(self.obs_dim, dtype=x.dtype, device=x.device)
        return matvec(x, self.F.T) + self._sample(gen, zero_k, self.V_chol,
                                                  x.shape[:-1], noise)

    def _sample(self, gen, mean, scale, shape, noise=None):
        if self.noise == "mvt":
            return mvt_sample(gen, mean, scale, self.df_value, shape,
                              self.per_dim_chi, noise)
        return mvn_sample(gen, mean, scale, shape,
                          None if noise is None else noise[0])

    # -- packed [d, N] layout: the filter's hot path ----------------------

    def packed_noise(self, gen: Optional[torch.Generator], n: int) -> tuple:
        """The draws of one packed sample of n particles: ``(z,)`` for
        MVN; ``(z, chi2_draws)`` for MVT, with ``chi2_draws`` the draws of
        ``chi2_integer_df`` (integer df) or ``fast_gamma`` (otherwise), of
        shape (1, n), or (d, n) with ``per_dim_chi``. z [d, n] is in the
        state dtype, the chi-square draws in the weight dtype."""
        d = self.state_dim
        dev = self.device
        z = normal(gen, (d, n), self.state_dtype, dev)
        if self.noise != "mvt":
            return (z,)
        shape = (d, n) if self.per_dim_chi else (1, n)
        return (z, chi2_draws(gen, self.df_value, self.df_int, shape,
                              self.V_chol.dtype, dev))

    def sample_initial_packed(self, gen: Optional[torch.Generator], n: int,
                              noise: Optional[tuple] = None) -> torch.Tensor:
        """x_0 draws in packed layout [d, n] (once a run: the composed
        expressions, ``ops/packed_model.sample_packed_plain``)."""
        if noise is None:
            noise = self.packed_noise(gen, n)
        return sample_packed_plain(self, self.m0[:, None], self.C0_sqrt,
                                   noise)

    def runs_kernels(self, X: torch.Tensor) -> bool:
        """Whether the packed step on state ``X`` runs the kernels of
        ``ops/packed_model`` (``takes_kernel``'s rule)."""
        return takes_kernel(X.device, X.dtype, self.V_chol.dtype,
                            self.state_dim, self.obs_dim, X.shape[-1],
                            X.stride(-1), self.per_dim_chi)

    def propagate_packed(self, gen: Optional[torch.Generator],
                         X_prev: torch.Tensor,
                         noise: Optional[tuple] = None) -> torch.Tensor:
        """X_t | X_{t-1} for packed X [d, n]: G @ X plus Dist(0, W)."""
        if noise is None:
            noise = self.packed_noise(gen, X_prev.shape[-1])
        if self.runs_kernels(X_prev):
            return packed_propagate(self, X_prev, noise)
        return packed_propagate_plain(self, X_prev, noise)

    def observation_logpdf_packed(self, y: torch.Tensor,
                                  X: torch.Tensor) -> torch.Tensor:
        """log p(y | x) for packed X [d, n] -> [n], through the inverse
        Cholesky factor of V, in the weight dtype (``F X`` is taken in it
        whatever the state dtype)."""
        if self.runs_kernels(X):
            return packed_loglik(self, y, X)
        return packed_loglik_plain(self, y, X)

    # -- data generation --------------------------------------------------

    def simulate(self, gen: Optional[torch.Generator], num_steps: int):
        """Draw a latent path and observations. Returns (xs [T, d],
        ys [T, k]); row 0 of ys is zero like the bundled trace."""
        x = self.sample_initial(gen, ())
        xs = [x]
        ys = [torch.zeros(self.obs_dim, dtype=self.V_chol.dtype,
                          device=x.device)]
        for _ in range(num_steps - 1):
            x = self.propagate(gen, x)
            y = self.sample_observation(gen, x)
            xs.append(x)
            ys.append(y)
        return torch.stack(xs), torch.stack(ys)
