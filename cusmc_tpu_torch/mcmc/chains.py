"""The sweep loop that the port's MCMC samplers share.

The JAX samplers run their sweeps as one ``lax.scan`` and choose the
adaptation rate of sweep t with ``jnp.where(t < num_adapt, adapt_rate,
0)`` on the traced t. Here the loop is a Python loop and t a host int, so
that choice is a Python branch; nothing is read back from the device in
the loop. Kept positions go into one tensor allocated before it
(``samples[::thin]`` of the JAX sampler, without the other sweeps).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from cusmc_tpu_torch.parallel.mesh import pmean


def pooled_mean(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    """The mean of ``x`` over its chains, and over the ranks of
    ``axis_name`` (a ``parallel.mesh.ParticleAxis``-like group) when the
    chains are sharded: the JAX samplers' ``_pmean``."""
    return pmean(torch.mean(x), axis_name)


def log_step_size(step_size: float, like: torch.Tensor) -> torch.Tensor:
    """log(step_size) as a 0-dim tensor of ``like``'s type and device."""
    return torch.log(torch.tensor(float(step_size), dtype=torch.float64)).to(
        dtype=like.dtype, device=like.device)


def accept_uniforms(gen, c: int, like: torch.Tensor) -> torch.Tensor:
    """U[0, 1) accept draws [C] of ``like``'s type, as
    ``jax.random.uniform`` draws them."""
    return torch.rand((c,), generator=gen, dtype=like.dtype,
                      device=like.device)


def run_sweeps(sweep: Callable, state, num_steps: int, num_adapt: int,
               adapt_rate: float, keep_samples: bool, thin: int,
               draws: Optional[Sequence] = None):
    """``num_steps`` sweeps ``state = sweep(state, t, adapt, draws_t)[0]``,
    with ``adapt`` = ``adapt_rate`` for the first ``num_adapt`` and 0
    after, and ``draws_t`` = ``draws[t]`` (None: the sweep draws). Returns
    ``(state, samples)``, samples [ceil(T / thin), C, d] or None."""
    if thin < 1:
        raise ValueError(f"thin={thin} must be >= 1")
    if draws is not None and len(draws) < num_steps:
        raise ValueError(f"draws for {len(draws)} sweeps, {num_steps} run")
    x = state.x
    kept = None
    if keep_samples:
        kept = torch.empty((len(range(0, num_steps, thin)),) + tuple(x.shape),
                           dtype=x.dtype, device=x.device)
    for t in range(num_steps):
        adapt = adapt_rate if t < num_adapt else 0.0
        state, _ = sweep(state, t, adapt,
                         None if draws is None else draws[t])
        if kept is not None and t % thin == 0:
            kept[t // thin] = state.x
    return state, kept
