"""Convergence-driven sampling: extend chains block by block until the
rank-normalised R-hat and the multi-chain bulk ESS pass their thresholds.

Port of ``cusmc_tpu/mcmc/driver.py:35-142``. One warm-up block adapts
(step size, trajectory length, mass diagonal, per-rung scales and
ladder); the adapted values are then frozen and the chains extended in
blocks of ``block_steps`` sweeps, the diagnostics taken on all
post-warm-up draws after every block.

Each block's samples stay on the device and are concatenated there for
``rank_normalized_rhat`` and the bulk ESS; only the diagnostics ([d]
each) come back to the host a block, to decide whether to stop. (The JAX
function copies every block to numpy and uploads the growing stack again
each block.) ``samples``, ``rhat`` and ``ess`` are returned as numpy, as
the JAX function returns them.

Randomness: ``key`` is an int seed or a ``torch.Generator`` on
``init_x``'s device; the warm-up block and then each block draw from it
in turn. ``draws`` replays given numbers: a sequence of the samplers'
own ``draws=`` sequences, the warm-up block's first, then one a block
(the JAX key schedule: ``k_warm, key = split(key)``, then per block
``key, k_b = split(key)``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from cusmc_tpu_torch.device import KeyLike, make_generator
from cusmc_tpu_torch.diagnostics.mcmc import (
    _rank_normalize,
    effective_sample_size_chains,
    rank_normalized_rhat,
)
from cusmc_tpu_torch.mcmc.chees import chees_hmc_sampler
from cusmc_tpu_torch.mcmc.ensemble import stretch_move_sampler
from cusmc_tpu_torch.mcmc.metropolis import metropolis_hastings_sampler
from cusmc_tpu_torch.mcmc.tempering import parallel_tempering_sampler


class ConvergenceRun:
    """Host-side result: ``samples`` [T, C, d] post-warm-up draws,
    ``rhat`` / ``ess`` [d] final diagnostics (numpy), ``blocks`` used,
    ``converged`` bool."""

    def __init__(self, samples, rhat, ess, blocks, converged):
        self.samples = samples
        self.rhat = rhat
        self.ess = ess
        self.blocks = blocks
        self.converged = converged


def sample_to_convergence(
    key: KeyLike,
    log_prob: Callable,
    init_x: torch.Tensor,
    sampler: str = "chees",
    block_steps: int = 500,
    max_blocks: int = 20,
    rhat_tol: float = 1.01,
    min_ess: float = 400.0,
    step_size: float = 0.2,
    draws: Optional[Sequence] = None,
    **kwargs,
) -> ConvergenceRun:
    """Sample ``log_prob`` with [C, d] chains until converged: max(R-hat)
    <= ``rhat_tol`` and min(bulk ESS) >= ``min_ess``, or ``max_blocks``
    blocks. ``sampler``: "chees" (preconditioned ChEES-HMC), "mh"
    (random-walk Metropolis), "pt" (parallel tempering, for multimodal
    targets; with ``adapt_ladder=True`` the warm block adapts the ladder
    too) or "stretch" (the ensemble move, nothing to adapt). ``kwargs``
    pass through to the sampler."""
    if sampler not in ("chees", "mh", "pt", "stretch"):
        raise ValueError(f"unknown sampler {sampler!r}")
    warm_kw = dict(kwargs)
    # Continuation blocks re-inject the adapted values and force
    # num_adapt=0 and keep_samples=True: drop the caller's initials for
    # those same knobs.
    cont_kw = {k: v for k, v in kwargs.items()
               if k not in ("init_traj", "init_var", "init_log_step",
                            "num_adapt", "keep_samples")}
    warm_kw.pop("keep_samples", None)
    if sampler == "pt":
        cont_kw.pop("betas", None)
        cont_kw.pop("adapt_ladder", None)
    gen = None if draws is not None else make_generator(key, init_x.device)

    def block(i, x, res, warm):
        kw = dict(warm_kw if warm else cont_kw,
                  draws=None if draws is None else draws[i])
        if sampler == "stretch":
            return stretch_move_sampler(gen, log_prob, x, block_steps,
                                        keep_samples=not warm, **kw)
        if warm:
            fn = {"pt": parallel_tempering_sampler,
                  "chees": chees_hmc_sampler,
                  "mh": metropolis_hastings_sampler}[sampler]
            return fn(gen, log_prob, x, block_steps, step_size=step_size,
                      keep_samples=False, **kw)
        if sampler == "pt":
            return parallel_tempering_sampler(
                gen, log_prob, x, block_steps, betas=res.betas,
                init_log_step=torch.log(res.step_size), num_adapt=0,
                keep_samples=True, **kw)
        if sampler == "chees":
            return chees_hmc_sampler(
                gen, log_prob, x, block_steps, step_size=res.step_size,
                init_traj=res.traj_length, init_var=res.mass_var,
                num_adapt=0, keep_samples=True, **kw)
        return metropolis_hastings_sampler(
            gen, log_prob, x, block_steps, step_size=res.step_size,
            num_adapt=0, keep_samples=True, **kw)

    def position(res):
        return res.x if sampler == "stretch" else res.state.x

    res = block(0, init_x, None, True)
    x = position(res)  # PT continues every rung: [R, C, d]
    blocks = []
    rhat = ess = None
    for b in range(max_blocks):
        res = block(b + 1, x, res, False)
        x = position(res)
        blocks.append(res.samples)
        stack = torch.cat(blocks, dim=0)
        rhat = rank_normalized_rhat(stack).cpu().numpy()
        ess = effective_sample_size_chains(
            _rank_normalize(stack)).cpu().numpy()
        if rhat.max() <= rhat_tol and ess.min() >= min_ess:
            return ConvergenceRun(stack.cpu().numpy(), rhat, ess, b + 1,
                                  True)
    return ConvergenceRun(torch.cat(blocks, dim=0).cpu().numpy(), rhat, ess,
                          max_blocks, False)
