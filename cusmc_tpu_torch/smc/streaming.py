"""Chunked streaming particle filter: the card runs K steps at a time, and
each chunk's history goes to a host store between chunks.

Port of ``cusmc_tpu/smc/streaming.py`` (``streaming_bootstrap_filter``,
``:144-383``). A run's full [T, N, d] history can outgrow the card (N =
2^20 at d = 32 is 128 MiB a step), so the carry stays on the device from
chunk to chunk and only each chunk's [K, N, d] history crosses to the
host, once a chunk, into ``io.native_store.TrajectoryStore`` (a native
arena) or, with ``spill_path``, ``io.disk_store.DiskTrajectoryStore`` (a
file written by a background thread).

The steps are ``bootstrap_filter``'s own: both take their step, carry and
generators from ``particle_filter.filter_setup`` and run them with
``particle_filter.scan_steps``, so a chunked run draws the same numbers in
the same order and returns the one-shot run's final particles, ESS and
stored history bit for bit; its log-evidence is the float32 sum of the
same per-step increments, taken once at the end as the one-shot run
takes it. The choice of step is the JAX package's (``:209-249``): the
exp-space fast step for metropolis, residual and the CDF family in the
packed layout, the generic log-space step otherwise, and the batch
layout for a model without packed methods; there is no ``engine``.

A chunk boundary is also the checkpoint boundary
(``cusmc_tpu_torch.checkpoint``): every ``checkpoint_every`` steps the
carry is saved (particles in the public [N, d] layout, normalised log
weights, the generators' states, the evidence so far and its per-step
increments), and ``resume=True`` goes on from the latest snapshot's step
t + 1. The exp-space carry is saved as float64 log weights, from which a
restore gets the float32 carry back exactly, so a resumed run continues
the uninterrupted one bit for bit.

The halt guard (``halt_on_nonfinite``, ``:344-360``) reduces the carry's
weights and the chunk's evidence increments on the device to one flag
(NaN weights, all weights collapsed, a non-finite increment) and reads
that one scalar on the host a chunk, never the [N] weights. A raised flag
saves the last good carry (from before the chunk, with the generators'
states taken then) and raises ``utils.debug.FilterDivergedError`` with
its step and snapshot.

The sharded branch (``axis``, a ``parallel.mesh.ParticleAxis``; ``mesh``
in the JAX package) runs each chunk through the sharded filter's step and
the ops of ``parallel/resampling.py`` (``parallel.filter.
sharded_filter_args``) and needs the packed layout, as in the JAX package.
History blocks and snapshots hold the global [N, d] carry, gathered over
the group (every rank keeps the history; rank 0 writes the snapshot).
A snapshot holds the common stream's state and every rank's stream state
in rank order: a resume on the same group size restores them and
continues the run bit for bit. A resume on another group size (or a
single-device snapshot resumed sharded, and the other way round) is a
valid run that is not comparable bit for bit: its streams are seeded anew
from ``utils.rng.resume_seed(seed, t)`` as ``parallel.mesh.make_streams``
seeds them from a run's seed. With ``spill_path`` on a group of more than
one rank, rank 0 writes the gathered history and the other ranks, which
take part in the gathers, write nothing and return no store.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cusmc_tpu_torch.diagnostics.metrics import effective_sample_size
from cusmc_tpu_torch.io.native_store import TrajectoryStore
from cusmc_tpu_torch.models.base import supports_packed
from cusmc_tpu_torch.parallel.filter import sharded_filter_args
from cusmc_tpu_torch.parallel.mesh import axis_index, axis_size, pmax, psum, \
    rank_seed
from cusmc_tpu_torch.smc.particle_filter import (
    FilterResult,
    filter_setup,
    final_log_weights,
    scan_steps,
)
from cusmc_tpu_torch.utils.debug import FilterDivergedError
from cusmc_tpu_torch.utils.rng import generator_state, resume_seed, \
    set_generator_state
from cusmc_tpu_torch.utils.timing import host_scalar


def _host_fetch(x: torch.Tensor) -> np.ndarray:
    """A device tensor on the host as numpy: the one path for arrays of
    the run's size (history blocks, snapshots), which a store or a
    checkpoint asks for. The per-chunk halt guard, a 0-dim flag, is read
    through ``host_scalar`` instead."""
    return x.detach().cpu().numpy()


def _halt_flag(w: torch.Tensor, lzs: torch.Tensor, log_carry: bool,
               axis) -> torch.Tensor:
    """One flag, reduced on the device (and over the group): NaN weights
    anywhere, every weight collapsed (exp carry: all zero; log carry: all
    -inf), or a non-finite evidence increment."""
    alive = ~torch.isneginf(w) if log_carry else (w != 0)
    flags = torch.stack([torch.isnan(w).any(), alive.any()]).to(w.dtype)
    nan_any, alive_any = pmax(flags, axis).unbind()
    return (nan_any > 0) | (alive_any == 0) | ~torch.isfinite(lzs).all()


def _gather_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's [L, ...] rows -> the global [N, ...] rows."""
    return x if axis is None else axis.all_gather(x.contiguous())


def _local_states(streams) -> list:
    """This rank's generator states: one for a single-device run, else
    (common, rank)."""
    if streams.common is streams.rank:
        return [generator_state(streams.rank)]
    return [generator_state(streams.common), generator_state(streams.rank)]


def _global_states(local: list, axis, device) -> list:
    """A snapshot's states: the single generator's, or the common
    stream's and every rank's stream in rank order."""
    if len(local) == 1:
        return local
    common, rank = local
    ranks = _gather_rows(torch.from_numpy(rank).to(device)[None], axis)
    # A snapshot's array of states, not a 0-dim read: off ``host_scalar``.
    return [common] + list(ranks.cpu().numpy())


def _restore_streams(streams, states, seed: int, t: int, axis) -> None:
    """Set the run's generators from a snapshot's states where its
    streams match this run's (one generator, or the same group size),
    else seed them anew from ``resume_seed(seed, t)``."""
    states = list(states)
    p = axis_index(axis)
    if streams.common is streams.rank:
        if len(states) == 1:
            set_generator_state(streams.rank, states[0])
        else:
            streams.rank.manual_seed(resume_seed(seed, t))
    elif len(states) == 1 + axis_size(axis):
        set_generator_state(streams.common, states[0])
        set_generator_state(streams.rank, states[1 + p])
    else:
        s = resume_seed(seed, t)
        streams.common.manual_seed(s)
        streams.rank.manual_seed(rank_seed(s, p))


def streaming_bootstrap_filter(
    key,
    model,
    ys,
    num_particles: int,
    chunk_steps: int = 64,
    resampler: str = "metropolis",
    resampler_kwargs: Optional[dict] = None,
    ess_threshold: Optional[float] = None,
    store_particles: bool = True,
    force_numpy_store: bool = False,
    spill_path: Optional[str] = None,
    checkpoint=None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    layout: str = "packed",
    halt_on_nonfinite: bool = True,
    axis=None,
    device=None,
):
    """Run the filter over ``ys`` [T, k] in chunks of ``chunk_steps``.

    Returns ``(FilterResult, store)``: the result without history
    (``particles``, ``obs_loglik`` and ``ancestors`` None), and the store
    holding the streamed [T, N, d] float32 particle history (None with
    ``store_particles=False``). ``key``, ``model``, ``resampler``,
    ``resampler_kwargs``, ``ess_threshold`` and ``device`` are
    ``bootstrap_filter``'s; ``layout`` "packed" falls back to "batch" for
    a model without packed methods.

    ``checkpoint`` (a ``cusmc_tpu_torch.checkpoint.FilterCheckpoint``)
    saves the carry every ``checkpoint_every`` steps (default: every
    chunk); ``resume=True`` restores the latest snapshot and goes on from
    its step t + 1. History before the resume point is not replayed: row
    i of the store is timestep ``store.start_step + i`` (0 for a fresh
    run), and the returned ``ess`` likewise starts at the resume point.

    ``halt_on_nonfinite``: after each chunk, one device-reduced flag
    tells whether the carry or the chunk's evidence went non-finite; if
    so the last good carry is saved to ``checkpoint`` (when given) and
    ``FilterDivergedError`` is raised with the last good step and the
    snapshot's path. A later call with ``resume=True`` on clean
    observations returns what an uninterrupted run returns.

    ``axis``: a ``parallel.mesh.ParticleAxis`` shards the particles over
    the process group (every rank calls with the same arguments and an int
    seed); the packed layout is required. The result then holds this
    rank's block of the final particles and weights, as
    ``parallel.sharded_bootstrap_filter`` returns it; the store and the
    snapshots hold the global arrays.
    """
    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
    if layout == "packed" and not supports_packed(model):
        layout = "batch"
    if axis is not None:
        if layout != "packed":
            raise ValueError("sharded streaming requires the packed "
                             "layout (a model with packed methods)")
        setup = filter_setup(key, model, ess_threshold=ess_threshold,
                             device=device,
                             **sharded_filter_args(model, num_particles,
                                                   axis, resampler,
                                                   resampler_kwargs))
    else:
        setup = filter_setup(key, model, num_particles, resampler=resampler,
                             resampler_kwargs=resampler_kwargs,
                             ess_threshold=ess_threshold, layout=layout,
                             device=device)
    step, streams, dev = setup.step, setup.streams, setup.device
    packed, log_carry = setup.packed, setup.log_carry
    wdtype = setup.logw0.dtype
    n_local = setup.x0.shape[-1] if packed else setup.x0.shape[0]
    lo = axis_index(axis) * n_local
    seed = (key.initial_seed() if isinstance(key, torch.Generator)
            else int(key or 0))
    ys = torch.as_tensor(ys, dtype=wdtype).to(dev).contiguous()
    num_steps = ys.shape[0]

    def carry_ess(w):
        if log_carry:
            return effective_sample_size(w, axis)
        s1, s2 = psum(torch.stack([torch.sum(w), torch.sum(w * w)]),
                      axis).unbind()
        return s1 * s1 / s2

    def host_rows(x) -> np.ndarray:
        """The carry's state -> the public global [N, d] float32 rows."""
        return _host_fetch(_gather_rows(x.T if packed else x, axis).float())

    def host_logw(w) -> np.ndarray:
        """The carry's weights -> global normalised log weights: float64
        from the exp carry (a restore gets the carry back exactly), the
        carried log weights otherwise."""
        w_g = _host_fetch(_gather_rows(w, axis))
        if log_carry:
            return w_g
        w64 = w_g.astype(np.float64)
        with np.errstate(divide="ignore"):
            return np.log(w64) - np.log(w64.sum())

    def save(t_snap, x, w, states, lz_parts) -> str:
        incs = (torch.cat(lz_parts) if lz_parts
                else torch.zeros((0,), dtype=wdtype, device=dev))
        rows, logw = host_rows(x), host_logw(w)
        states = _global_states(states, axis, dev)
        if axis_index(axis) == 0:
            checkpoint.save(t_snap, rows, logw, states,
                            host_scalar(torch.sum(incs)),
                            increments=_host_fetch(incs))
        if axis is not None:
            axis.barrier()
        return checkpoint.snapshot_path(t_snap)

    x, w = setup.x0, setup.w0
    t = 1
    lz_parts = []
    if resume:
        if checkpoint is None:
            raise ValueError("resume=True requires a checkpoint")
        snap = checkpoint.restore()
        rows = snap["particles"][lo:lo + n_local]
        x = torch.as_tensor(np.ascontiguousarray(rows.T if packed else rows),
                            dtype=setup.x0.dtype, device=dev)
        logw = np.asarray(snap["log_weights"])
        if log_carry:
            w = torch.as_tensor(logw[lo:lo + n_local], dtype=wdtype,
                                device=dev)
        else:
            w64 = np.exp(logw.astype(np.float64) - logw.max())
            w = torch.as_tensor(w64[lo:lo + n_local], dtype=wdtype,
                                device=dev)
        _restore_streams(streams, snap["generator_state"], seed, snap["t"],
                         axis)
        incs = snap["increments"]
        if incs is None:
            incs = np.asarray([snap["log_evidence"]])
        lz_parts.append(torch.as_tensor(incs, dtype=wdtype, device=dev))
        t = snap["t"] + 1
        ess_parts = [carry_ess(w).reshape(1)]
    else:
        ess_parts = [effective_sample_size(setup.logw0, axis).reshape(1)]

    store = None
    if store_particles:
        d = setup.x0.shape[0] if packed else setup.x0.shape[-1]
        shape = (n_local * axis_size(axis), d)
        if spill_path is None:
            store = TrajectoryStore(shape, num_steps, np.float32,
                                    force_numpy=force_numpy_store)
        elif axis_index(axis) == 0:
            from cusmc_tpu_torch.io.disk_store import DiskTrajectoryStore

            store = DiskTrajectoryStore(spill_path, shape, np.float32)
        rows0 = host_rows(x)[None]  # gathered on every rank
        if store is not None:
            store.start_step = t - 1
            store.append(rows0)

    next_ckpt = None
    if checkpoint is not None:
        checkpoint_every = checkpoint_every or chunk_steps
        next_ckpt = t - 1 + checkpoint_every
    keep_states = halt_on_nonfinite and checkpoint is not None

    while t < num_steps:
        k = min(chunk_steps, num_steps - t)
        esss = torch.empty((k,), dtype=wdtype, device=dev)
        lzs = torch.empty((k,), dtype=wdtype, device=dev)
        xs = (torch.empty((k,) + tuple(x.shape), dtype=x.dtype, device=dev)
              if store_particles else None)
        prev_x, prev_w, prev_t = x, w, t
        prev_states = _local_states(streams) if keep_states else None
        x, w = scan_steps(step, x, w, ys[t:t + k], t, streams, esss, lzs,
                          xs)
        if halt_on_nonfinite and host_scalar(_halt_flag(w, lzs, log_carry,
                                                        axis)):
            snap = None
            if checkpoint is not None:
                snap = save(prev_t - 1, prev_x, prev_w, prev_states,
                            lz_parts)
            raise FilterDivergedError(
                f"non-finite filter state in steps [{prev_t}, {prev_t + k}); "
                f"last good step {prev_t - 1}"
                + (f", snapshot saved to {snap}" if snap else ""),
                last_good_step=prev_t - 1, snapshot=snap)
        if store_particles:
            rows = xs.transpose(1, 2) if packed else xs
            if axis is not None:
                rows = _gather_rows(rows.transpose(0, 1), axis).transpose(0, 1)
            if store is not None:
                store.append(_host_fetch(rows.float().contiguous()))
        ess_parts.append(esss)
        lz_parts.append(lzs)
        t += k
        if next_ckpt is not None and t - 1 >= next_ckpt:
            save(t - 1, x, w, _local_states(streams), lz_parts)
            next_ckpt = t - 1 + checkpoint_every

    log_evidence = (torch.sum(torch.cat(lz_parts)) if lz_parts
                    else torch.zeros((), dtype=wdtype, device=dev))
    result = FilterResult(
        final_particles=x.T if packed else x,
        final_log_weights=final_log_weights(w, log_carry, axis),
        ess=torch.cat(ess_parts), log_evidence=log_evidence)
    return result, store
