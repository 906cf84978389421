"""The windowed walk, the law of ``metropolis`` on engine "pallas" (the
fused step), with tiles of ``tile`` particles: tile i's window is the
two source tiles from ``(i + s) mod nb``; a particle starts at window
position ``lane + r`` (``r`` in [0, 128) a tile, wrapped in the window)
and sweep b moves by ``128 * U{0 .. tile / 128}`` (one offset a tile and
sweep)."""

from __future__ import annotations

import torch

LANE_BLOCK = 128  # the windowed walk's unit of offsets


def ancestors(gen, w, traffic):
    num_sweeps, tile = traffic["num_sweeps"], traffic["tile"]
    n = w.shape[0]
    dev = w.device
    nb = n // tile
    wlen = 2 * tile
    tiles = torch.arange(nb, device=dev)[:, None]
    lanes = torch.arange(tile, device=dev)[None, :]
    s = torch.randint(0, nb, (), generator=gen, device=dev)
    r = torch.randint(0, LANE_BLOCK, (nb, 1), generator=gen, device=dev)
    n_off = tile // LANE_BLOCK + 1
    offs = LANE_BLOCK * torch.randint(0, n_off, (nb, num_sweeps),
                                      generator=gen, device=dev)
    start = torch.remainder(tiles + s, nb) * tile

    def source(q):
        q = torch.where(q >= wlen, q - wlen, q)
        return torch.remainder(start + q, n)

    base = lanes + r
    w_cur = w[source(base)]
    a_off = torch.zeros_like(base)
    for b in range(num_sweeps):
        off = offs[:, b:b + 1]
        u = torch.rand((nb, tile), generator=gen, dtype=w.dtype, device=dev)
        cand = w[source(base + off)]
        acc = u * w_cur < cand
        w_cur = torch.where(acc, cand, w_cur)
        a_off = torch.where(acc, off, a_off)
    return source(base + a_off).reshape(n)
