"""The roll walk, the law of ``metropolis`` on engines "auto" and "xla":
B sweeps; sweep b proposes ancestor ``(i + s_b) mod N`` for particle i,
one uniform shift ``s_b`` a sweep, and the chain accepts when
``u * w_cur < w_cand``."""

from __future__ import annotations

import torch


def ancestors(gen, w, traffic):
    num_sweeps = traffic["num_sweeps"]
    n = w.shape[0]
    idx = torch.arange(n, device=w.device)
    shifts = torch.randint(0, n, (num_sweeps,), generator=gen,
                           device=w.device)
    anc = idx.clone()
    w_cur = w
    for b in range(num_sweeps):
        u = torch.rand((n,), generator=gen, dtype=w.dtype, device=w.device)
        j = torch.remainder(idx + shifts[b], n)
        cand = w[j]
        acc = u * w_cur < cand
        w_cur = torch.where(acc, cand, w_cur)
        anc = torch.where(acc, j, anc)
    return anc
