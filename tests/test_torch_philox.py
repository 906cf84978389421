"""PyTorch port, ``ops/philox.py``: the Philox4x32-10 bits of the fused
step kernels.

The known-answer vectors are those published with Random123 (Salmon et
al., SC'11; its ``kat_vectors`` file) for philox4x32 with 10 rounds. The
layout tests pin the counter layout that ``csrc/philox.cuh`` shares.
Imports no jax.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from cusmc_tpu_torch.ops.fused_step import to_normals, to_uniform
from cusmc_tpu_torch.ops.philox import MASK32, block_keys, philox4x32, \
    philox_bits

KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK32,) * 4, (MASK32,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _t(v):
    return torch.tensor(v, dtype=torch.int64)


@pytest.mark.parametrize("ctr,key,expected", KAT)
def test_philox_known_answers(ctr, key, expected):
    out = philox4x32(*map(_t, ctr), *map(_t, key))
    assert tuple(int(o) for o in out) == expected


def _bits(seed, blocks=4, stream=0, rows=9, lanes=256):
    return philox_bits(torch.tensor(seed, dtype=torch.int32),
                       torch.arange(blocks), stream, rows,
                       torch.arange(lanes))


def test_bits_are_deterministic_and_in_range():
    a = _bits([3, -7])
    assert a.shape == (9, 4, 256) and a.dtype == torch.int64
    assert torch.equal(a, _bits([3, -7]))
    assert int(a.min()) >= 0 and int(a.max()) <= MASK32
    # Only the rows asked for, and a longer request extends it.
    assert torch.equal(_bits([3, -7], rows=13)[:9], a)


def test_bits_differ_across_seeds_blocks_streams_rows_and_lanes():
    a = _bits([3, -7])
    for other in (_bits([4, -7]), _bits([3, -6]), _bits([3, -7], stream=1)):
        assert float((a == other).float().mean()) < 1e-3
    flat = a.reshape(-1)
    # All 9 * 4 * 256 words distinct (a collision has odds ~ 1e-4).
    assert torch.unique(flat).numel() == flat.numel()


def test_counter_layout():
    """Row r of (block b, lane l, stream s) is word r % 4 of Philox at
    counter (l, r // 4, s, 0), key (seed0, seed1 ^ (b * 0x9E3779B9))."""
    seed = torch.tensor([123456789, -987654321], dtype=torch.int32)
    blocks = torch.tensor([0, 5, 70000])
    out = philox_bits(seed, blocks, 1, 6, torch.tensor([0, 9]))
    k0, k1 = block_keys(seed, blocks)
    assert int(k0) == 123456789
    for bi, b in enumerate(blocks.tolist()):
        mix = (b * 0x9E3779B9) & MASK32
        assert int(k1[bi]) == ((-987654321) & MASK32) ^ mix
        for li, lane in enumerate((0, 9)):
            for r in range(6):
                words = philox4x32(_t(lane), _t(r // 4), _t(1), _t(0),
                                   k0, k1[bi])
                assert int(out[r, bi, li]) == int(words[r % 4])


def test_uniforms_and_normals_from_bits():
    bits = _bits([1, 2], blocks=8, rows=2, lanes=4096)
    u = to_uniform(bits[0])
    assert u.dtype == torch.float32
    assert float(u.min()) >= 1e-12 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    z = to_normals(bits[0], bits[1]).double().numpy().ravel()
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    # Kolmogorov-Smirnov distance to N(0, 1) on 32768 normals.
    from math import erf, sqrt
    zs = np.sort(z)
    cdf = np.array([0.5 * (1.0 + erf(v / sqrt(2.0))) for v in zs])
    emp = np.arange(1, zs.size + 1) / zs.size
    assert np.max(np.abs(emp - cdf)) < 0.012
    zero = torch.zeros(3, dtype=torch.int64)
    assert torch.all(to_uniform(zero) == np.float32(1e-12))
