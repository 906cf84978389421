"""PyTorch port, the statistical oracle of the fused steps' "tile" design
(d = k in {16, 32}, and d = k = 64 in its padded widths; chip_smoke.py
phase 3c) on the CPU.

The fused kernels' plain versions draw the kernels' own Philox bits in
the kernels' own layout (``ops/philox.py``), and the kernels are held to
them on the card. So a layout that correlated draws across rows,
particles, tiles or calls would pass that comparison and be wrong in
both; these checks hold the plain versions' draws to their law, with
chip_smoke.py's functions at a small size (m = 2^14 particles):

1. a dense G with Q = 0: the new state is G x of the step's own ancestors
   within ZERO_NOISE_RTOL (1e-5) of |G| |x| entrywise;
2. X = 0, G = 0 and a dense lower-triangular Q: the noise's mean and
   second moment within 5 standard errors of 0 and c Q Q' (MVN; MVT with
   df = 8 on the Metropolis step, df = 5 with df_int = 5 on the CDF step);
3. the whitened noise of particle i against i+1, i+32 and i+tile, and
   against a second call, uncorrelated within 5 standard errors; a
   bit source that repeats words in each of those ways is caught;
4. the log-evidence of the conditioned model (V = 0.1 I, W = C0 = 0.001 I)
   at d = 16, N = 4096, T = 30, R = 4 seeds a path, systematic and
   metropolis through both engines, within LOGZ_BAND of Kalman and the
   fused systematic path within its spread of the composed one.

The card runs the same checks on the kernels (tests/test_torch_cuda.py,
and phase 3c at m = N = 2^20).
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import chip_smoke as cs
from cusmc_tpu_torch.ops import fused_cdf_step as fc
from cusmc_tpu_torch.ops import fused_step as fs
from cusmc_tpu_torch.ops import philox

M = 1 << 14
KINDS = ("metropolis", "cdf")
# Check 4's band (below, above, floor) in nats at N = 4096, T = 30, R = 4,
# from 40 seeds a path (0-39; the test takes 100-103) on the CPU: the
# largest bias of the four paths (0.79) + 4 sd / sqrt(R), 4 sd / sqrt(R)
# and 1 sd, with the largest sd (1.42, composed systematic).
LOGZ_BAND = (3.5, 2.9, 1.5)


def _tile(kind, d, m=M):
    return fs.auto_tile(m, d) if kind == "metropolis" else \
        fc.cdf_auto_tile(m, d)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_dense_g_without_noise_gives_g_x_of_the_ancestors(kind, d):
    assert fs.step_path(d, d) == "tile"
    gen = torch.Generator().manual_seed(d)
    err = cs.oracle_zero_noise(kind, d, M, gen, "cpu")
    assert err <= cs.ZERO_NOISE_RTOL


@pytest.mark.parametrize("noise", ["mvn", "mvt"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_noise_law_and_independence(kind, d, noise):
    gen = torch.Generator().manual_seed(10 * d + len(noise))
    res = cs.oracle_noise(kind, d, M, gen, "cpu", noise)
    names = [name for name, _ in res]
    assert f"particle i vs i+{_tile(kind, d)}, rows" in names
    assert [(name, v) for name, v in res if v >= cs.ORACLE_SE] == []


def _faulty_bits(fault):
    """The port's Philox with one fault in its layout: particle pairs
    sharing their words ("pairs"), every warp's 32 particles the same
    words ("warps"), every tile the first tile's ("tiles"), odd rows a
    copy of the even row before them ("rows"), or the seed ignored
    ("calls")."""
    real = philox.philox_bits

    def bits(seed, blocks, stream, rows, lanes):
        if fault == "pairs":
            lanes = lanes - lanes % 2
        elif fault == "warps":
            lanes = lanes % 32
        elif fault == "tiles":
            blocks = torch.zeros_like(blocks)
        elif fault == "calls":
            seed = torch.zeros_like(seed)
        out = real(seed, blocks, stream, rows, lanes)
        if fault == "rows":
            k = out.shape[0] // 2
            out = out.clone()
            out[1:2 * k:2] = out[0:2 * k:2]
        return out

    return bits


@pytest.mark.parametrize("fault", ["pairs", "warps", "tiles", "rows",
                                   "calls"])
@pytest.mark.parametrize("kind", KINDS)
def test_the_oracle_catches_a_repeating_layout(monkeypatch, kind, fault):
    d = 16
    bits = _faulty_bits(fault)
    monkeypatch.setattr(fs, "philox_bits", bits)
    monkeypatch.setattr(fc, "philox_bits", bits)
    gen = torch.Generator().manual_seed(3)
    res = cs.oracle_noise(kind, d, M, gen, "cpu", "mvn")
    failed = [name for name, v in res if v >= cs.ORACLE_SE]
    caught_by = {"pairs": "particle i vs i+1, rows",
                 "warps": "particle i vs i+32, rows",
                 "tiles": f"particle i vs i+{_tile(kind, d)}, rows",
                 "rows": "second moment vs c QQ'",
                 "calls": "second call, rows"}[fault]
    assert caught_by in failed, failed


def test_the_demo_model_as_it_is_collapses_at_d32():
    # Why check 4 conditions the model: with V = W = 0.001 I and C0 = I the
    # bootstrap filter keeps one particle at some step, and its logZ sits
    # more than 10^4 nats below Kalman, so it can check nothing.
    from cusmc_tpu_torch.io.data import demo_model_params
    from cusmc_tpu_torch.models.dlm import DLM
    from cusmc_tpu_torch.smc.kalman import kalman_filter
    from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter

    p = demo_model_params(32)
    model = DLM.create(device="cpu", noise="mvn", **p)
    _, ys = model.simulate(torch.Generator().manual_seed(cs.ORACLE_OBS_SEED),
                           30)
    _, _, zk = kalman_filter(ys, **{k: p[k] for k in
                                    ("F", "G", "V", "W", "m0", "C0")})
    res = bootstrap_filter(0, model, ys, 4096, resampler="systematic",
                           return_history=False)
    assert zk - float(res.log_evidence) > 1e4 and np.isfinite(zk)
    assert float(res.ess.min()) < 2.0


def test_log_evidence_of_both_engines_at_d16():
    z, zk = cs.oracle_logz(16, 4096, (100, 101, 102, 103), "cpu", steps=30)
    assert sorted(z) == [("metropolis", "pallas"), ("metropolis", "xla"),
                         ("systematic", "pallas"), ("systematic", "xla")]
    for name, detail, ok in cs.logz_checks(z, zk, LOGZ_BAND):
        assert ok, f"{name}: {detail}"
    assert np.isfinite(zk)
