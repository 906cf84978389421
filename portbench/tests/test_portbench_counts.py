"""The benchmark's frozen work counts, pinned to the bounds PERF.md's
table of kernels printed (N = 2^20), and the whole step's count, which
no engine may change."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import peaks, work  # noqa: E402

N20 = 1 << 20


def ms(seconds):
    return round(seconds * 1e3, 4)


def test_roll_walk_bound_at_the_headline():
    t = work.roll_bytes(N20, 2, 10) / peaks.HBM_BYTES_PER_S
    assert ms(t) == 0.0200


def test_cumsum_bound():
    assert ms(work.cumsum_bytes(N20) / peaks.HBM_BYTES_PER_S) == 0.0025


def test_search_and_apply_bound_at_d2():
    t = work.search_apply_bytes(N20, 2) / peaks.HBM_BYTES_PER_S
    assert ms(t) == 0.0088


@pytest.mark.parametrize("noise, df_int, want, bound_by", [
    ("mvn", None, 0.0363, "bytes"),   # the monthly DLM's width, MVN
    ("mvt", 5, 0.0363, "bytes"),      # 10 Philox calls: 0.0250 ms
])
def test_fused_step_bound_at_the_structural_width(noise, df_int, want,
                                                  bound_by):
    nbytes, flops, peak, ops = work.fused_bound("step", 13, 1, N20,
                                                noise=noise, df_int=df_int)
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    assert ms(work.least_seconds(nbytes, flops, peak, ops)) == want
    assert work.least_seconds(nbytes, flops, peak, ops) == t_bytes
    if noise == "mvt":
        assert ms(max(c / r for c, r in ops)) == 0.0250


def test_fused_step_bound_at_d2_is_bound_by_operations():
    nbytes, flops, peak, ops = work.fused_bound("step", 2, 2, N20)
    assert ms(nbytes / peaks.HBM_BYTES_PER_S) == 0.0088
    assert ms(work.least_seconds(nbytes, flops, peak, ops)) == 0.0125


@pytest.mark.parametrize("d, k, noise, df, resampler", [
    (2, 2, "mvt", 5.0, "metropolis"), (13, 1, "mvn", None, "metropolis"),
    (2, 2, "mvt", 5.0, "systematic"), (32, 32, "mvt", 5.0, "metropolis")])
def test_step_work_is_the_same_for_every_engine(d, k, noise, df, resampler):
    cell = dict(d=d, k=k, noise=noise, df=df, particles=1 << 22,
                resampler=resampler, num_sweeps=10)
    counts = {engine: work.step_work({**cell, "engine": engine})
              for engine in ("auto", "xla", "pallas")}
    assert len({repr(c) for c in counts.values()}) == 1
    least = work.least_seconds(*counts["xla"])
    assert least > 0


def test_step_work_counts_state_weights_and_observation_once():
    cell = dict(d=13, k=1, noise="mvn", df=None, particles=1 << 22,
                resampler="metropolis", num_sweeps=10)
    nbytes = work.step_work(cell)[0]
    assert nbytes == (2 * 4 * 13 + 4) * (1 << 22) + 4


def test_peaks_are_the_published_h100_sxm_rates():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert (peaks.FP32_FLOPS, peaks.TF32_FLOPS, peaks.BF16_FLOPS) == (
        67e12, 495e12, 989e12)
    assert peaks.INT32_MULS == pytest.approx(64 * 132 * peaks.BOOST_HZ)
