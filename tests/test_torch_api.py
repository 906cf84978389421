"""PyTorch port, the public API beside ``run``: mirrors tests/test_api.py's
``MVN``, ``MVNPDF``, ``MVT``, ``MVTPDF`` and ``metropolis_hastings`` cases
(on the CPU, ``device="cpu"``), and holds to the JAX package on the same
arrays: the densities, ``metropolis_hastings`` given JAX's draws, the CSV
files of ``write_sim_output`` (byte for byte), ``generate_y_sim``'s format,
and ``filter_diagnostics`` / ``unique_ancestor_fraction``, including a
sharded run's global slots past the block (JAX's scatter drops them).

Tolerances: the JAX tests' own for the closed-form values; densities at
rtol 1e-5 against the JAX functions; files, ancestors and fractions
exactly.
"""

import _torch_threads  # noqa: F401
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import metropolis_draws

import cusmc_tpu
import cusmc_tpu_torch
from cusmc_tpu.diagnostics import metrics as jmetrics
from cusmc_tpu.io import data as jdata
from cusmc_tpu_torch.diagnostics import filter_diagnostics, \
    unique_ancestor_fraction
from cusmc_tpu_torch.io import data
from cusmc_tpu_torch.resampling.metropolis import metropolis_from_draws
from cusmc_tpu_torch.smc.particle_filter import FilterResult

CPU = dict(device="cpu")


class TestDirectDistributionAPI:
    def test_mvnpdf_sanity_value(self):
        val = cusmc_tpu_torch.MVNPDF(np.zeros(2), np.zeros(2), np.eye(2),
                                     **CPU)
        assert np.isclose(float(val), 0.1591549, atol=1e-6)

    def test_mvn_draw(self):
        x = cusmc_tpu_torch.MVN(np.zeros(3), np.eye(3), key=1, **CPU)
        assert x.shape == (3,) and x.dtype == torch.float32
        xs = cusmc_tpu_torch.MVN(np.zeros(3), np.eye(3), key=1,
                                 shape=(100,), **CPU)
        assert xs.shape == (100, 3)
        gen = torch.Generator().manual_seed(1)
        assert torch.equal(cusmc_tpu_torch.MVN(np.zeros(3), np.eye(3),
                                               key=gen, **CPU), x)

    def test_mvt_draw_and_pdf(self):
        x = cusmc_tpu_torch.MVT(np.zeros(2), np.eye(2), nu=4.0, key=2, **CPU)
        assert x.shape == (2,)
        v = cusmc_tpu_torch.MVTPDF(np.zeros(2), np.zeros(2), np.eye(2),
                                   nu=4.0, **CPU)
        assert np.isclose(float(v), 2.0 / (4.0 * np.pi), rtol=1e-5)

    def test_metropolis_hastings(self):
        w = np.array([0.1, 0.7, 0.1, 0.1])
        a = cusmc_tpu_torch.metropolis_hastings(w, N=4, B=50, key=3, **CPU)
        assert a.shape == (4,) and a.dtype == torch.int32
        assert (a >= 0).all() and (a < 4).all()

    def test_metropolis_hastings_rejects_bad_n(self):
        with pytest.raises(ValueError):
            cusmc_tpu_torch.metropolis_hastings(np.ones(4), N=5, **CPU)

    def test_tensor_inputs_keep_their_device(self):
        x = cusmc_tpu_torch.MVN(torch.zeros(2), torch.eye(2), key=0)
        assert x.device.type == "cpu"
        assert cusmc_tpu_torch.MVNPDF(torch.zeros(2), np.zeros(2),
                                      np.eye(2)).device.type == "cpu"


def test_densities_and_metropolis_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 4))
    cov = (a @ a.T + 4 * np.eye(4)).astype(np.float32)
    mu = rng.standard_normal(4).astype(np.float32)
    xs = rng.standard_normal((32, 4)).astype(np.float32)
    for log in (False, True):
        np.testing.assert_allclose(
            cusmc_tpu_torch.MVNPDF(xs, mu, cov, log=log, **CPU).numpy(),
            np.asarray(cusmc_tpu.MVNPDF(xs, mu, cov, log=log)), rtol=1e-5)
        np.testing.assert_allclose(
            cusmc_tpu_torch.MVTPDF(xs, mu, cov, 5.0, log=log, **CPU).numpy(),
            np.asarray(cusmc_tpu.MVTPDF(xs, mu, cov, 5.0, log=log)),
            rtol=1e-5)
    # metropolis_hastings is metropolis_ancestors on log w: JAX's draws.
    n, b = 1024, 10
    w = rng.random(n).astype(np.float32)
    ref = cusmc_tpu.metropolis_hastings(w, B=b, key=jax.random.key(6))
    ours = metropolis_from_draws(torch.log(torch.from_numpy(w)),
                                 *metropolis_draws(jax.random.key(6), n, b))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_write_sim_output_files_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    T, n, d = 12, 16, 2
    prior_x = rng.standard_normal((T, d)).astype(np.float32)
    ys = rng.standard_normal((T, d)).astype(np.float32)
    weights = rng.random((T, n)).astype(np.float32)
    post = rng.standard_normal((T, n, d)).astype(np.float32)
    jdata.write_sim_output(str(tmp_path / "jax"), prior_x, ys, weights,
                           post, p=3)
    data.write_sim_output(str(tmp_path / "torch"), torch.from_numpy(prior_x),
                          torch.from_numpy(ys), torch.from_numpy(weights),
                          torch.from_numpy(post), p=3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["prior_x_t.csv", "x_t_N3.csv", "y_t.csv"]
    assert sorted(os.listdir(tmp_path / "torch")) == names
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "torch", names, shallow=False)
    assert match == names, (mismatch, errors)


def test_generate_y_sim_writes_the_bundled_format(tmp_path):
    path = tmp_path / "sub" / "y_sim.csv"
    ys = data.generate_y_sim(path, num_steps=51, seed=3, **CPU)
    assert ys.shape == (51, 2) and ys.dtype == np.float32
    lines = path.read_text().splitlines()
    bundled = data.Y_SIM_PATH.read_text().splitlines()
    assert lines[0] == bundled[0] == "y0,y1" and len(lines) == 52
    assert lines[1] == bundled[1]  # the zero first row
    np.testing.assert_allclose(data.load_csv(path), ys, rtol=1e-5,
                               atol=1e-6)
    # Philox draws, not threefry: the law, not the values. The demo model
    # observes the state with V = 0.001 I, and the state moves slowly.
    steps = np.diff(ys[1:], axis=0)
    assert 0.01 < float(np.std(steps)) < 0.2
    with pytest.raises(FileNotFoundError):
        data.load_y_sim(tmp_path / "missing.csv")


def test_unique_ancestor_fraction_matches_jax():
    rng = np.random.default_rng(2)
    n = 64
    cases = [rng.integers(0, n, n), np.zeros(n, np.int64), np.arange(n),
             # A sharded run's global slots: the block's n plus slots past
             # it, which JAX's scatter drops.
             rng.integers(0, 4 * n, n)]
    for a in cases:
        a = a.astype(np.int32)
        ref = float(jmetrics.unique_ancestor_fraction(jnp.asarray(a)))
        ours = unique_ancestor_fraction(torch.from_numpy(a))
        assert ours.dtype == torch.float32 and ours.shape == ()
        assert float(ours) == ref


def test_filter_diagnostics_match_jax():
    rng = np.random.default_rng(3)
    T, n = 9, 128
    anc = rng.integers(0, 2 * n, (T, n)).astype(np.int32)
    logw = rng.standard_normal(n).astype(np.float32)
    logw -= np.log(np.exp(logw.astype(np.float64)).sum()).astype(np.float32)
    ess = rng.random(T).astype(np.float32)
    fields = dict(final_particles=np.zeros((n, 2), np.float32),
                  final_log_weights=logw, ess=ess,
                  log_evidence=np.float32(-3.5))
    ref = jmetrics.filter_diagnostics(cusmc_tpu.FilterResult(
        ancestors=jnp.asarray(anc),
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    ours = filter_diagnostics(FilterResult(
        ancestors=torch.from_numpy(anc),
        **{k: torch.as_tensor(v) for k, v in fields.items()}))
    assert sorted(ours) == sorted(ref)
    np.testing.assert_array_equal(ours["unique_ancestor_fraction"].numpy(),
                                  np.asarray(ref["unique_ancestor_fraction"]))
    np.testing.assert_allclose(float(ours["final_ess"]),
                               float(ref["final_ess"]), rtol=1e-5)
    lean = filter_diagnostics(FilterResult(
        **{k: torch.as_tensor(v) for k, v in fields.items()}))
    assert "unique_ancestor_fraction" not in lean
