"""PyTorch port, checkpoint and resume (checkpoint.py, utils/rng.py),
mirroring tests/test_checkpoint.py: a snapshot's round trip (the
generator's state takes the place of JAX's key data and must give the
same stream), ``latest``, a resumed run continuing the uninterrupted run
exactly (not to the JAX test's 1e-6), and an empty directory raising;
the snapshot's layout beside the JAX package's.
"""

import _torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
import torch

from cusmc_tpu.checkpoint import FilterCheckpoint as JaxCheckpoint
from cusmc_tpu_torch.checkpoint import FilterCheckpoint
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.parallel.mesh import rank_seed
from cusmc_tpu_torch.smc.streaming import streaming_bootstrap_filter
from cusmc_tpu_torch.utils.debug import FilterDivergedError
from cusmc_tpu_torch.utils.rng import generator_state, resume_seed, \
    set_generator_state


@pytest.fixture(scope="module")
def setup():
    model = DLM.create(noise="mvn", device="cpu", **demo_model_params())
    return model, load_y_sim()[:81]


@pytest.mark.parametrize("use_orbax", [False, True])
def test_save_restore_roundtrip(tmp_path, use_orbax):
    ck = FilterCheckpoint(str(tmp_path / "ck"), use_orbax=use_orbax)
    x = np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32)
    logw = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    path = ck.save(17, x, logw, generator_state(gen), -123.5)
    assert path.endswith("step_17.npz")
    snap = ck.restore()
    assert snap["t"] == 17
    np.testing.assert_array_equal(snap["particles"], x)
    np.testing.assert_array_equal(snap["log_weights"], logw)
    assert snap["log_evidence"] == -123.5 and snap["increments"] is None
    # The restored state draws the same stream.
    other = torch.Generator().manual_seed(99)
    set_generator_state(other, snap["generator_state"][0])
    np.testing.assert_array_equal(torch.rand(4, generator=other),
                                  torch.rand(4, generator=gen))


def test_snapshot_keys_beside_jax(tmp_path):
    # The port writes the JAX package's numpy snapshot with the
    # generators' states in place of the key data.
    x = np.zeros((4, 2), np.float32)
    w = np.zeros(4, np.float32)
    JaxCheckpoint(str(tmp_path / "j"), use_orbax=False).save(
        3, x, w, jax.random.key(0), 0.0)
    FilterCheckpoint(str(tmp_path / "t")).save(
        3, x, w, generator_state(torch.Generator()), 0.0,
        increments=np.zeros(3, np.float32))
    with np.load(tmp_path / "j" / "step_3.npz") as j, \
            np.load(tmp_path / "t" / "step_3.npz") as t:
        assert set(j.files) - {"key_data"} == \
            set(t.files) - {"generator_state", "increments"}
        for k in ("t", "particles", "log_weights", "log_evidence"):
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape


def test_latest_picks_highest_step(tmp_path):
    ck = FilterCheckpoint(str(tmp_path / "ck"))
    x = np.zeros((4, 2), np.float32)
    w = np.zeros(4, np.float32)
    state = generator_state(torch.Generator())
    for t in (10, 40, 25):
        ck.save(t, x, w, state, 0.0)
    assert "step_40" in ck.latest()


def test_resume_continues_exact_trajectory(tmp_path, setup):
    model, ys = setup
    n = 256
    full, _ = streaming_bootstrap_filter(0, model, ys, n, chunk_steps=20,
                                         resampler="systematic")
    ck = FilterCheckpoint(str(tmp_path / "ck"))
    streaming_bootstrap_filter(0, model, ys, n, chunk_steps=20,
                               resampler="systematic", checkpoint=ck,
                               checkpoint_every=20)
    # Resume from step 60 (and from the last snapshot, step 80).
    for t in (60, 80):
        snap = ck.snapshot_path(t)
        ck_t = FilterCheckpoint(str(tmp_path / f"only{t}"))
        ck_t.save(**_resave(FilterCheckpoint(ck.path).restore(snap), t))
        resumed, _ = streaming_bootstrap_filter(
            0, model, ys, n, chunk_steps=20, resampler="systematic",
            checkpoint=ck_t, resume=True, store_particles=False)
        assert torch.equal(resumed.final_particles, full.final_particles)
        assert torch.equal(resumed.final_log_weights, full.final_log_weights)
        assert torch.equal(resumed.log_evidence, full.log_evidence)
        assert torch.equal(resumed.ess[1:], full.ess[t + 1:])


def _resave(snap, t):
    return dict(t=t, particles=snap["particles"],
                log_weights=snap["log_weights"],
                generator_state=snap["generator_state"],
                log_evidence=snap["log_evidence"],
                increments=snap["increments"])


def test_metropolis_resume_continues_exact_trajectory(tmp_path, setup):
    # The roll walk's exp-space carry round-trips through the float64 log
    # weights of the snapshot bit for bit.
    model, ys = setup
    full, _ = streaming_bootstrap_filter(2, model, ys, 256, chunk_steps=30,
                                         resampler="metropolis",
                                         store_particles=False)
    ck = FilterCheckpoint(str(tmp_path / "ck"))
    ys_bad = np.array(ys, np.float32)
    ys_bad[70] = np.nan
    with pytest.raises(FilterDivergedError):
        streaming_bootstrap_filter(2, model, ys_bad, 256, chunk_steps=30,
                                   resampler="metropolis", checkpoint=ck,
                                   store_particles=False)
    assert ck.restore()["t"] == 60
    resumed, _ = streaming_bootstrap_filter(
        2, model, ys, 256, chunk_steps=30, resampler="metropolis",
        checkpoint=ck, resume=True, store_particles=False)
    assert torch.equal(resumed.final_particles, full.final_particles)
    assert torch.equal(resumed.log_evidence, full.log_evidence)


def test_restore_empty_raises(tmp_path):
    ck = FilterCheckpoint(str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError):
        ck.restore()


def test_generator_states_of_another_kind_are_refused():
    gen = torch.Generator()
    with pytest.raises(ValueError, match="16-byte"):
        set_generator_state(gen, np.zeros(16, np.uint8))
    seeds = {resume_seed(5, t) for t in range(64)}
    assert len(seeds) == 64
    assert not seeds & {rank_seed(5, r) for r in range(64)}
