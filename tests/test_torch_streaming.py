"""PyTorch port, the streaming filter (smc/streaming.py), mirroring
tests/test_streaming.py and the streaming case of tests/test_disk_store.py.

Streaming runs the one-shot filter's own steps (``filter_setup``,
``scan_steps``), so it is held to ``bootstrap_filter`` exactly, not to the
JAX tests' 1e-6: final particles and log weights, log-evidence, ESS and
the stored history, for the fast step (systematic, metropolis, residual,
stratified, an ESS threshold) and the generic step (a ``CustomSSM``). The
snapshot-and-halt schedule (the last good step, the snapshot's name,
``store.start_step`` and the ESS length of a resumed run) is checked
against the JAX package's streaming filter on the same inputs; a resumed
run equals the uninterrupted one exactly. The sharded branch runs in one
gloo group of two ranks (tests/_torch_parallel_worker.py), held exactly
to the sharded one-shot filter.
"""

import os

import _torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
import torch

from _torch_parallel_worker import finish_group, start_group

from cusmc_tpu.checkpoint import FilterCheckpoint as JaxCheckpoint
from cusmc_tpu.io.data import demo_model_params as jax_demo_params
from cusmc_tpu.models.dlm import DLM as JaxDLM
from cusmc_tpu.smc.streaming import streaming_bootstrap_filter as jax_stream
from cusmc_tpu.utils.debug import FilterDivergedError as JaxDiverged
from cusmc_tpu_torch.checkpoint import FilterCheckpoint
from cusmc_tpu_torch.io.data import demo_model_params, load_y_sim
from cusmc_tpu_torch.io.disk_store import DiskTrajectoryStore
from cusmc_tpu_torch.models.base import CustomSSM
from cusmc_tpu_torch.models.dlm import DLM
from cusmc_tpu_torch.smc import streaming
from cusmc_tpu_torch.smc.particle_filter import bootstrap_filter
from cusmc_tpu_torch.smc.streaming import streaming_bootstrap_filter
from cusmc_tpu_torch.utils.debug import FilterDivergedError

N, T, CHUNK = 512, 101, 17


@pytest.fixture(scope="module")
def model():
    return DLM.create(noise="mvn", device="cpu", **demo_model_params())


def _custom(dlm):
    return CustomSSM.create(
        dlm.state_dim,
        lambda m, gen, shape: m["dlm"].sample_initial(gen, shape),
        lambda m, gen, x: m["dlm"].propagate(gen, x),
        lambda m, y, x: m["dlm"].observation_logpdf(y, x),
        params={"dlm": dlm})


def _assert_same(streamed, oneshot):
    assert torch.equal(streamed.final_particles, oneshot.final_particles)
    assert torch.equal(streamed.final_log_weights,
                       oneshot.final_log_weights)
    assert torch.equal(streamed.log_evidence, oneshot.log_evidence)
    assert torch.equal(streamed.ess, oneshot.ess)
    assert streamed.particles is None and streamed.ancestors is None


@pytest.mark.parametrize("case", ["systematic", "metropolis", "residual",
                                  "stratified", "systematic-adaptive",
                                  "custom"])
def test_streaming_matches_oneshot(model, case):
    ys = load_y_sim()[:T]
    resampler = case.partition("-")[0]
    kw = dict(resampler="systematic" if case == "custom" else resampler,
              ess_threshold=0.5 if case.endswith("adaptive") else None)
    m = _custom(model) if case == "custom" else model
    oneshot = bootstrap_filter(3, m, ys, N, device="cpu", **kw)
    streamed, store = streaming_bootstrap_filter(3, m, ys, N,
                                                 chunk_steps=CHUNK,
                                                 device="cpu", **kw)
    _assert_same(streamed, oneshot)
    assert store.size == T and store.start_step == 0
    np.testing.assert_array_equal(store.view(), oneshot.particles.numpy())


def test_streaming_no_store(model):
    ys = load_y_sim()[:41]
    result, store = streaming_bootstrap_filter(0, model, ys, 128,
                                               chunk_steps=10,
                                               store_particles=False)
    assert store is None
    assert result.final_particles.shape == (128, 2)
    oneshot = bootstrap_filter(0, model, ys, 128, return_history=False)
    _assert_same(result, oneshot)


def test_streaming_spills_to_disk(model, tmp_path):
    rng = np.random.default_rng(3)
    ys = rng.standard_normal((33, 2)).astype(np.float32)
    ys[0] = 0
    path = str(tmp_path / "spill.bin")
    res, store = streaming_bootstrap_filter(0, model, ys, 256,
                                            chunk_steps=8, spill_path=path)
    hist = store.view()
    assert hist.shape == (33, 256, 2)
    assert np.isfinite(np.asarray(hist)).all()
    res2, store2 = streaming_bootstrap_filter(0, model, ys, 256,
                                              chunk_steps=8)
    np.testing.assert_array_equal(np.asarray(hist), store2.view())
    np.testing.assert_array_equal(DiskTrajectoryStore.open(path),
                                  store2.view())
    _assert_same(res, res2)


def _jax_model():
    import jax.numpy as jnp

    return JaxDLM.create(noise="mvn", dtype=jnp.float32, **jax_demo_params())


def test_snapshot_and_halt_then_resume(model, tmp_path):
    # A NaN observation in chunk [41, 61) halts the run with the carry of
    # step 40 saved; resuming on clean observations returns what the
    # uninterrupted run returns, exactly. The schedule is the JAX
    # package's on the same inputs.
    ys_clean = load_y_sim()[:81]
    n = 256
    ys_bad = np.array(ys_clean, np.float32)
    ys_bad[50, 0] = np.nan

    ckpt = FilterCheckpoint(str(tmp_path / "snap"))
    with pytest.raises(FilterDivergedError) as ei:
        streaming_bootstrap_filter(1, model, ys_bad, n, chunk_steps=20,
                                   resampler="systematic", checkpoint=ckpt)
    err = ei.value
    assert err.last_good_step == 40
    assert err.snapshot is not None and "step_40" in err.snapshot
    # The JAX package's schedule on the same inputs: the same halt, and
    # the same snapshots (every chunk, then the halt's).
    jckpt = JaxCheckpoint(str(tmp_path / "jax_snap"), use_orbax=False)
    jm, key = _jax_model(), jax.random.key(1)
    with pytest.raises(JaxDiverged) as ej:
        jax_stream(key, jm, ys_bad, n, chunk_steps=20,
                   resampler="systematic", checkpoint=jckpt)
    assert ej.value.last_good_step == err.last_good_step
    assert os.path.basename(ej.value.snapshot) == \
        os.path.basename(err.snapshot)
    assert sorted(os.listdir(tmp_path / "snap")) == \
        sorted(os.listdir(tmp_path / "jax_snap")) == \
        ["step_20.npz", "step_40.npz"]

    resumed, store = streaming_bootstrap_filter(
        1, model, ys_clean, n, chunk_steps=20, resampler="systematic",
        checkpoint=ckpt, resume=True)
    full, full_store = streaming_bootstrap_filter(
        1, model, ys_clean, n, chunk_steps=20, resampler="systematic")
    assert torch.equal(resumed.final_particles, full.final_particles)
    assert torch.equal(resumed.final_log_weights, full.final_log_weights)
    assert torch.equal(resumed.log_evidence, full.log_evidence)
    # The resumed ESS starts at the resume point: the ESS of step 40's
    # carry, which the uninterrupted run reports entering step 41.
    assert torch.equal(resumed.ess,
                       torch.cat([full.ess[41:42], full.ess[41:]]))
    assert store.start_step == 40
    np.testing.assert_array_equal(store.view(), full_store.view()[40:])

    jres, jstore = jax_stream(key, jm, ys_clean, n, chunk_steps=20,
                              resampler="systematic", checkpoint=jckpt,
                              resume=True)
    assert jstore.start_step == store.start_step
    assert jstore.size == store.size
    assert np.asarray(jres.ess).shape == tuple(resumed.ess.shape)


def test_checkpoint_schedule_matches_jax(model, tmp_path):
    ys = load_y_sim()[:81]
    ckpt = FilterCheckpoint(str(tmp_path / "ck"))
    streaming_bootstrap_filter(0, model, ys, 128, chunk_steps=16,
                               resampler="systematic", checkpoint=ckpt,
                               checkpoint_every=30, store_particles=False)
    jckpt = JaxCheckpoint(str(tmp_path / "jck"), use_orbax=False)
    jax_stream(jax.random.key(0), _jax_model(), ys, 128, chunk_steps=16,
               resampler="systematic", checkpoint=jckpt,
               checkpoint_every=30, store_particles=False)
    assert sorted(os.listdir(tmp_path / "ck")) == \
        sorted(os.listdir(tmp_path / "jck"))


def test_halt_guard_reads_one_flag_a_chunk(model, monkeypatch):
    # The guard reads one device-reduced flag a chunk; with no store and
    # no checkpoint nothing of the run's size crosses to the host.
    ys = load_y_sim()[:41]
    reads, shapes = [], []
    fetch, flag = streaming._host_fetch, streaming.host_scalar
    monkeypatch.setattr(streaming, "_host_fetch",
                        lambda x: shapes.append(tuple(x.shape)) or fetch(x))
    monkeypatch.setattr(streaming, "host_scalar",
                        lambda x: reads.append(tuple(x.shape)) or flag(x))
    res, store = streaming_bootstrap_filter(0, model, ys, 256, chunk_steps=8,
                                            resampler="systematic",
                                            store_particles=False)
    assert store is None and bool(torch.isfinite(res.log_evidence))
    assert reads == [()] * 5  # 40 steps in chunks of 8
    assert shapes == []


def test_sharded_streaming_requires_packed_layout(model):
    import types

    axis = types.SimpleNamespace(index=0, size=1)
    with pytest.raises(ValueError, match="packed"):
        streaming_bootstrap_filter(0, _custom(model), load_y_sim()[:5], 64,
                                   axis=axis, device="cpu")


# -- the sharded branch, two gloo ranks --------------------------------

P, NS, TS = 2, 512, 61


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream_group")
    snap = str(tmp / "snap")
    base = dict(N=NS, T=TS, seed=5, chunk=13)
    halt = dict(base, T=81, chunk=20)
    cases = []
    for r in ("systematic", "metropolis"):
        cases.append(dict(id=f"oneshot-{r}", kind="filter", resampler=r,
                          history=True, **{k: base[k] for k in
                                           ("N", "T", "seed")}))
        cases.append(dict(id=f"stream-{r}", kind="stream", resampler=r,
                          store=True, **base))
    cases += [
        dict(id="halt", kind="stream", mode="halt", nan_at=50,
             resampler="systematic", checkpoint=snap, **halt),
        # Every rank resumes the snapshot alone (it saves nothing more).
        dict(id="single-resumed", kind="stream", resampler="systematic",
             checkpoint=snap, resume=True, sharded=False, every=1000,
             **halt),
        dict(id="resumed", kind="stream", resampler="systematic",
             checkpoint=snap, resume=True, store=True, **halt),
        dict(id="full", kind="stream", resampler="systematic", **halt),
        dict(id="spy", kind="stream", mode="spy", resampler="systematic",
             **dict(base, T=41, chunk=8)),
    ]
    return finish_group(start_group(P, cases, tmp))


def _join(results, cid):
    parts = [r[cid] for r in results]
    return parts, np.concatenate([p[2] for p in parts], 0), \
        np.concatenate([p[3] for p in parts], 0)


@pytest.mark.parametrize("resampler", ["systematic", "metropolis"])
def test_sharded_streaming_matches_sharded_oneshot(sharded, resampler):
    one, x1, lw1 = _join(sharded, f"oneshot-{resampler}")
    st, x2, lw2 = _join(sharded, f"stream-{resampler}")
    np.testing.assert_array_equal(x2, x1)
    np.testing.assert_array_equal(lw2, lw1)
    for o, s in zip(one, st):
        np.testing.assert_array_equal(s[0], o[0])  # log-evidence
        np.testing.assert_array_equal(s[1], o[1])  # ESS
    hist = np.concatenate([o[5] for o in one], 1)  # [T, N, d]
    for s in st:  # every rank holds the global history
        np.testing.assert_array_equal(s[4][0], hist)
        assert s[4][1] == 0


def test_sharded_streaming_halt_then_resume(sharded):
    for r in sharded:
        assert r["halt"] == (40, "step_40.npz")
    res, x_r, lw_r = _join(sharded, "resumed")
    full, x_f, lw_f = _join(sharded, "full")
    np.testing.assert_array_equal(x_r, x_f)
    np.testing.assert_array_equal(lw_r, lw_f)
    np.testing.assert_array_equal(res[0][0], full[0][0])
    assert res[0][4][1] == 40 and res[0][4][0].shape == (41, NS, 2)
    # A single device resumes the two-rank snapshot: a valid run on
    # streams seeded anew.
    single = sharded[0]["single-resumed"]
    assert np.isfinite(single[0]) and single[1].shape == (41,)
    assert abs(float(single[0]) - float(full[0][0])) < 0.05 * abs(
        float(full[0][0]))


def test_sharded_halt_guard_stays_on_device(sharded):
    for r in sharded:
        reads, shapes, lz = r["spy"]
        assert reads == [()] * 5 and shapes == []
        assert np.isfinite(lz)
