"""PyTorch port, the host runtime's bindings (io/native.py,
io/native_store.py, io/disk_store.py) and ``io.data.load_csv``, mirroring
tests/test_io_native.py and tests/test_disk_store.py case for case, each
against the JAX package's bindings of the same library.

Parity without randomness, so exact: the CSV parsers (native and numpy)
give the JAX package's arrays; the stores give its views, and the disk
store writes byte-identical files and sidecars. Native cases skip when
``native/build/libcusmc_host.so`` is not built (``make -C native``).
"""

import json

import _torch_threads  # noqa: F401
import numpy as np
import pytest

from cusmc_tpu.io.data import load_csv as jax_load_csv
from cusmc_tpu.io.disk_store import DiskTrajectoryStore as JaxDiskStore
from cusmc_tpu.io.native_store import TrajectoryStore as JaxStore
from cusmc_tpu_torch.io.data import load_csv, write_output
from cusmc_tpu_torch.io.disk_store import DiskTrajectoryStore
from cusmc_tpu_torch.io.native import get_lib, load_csv_native, \
    write_csv_native
from cusmc_tpu_torch.io.native_store import TrajectoryStore


@pytest.fixture
def native():
    if get_lib() is None:
        pytest.skip("native/build/libcusmc_host.so is not built "
                    "(make -C native)")


def test_csv_roundtrip_python(tmp_path):
    data = np.random.default_rng(0).standard_normal((37, 3))
    path = str(tmp_path / "t.csv")
    np.savetxt(path, data, delimiter=",", header="a,b,c", comments="",
               fmt="%.10g")
    np.testing.assert_allclose(load_csv(path, force_numpy=True), data,
                               rtol=1e-9)


class TestNativeCSV:
    def test_roundtrip(self, tmp_path, native):
        data = np.random.default_rng(1).standard_normal((53, 4))
        path = str(tmp_path / "n.csv")
        assert write_csv_native(path, "w,x,y,z", data)
        out = load_csv_native(path)
        assert out.shape == (53, 4)
        np.testing.assert_allclose(out, data, rtol=1e-5, atol=1e-8)

    def test_matches_numpy_parser(self, tmp_path, native):
        data = np.random.default_rng(2).standard_normal((20, 2))
        path = str(tmp_path / "m.csv")
        np.savetxt(path, data, delimiter=",", header="y0,y1", comments="",
                   fmt="%.10g")
        native_out = load_csv_native(path)
        ref = np.genfromtxt(path, delimiter=",", skip_header=1)
        np.testing.assert_allclose(native_out, ref, rtol=1e-12)

    def test_no_trailing_newline(self, tmp_path, native):
        path = str(tmp_path / "t.csv")
        with open(path, "w") as f:
            f.write("a,b\n1.5,2.5\n3.5,4.5")
        np.testing.assert_allclose(load_csv_native(path),
                                   [[1.5, 2.5], [3.5, 4.5]])

    def test_missing_file(self, native):
        with pytest.raises(IOError):
            load_csv_native("/nonexistent/x.csv")


@pytest.mark.parametrize("force_numpy", [True, False])
def test_load_csv_equals_jax(tmp_path, force_numpy):
    if not force_numpy and get_lib() is None:
        pytest.skip("native library not built (make -C native)")
    data = np.random.default_rng(4).standard_normal((41, 3))
    path = str(tmp_path / "y.csv")
    np.savetxt(path, data, delimiter=",", header="y0,y1,y2", comments="",
               fmt="%.9g")
    got = load_csv(path, force_numpy=force_numpy)
    want = jax_load_csv(path)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def _blocks():
    return (np.arange(24, dtype=np.float32).reshape(3, 4, 2),
            np.arange(24, 48, dtype=np.float32).reshape(3, 4, 2))


@pytest.mark.parametrize("force_numpy", [True, False])
class TestTrajectoryStore:
    @pytest.fixture(autouse=True)
    def _lib(self, force_numpy):
        if not force_numpy and get_lib() is None:
            pytest.skip("native library not built (make -C native)")

    def test_append_and_view(self, force_numpy):
        store = TrajectoryStore((4, 2), 10, force_numpy=force_numpy)
        assert store.native == (not force_numpy)
        a, b = _blocks()
        store.append(a)
        store.append(b)
        assert store.size == 6
        np.testing.assert_array_equal(store.view(), np.concatenate([a, b]))
        store.close()
        np.testing.assert_array_equal(store.view(), np.concatenate([a, b]))

    def test_view_outlives_close(self, force_numpy):
        store = TrajectoryStore((4, 2), 10, force_numpy=force_numpy)
        a, b = _blocks()
        store.append(a)
        view = store.view()
        store.close()
        del store
        np.testing.assert_array_equal(view, a)

    def test_view_equals_jax(self, force_numpy):
        ours = TrajectoryStore((4, 2), 10, force_numpy=force_numpy)
        theirs = JaxStore((4, 2), 10, force_numpy=force_numpy)
        for blk in _blocks():
            ours.append(blk)
            theirs.append(blk)
        assert ours.view().tobytes() == theirs.view().tobytes()
        assert ours.size == theirs.size == 6

    def test_overflow_raises(self, force_numpy):
        store = TrajectoryStore((2,), 3, force_numpy=force_numpy)
        store.append(np.zeros((2, 2), np.float32))
        with pytest.raises(ValueError):
            store.append(np.zeros((2, 2), np.float32))

    def test_shape_mismatch_raises(self, force_numpy):
        store = TrajectoryStore((2, 2), 3, force_numpy=force_numpy)
        with pytest.raises(ValueError):
            store.append(np.zeros((1, 3, 2), np.float32))


def test_write_output_format(tmp_path):
    T, N, d = 5, 4, 2
    ys = np.random.default_rng(3).standard_normal((T, d))
    w = np.random.default_rng(4).random((T, N))
    px = np.random.default_rng(5).standard_normal((T, N, d))
    write_output(str(tmp_path), ys, w, px, p=2)
    y_out = np.genfromtxt(tmp_path / "y_t.csv", delimiter=",", skip_header=1)
    np.testing.assert_allclose(y_out, ys, rtol=1e-4, atol=1e-5)
    x_out = np.genfromtxt(tmp_path / "x_t_N2.csv", delimiter=",",
                          skip_header=1)
    np.testing.assert_allclose(x_out[:, 0], w[:, 0], rtol=1e-4)
    np.testing.assert_allclose(x_out[:, 1:], px[:, 2, :], rtol=1e-4,
                               atol=1e-5)


# -- the disk store ---------------------------------------------------------

def _fill_and_check(store, path):
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((k, 4, 3)).astype(np.float32)
              for k in (1, 5, 2)]
    for b in blocks:
        store.append(b)
    store.finish()
    expect = np.concatenate(blocks)
    np.testing.assert_array_equal(np.asarray(store.view()), expect)
    np.testing.assert_array_equal(np.asarray(DiskTrajectoryStore.open(path)),
                                  expect)


class TestDiskStore:
    def test_native_roundtrip(self, tmp_path, native):
        p = str(tmp_path / "hist.bin")
        store = DiskTrajectoryStore(p, (4, 3))
        assert store.native
        _fill_and_check(store, p)

    def test_python_fallback_roundtrip(self, tmp_path):
        p = str(tmp_path / "hist_py.bin")
        store = DiskTrajectoryStore(p, (4, 3), force_python=True)
        assert not store.native
        _fill_and_check(store, p)

    def test_native_and_fallback_identical(self, tmp_path, native):
        block = np.random.default_rng(1).standard_normal(
            (7, 2, 2)).astype(np.float32)
        pa, pb = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
        sa = DiskTrajectoryStore(pa, (2, 2))
        sb = DiskTrajectoryStore(pb, (2, 2), force_python=True)
        for s in (sa, sb):
            s.append(block)
            s.finish()
        np.testing.assert_array_equal(np.asarray(sa.view()),
                                      np.asarray(sb.view()))

    def test_shape_validation_and_finish_guard(self, tmp_path):
        store = DiskTrajectoryStore(str(tmp_path / "v.bin"), (3,))
        with pytest.raises(ValueError):
            store.append(np.zeros((2, 4), np.float32))
        store.append(np.zeros((2, 3), np.float32))
        store.finish()
        with pytest.raises(RuntimeError):
            store.append(np.zeros((1, 3), np.float32))

    def test_many_chunks_async(self, tmp_path):
        p = str(tmp_path / "many.bin")
        store = DiskTrajectoryStore(p, (64,), queue_depth=2)
        rng = np.random.default_rng(2)
        blocks = [rng.standard_normal((8, 64)).astype(np.float32)
                  for _ in range(32)]
        for b in blocks:
            store.append(b)
        store.finish()
        np.testing.assert_array_equal(np.asarray(store.view()),
                                      np.concatenate(blocks))

    @pytest.mark.parametrize("force_python", [True, False])
    def test_files_equal_jax(self, tmp_path, force_python):
        rng = np.random.default_rng(5)
        blocks = [rng.standard_normal((k, 3, 2)).astype(np.float32)
                  for k in (4, 1, 3)]
        ours = DiskTrajectoryStore(str(tmp_path / "t.bin"), (3, 2),
                                   force_python=force_python)
        theirs = JaxDiskStore(str(tmp_path / "j.bin"), (3, 2),
                              force_python=force_python)
        for s in (ours, theirs):
            s.start_step = 7
            for b in blocks:
                s.append(b)
            s.finish()
        for suffix in ("", ".json"):
            with open(tmp_path / f"t.bin{suffix}", "rb") as a, \
                    open(tmp_path / f"j.bin{suffix}", "rb") as b:
                assert a.read() == b.read()
        meta = json.loads((tmp_path / "t.bin.json").read_text())
        assert meta == {"step_shape": [3, 2], "dtype": "float32",
                        "size": 8, "start_step": 7}
