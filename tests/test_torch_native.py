"""The port's ``io/native.py`` against the JAX package's: the C++ file
prefetcher (``csrc/file_prefetcher.cpp``) against JAX's
(``native/dataloader.cpp``) on the same files, and the two readers against
JAX's Python readers, to the bit.

``get`` blocks until its file is read in both packages, so a read order
outside the prefetch window can wait forever: the tests read in order, as
JAX's own test does (tests/test_native.py), and every read runs under a
watchdog (a thread joined with a timeout), so that a hang fails its test.

JAX's prefetcher has a race: its ``get`` reports the end of the list (-1,
an ``IOError``) once every index has been taken by a worker, also while
the worker that took the index asked for is still reading the file. The
port's counts the files read instead. So JAX's pass is repeated until it
reads every file (the lost reads are counted and printed), and the port's
must never lose one.
"""

import os
import threading

import numpy as np
import pytest

from vido_slam_tpu.io import datasets as j_datasets
from vido_slam_tpu.io import native as j_native
from vido_slam_tpu_torch.io import native
from vido_slam_tpu_torch.io.datasets import write_flo
from vido_slam_tpu_torch.utils import cuda_build

WATCHDOG_S = 20.0


def watched(fn):
    """fn() on a thread joined with a timeout: its result, or its error
    raised here; a hang fails the test."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(WATCHDOG_S)
    assert not t.is_alive(), f"read hung for {WATCHDOG_S} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Sizes 0, 1 byte and about 2 MB, a missing path, and small files."""
    d = tmp_path_factory.mktemp("prefetch")
    rng = np.random.RandomState(0)
    contents = [b"", b"\x07", rng.bytes(2 * 1024 * 1024 + 13), None,
                *[rng.bytes(100 + 37 * i) for i in range(6)]]
    paths = []
    for i, c in enumerate(contents):
        p = str(d / f"f{i}.bin")
        if c is not None:
            with open(p, "wb") as f:
                f.write(c)
        paths.append(p)
    return paths, [b"" if c is None else c for c in contents]


def read_all(cls, paths, n_threads, max_ahead):
    """Every file in order, then an index already served and one past the
    list: (bytes, the two errors' types)."""
    pf = cls(paths, n_threads=n_threads, max_ahead=max_ahead)
    got = [pf.get(i) for i in range(len(paths))]
    errors = []
    for idx in (0, len(paths)):
        try:
            pf.get(idx)
            errors.append(None)
        except (IOError, IndexError) as e:
            errors.append(type(e))
    pf.close()
    return got, errors


@pytest.mark.parametrize("n_threads", [1, 2, 3, 4])
@pytest.mark.parametrize("max_ahead", [1, 3, 8])
def test_prefetcher_equals_jax(files, n_threads, max_ahead):
    paths, want = files
    got, errors = watched(lambda: read_all(native.FilePrefetcher, paths,
                                           n_threads, max_ahead))
    lost = 0
    while True:
        try:
            j_got, j_errors = watched(lambda: read_all(
                j_native.FilePrefetcher, paths, n_threads, max_ahead))
            break
        except OSError:
            lost += 1
            assert lost < 50, "JAX's prefetcher lost a file 50 times"
    print(f"n_threads {n_threads}, max_ahead {max_ahead}: JAX's pass lost "
          f"a file {lost} time(s)")
    assert got == j_got == want
    assert errors == j_errors == [OSError, IndexError]


def test_prefetcher_never_reports_a_file_in_flight_as_the_end(files):
    """200 in-order passes at every worker count: no read of the port's
    raises (about a third of JAX's passes lose a file; see above)."""
    paths, want = files

    def passes():
        for k in range(200):
            got, errors = read_all(native.FilePrefetcher, paths,
                                   1 + k % 4, (1, 3, 8)[k % 3])
            assert got == want and errors == [OSError, IndexError], k
    watched(passes)


def test_prefetcher_default_arguments(files):
    paths, want = files
    pf = native.FilePrefetcher(paths)
    assert watched(lambda: [pf.get(i) for i in range(len(paths))]) == want
    pf.close()
    pf.close()


def test_failed_build_raises(monkeypatch, tmp_path, files):
    """No fallback: a failed build of the library raises, and
    ``native_available`` says so."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="host build of file_prefetcher"):
        native.FilePrefetcher(files[0])


def test_native_available():
    assert native.native_available()


@pytest.mark.parametrize("shape", [(64, 96), (37, 53), (2, 5), (3, 3)])
def test_demosaic_equals_jax_python_reader(shape):
    raw = np.random.RandomState(shape[0]).randint(0, 256, shape, np.uint8)
    want = j_datasets.demosaic_bayer_bg2bgr(raw)
    got = native.demosaic_bg2bgr(raw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_read_flo_equals_jax_python_reader(tmp_path):
    flow = np.random.RandomState(1).randn(10, 14, 2).astype(np.float32)
    flow[0, 0] = [np.inf, -0.0]
    p = str(tmp_path / "a.flo")
    write_flo(p, flow)
    got = native.read_flo_native(p)
    want = j_datasets.read_flo(p)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes() == flow.tobytes()
    with open(str(tmp_path / "bad.flo"), "wb") as f:
        f.write(b"\0" * 16)
    for fn in (native.read_flo_native, j_datasets.read_flo):
        with pytest.raises(ValueError, match="magic"):
            fn(str(tmp_path / "bad.flo"))
    assert os.path.exists(p)
