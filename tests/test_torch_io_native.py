"""The port's native IO runtime (csrc/host_io.cpp through io/native.py, built
by the host C++ compiler here as on the card's host) against its numpy
versions and the JAX package's numpy IO, and the streamed ingest of
dataset.load_dataset against the one-piece build_design and the JAX
package's loader."""

import os
import sys

import numpy as np
import pytest
import torch

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.dataset import load_dataset as jload
from vampomi_tpu.io import bin_io as jbin_io
from vampomi_tpu.io import csv_writer as jcsv
from vampomi_tpu_torch import dataset, sharding
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.io import bin_io, csv_writer, native
from vampomi_tpu_torch.ops import _build
from vampomi_tpu_torch.ops.operator import _host_stats, build_design, inv_sd_from_sumsq

torch.set_num_threads(2)


# -- the ten cases of tests/test_native.py, on the port's runtime ----------


def test_read_into_roundtrip(tmp_path):
    data = np.arange(100000, dtype="<f8")
    path = str(tmp_path / "a.bin")
    data.tofile(path)
    out = np.empty(1000, dtype="<f8")
    assert native.read_into(path, out, 500 * 8) == 8000
    np.testing.assert_array_equal(out, data[500:1500])


def test_read_f64_as_f32(tmp_path):
    data = np.random.default_rng(0).normal(size=300000)
    path = str(tmp_path / "b.bin")
    data.astype("<f8").tofile(path)
    out = np.empty(200000, dtype=np.float32)
    native.read_f64_as_f32(path, out, 100000 * 8)
    np.testing.assert_array_equal(out, data[100000:].astype(np.float32))


def test_write_from_slabs(tmp_path):
    path = str(tmp_path / "c.bin")
    native.write_from(path, np.arange(5.0, 10.0), 5 * 8)
    native.write_from(path, np.arange(5.0), 0)
    np.testing.assert_array_equal(np.fromfile(path), np.arange(10.0))


def test_format_csv_row_matches_python_percent():
    vals = [1.5, -0.25, 3.141592653589793, 1e-11, 123456.789]
    row = native.format_csv_row(7, vals)
    assert row == ("%5d" % 7 + "".join(", %20.15f" % v for v in vals) + "\n").encode()


def test_write_csv_row_positional(tmp_path):
    path = str(tmp_path / "d.csv")
    open(path, "wb").write(b"iteration, v\n")
    native.write_csv_row(path, 3, [2.5])
    raw = open(path, "rb").read()
    row = b"    3,    2.500000000000000\n"
    assert raw[3 * len(row): 4 * len(row)] == row


def test_read_missing_file_raises(tmp_path):
    with pytest.raises(OSError, match="No such file"):
        native.read_into(str(tmp_path / "nope.bin"), np.empty(10), 0)


def test_read_past_eof_raises(tmp_path):
    path = str(tmp_path / "e.bin")
    np.arange(10.0).tofile(path)
    with pytest.raises(OSError, match="EOF"):
        native.read_into(path, np.empty(20), 0)


def test_bin_io_uses_native(tmp_path, monkeypatch):
    """read_bin_slab, write_bin_slab and the f64 read_meth_bin go through
    the runtime (counted), the other read_meth_bin dtypes through numpy."""
    calls = []
    for name in ("read_into", "write_from"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda *a, _f=real, _n=name: calls.append(_n) or _f(*a))
    data = np.arange(50.0)
    path = str(tmp_path / "f.bin")
    bin_io.write_bin_slab(path, data)
    np.testing.assert_array_equal(bin_io.read_bin_slab(path, 50), data)
    np.testing.assert_array_equal(bin_io.read_meth_bin(path, 10, 5), data.reshape(5, 10))
    X32 = bin_io.read_meth_bin(path, 10, 5, dtype=np.float32)
    np.testing.assert_array_equal(X32, data.reshape(5, 10).astype(np.float32))
    assert calls == ["write_from", "read_into", "read_into"]


def test_fused_ingest_stats_matches_numpy(tmp_path):
    """read_f64_as_f32_stats: one threaded pass = f32 narrowing + per-marker
    f64 mean / centered sum of squares, equal to the numpy two-pass formula
    (reference compute_markers_statistics, src/data.cpp:233-283)."""
    m, n = 37, 53  # odd sizes exercise row-aligned threading remainders
    X = np.random.default_rng(0).normal(2.0, 3.0, size=(m, n))
    path = str(tmp_path / "meth.bin")
    X.astype("<f8").tofile(path)
    X32, mave, sumsq = np.empty((m, n), np.float32), np.empty(m), np.empty(m)
    assert native.read_f64_as_f32_stats(path, X32, 0, mave, sumsq) == m
    np.testing.assert_array_equal(X32, X.astype(np.float32))
    mave_np, msig_np = _host_stats(X, alpha_scale=1.0)
    np.testing.assert_allclose(mave, mave_np, rtol=1e-13)
    np.testing.assert_allclose(inv_sd_from_sumsq(sumsq, n, 1.0), msig_np, rtol=1e-12)
    # a slab at a row offset
    X32b, maveb, sumsqb = np.empty((m - 10, n), np.float32), np.empty(m - 10), np.empty(m - 10)
    native.read_f64_as_f32_stats(path, X32b, 10 * n * 8, maveb, sumsqb)
    np.testing.assert_array_equal(X32b, X[10:].astype(np.float32))
    np.testing.assert_allclose(maveb, mave_np[10:], rtol=1e-13)
    with pytest.raises(OSError, match="EOF"):  # past the end of the file
        native.read_f64_as_f32_stats(path, np.empty((m + 1, n), np.float32), 0,
                                     np.empty(m + 1), np.empty(m + 1))


def test_dataset_f32_and_f64_loads_agree(tmp_path):
    """load_dataset at f32 and f64 stores the same f64 statistics, rounded
    to the work dtype (JAX's fused-against-numpy check,
    tests/test_native.py)."""
    d = _fixture(tmp_path, 37, 53)
    ds32, ds64 = (dataset.load_dataset(d["bin"], d["phen"], 53, 37, "linear", dt, "cpu")
                  for dt in (torch.float32, torch.float64))
    np.testing.assert_array_equal(ds32.dm.mave.numpy(), ds64.dm.mave.numpy().astype(np.float32))
    np.testing.assert_array_equal(ds32.dm.msig.numpy(), ds64.dm.msig.numpy().astype(np.float32))


# -- the same bytes as numpy and as the JAX package's IO -------------------


def test_runtime_build_is_cached_and_named_by_its_source():
    """host_io.cpp is built by the host compiler with the JAX extension's
    flags into build/vampomi_tpu_torch/, named by a hash of source and
    flags, and loaded once."""
    path = _build._library_path("host_io")
    assert [p.name for p in _build.sources("host_io")] == ["host_io.cpp"]
    assert "-pthread" in _build._flags("host_io") and "-D_FILE_OFFSET_BITS=64" in \
        _build._flags("host_io")
    native.format_csv_row(1, [1.0])
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert _build.library("host_io") is _build.library("host_io")


def test_failed_runtime_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build broken"):
        _build.library("broken")


def test_first_build_under_the_ingest_threads(tmp_path, monkeypatch):
    """With no runtime built yet, the ingest's first reads start on six
    threads at once: one of them builds host_io while the others wait for
    it, and the design is build_design's."""
    m, n = 60, 16
    d = _fixture(tmp_path, m, n)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_FUNCTIONS", {})
    monkeypatch.setattr(dataset, "CHUNK_BYTES", 4 * n * 8)
    monkeypatch.setattr(dataset, "INGEST_THREADS", 6)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # threads switch often: a race shows
    try:
        ds = dataset.load_dataset(d["bin"], d["phen"], n, m, "linear", torch.int8, "cpu")
    finally:
        sys.setswitchinterval(interval)
    _same_design(ds.dm, build_design(bin_io.read_meth_bin_plain(d["bin"], n, m), torch.int8,
                                     "cpu"))
    assert [p.name for p in (tmp_path / "build").iterdir()] == \
        [_build._library_path("host_io").name]


def test_vector_files_are_numpys_and_jaxs_bytes(tmp_path):
    v = np.random.default_rng(1).normal(size=1001)
    v[[3, 500]] = [-0.0, np.inf]
    files = {}
    for tag, write in (("port", bin_io.write_bin_slab), ("jax", jbin_io.write_bin_slab)):
        p = str(tmp_path / f"{tag}.bin")
        write(p, v[600:], 600)  # a later slab first: O_CREAT without O_TRUNC
        write(p, v[:600], 0)
        files[tag] = open(p, "rb").read()
    assert files["port"] == files["jax"] == v.astype("<f8").tobytes()
    p = str(tmp_path / "port.bin")
    for start, count in ((0, 1001), (17, 400), (1000, 1)):
        got = bin_io.read_bin_slab(p, count, start)
        assert got.tobytes() == v[start:start + count].tobytes() \
            == jbin_io.read_bin_slab(p, count, start).tobytes()
    for read in (bin_io.read_bin_slab, jbin_io.read_bin_slab):
        with pytest.raises(ValueError, match="holds only 1 past it"):
            read(p, 2, 1000)


def test_meth_reads_are_numpys_and_jaxs_values(tmp_path):
    X = np.random.default_rng(2).random((29, 31))
    p = str(tmp_path / "m.bin")
    X.tofile(p)
    for start, m in ((0, 29), (5, 11)):
        got = bin_io.read_meth_bin(p, 31, m, start)
        assert got.dtype == np.float64 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, bin_io.read_meth_bin_plain(p, 31, m, start))
        np.testing.assert_array_equal(got, jbin_io.read_meth_bin(p, 31, m, start))
    with pytest.raises(ValueError, match="too small"):
        bin_io.read_meth_bin(p, 31, 30)


def test_positional_csv_is_numpys_and_jaxs_bytes(tmp_path):
    rows = {2: [0.5, -1e-12], 1: [123456.789, float("nan")], 7: [3.0, -0.0]}
    header = ["iteration", "a", "b"]
    out = {}
    for tag, writer in (("port", csv_writer.PositionalCSV), ("jax", jcsv.PositionalCSV)):
        p = str(tmp_path / f"{tag}.csv")
        w = writer(p, header)
        for it, vals in rows.items():
            w.write_row(it, vals)
        out[tag] = open(p, "rb").read()
    assert out["port"] == out["jax"]
    row = b"    7,    3.000000000000000,   -0.000000000000000\n"  # Python's %
    assert out["port"][7 * len(row): 8 * len(row)] == row
    with pytest.raises(FileNotFoundError):
        csv_writer.PositionalCSV(str(tmp_path / "gone.csv"), [], create=False).write_row(1, [1.0])


# -- the streamed ingest ---------------------------------------------------

DTYPES = ("float64", "float32", "bfloat16", "int8", "int4")


def _fixture(tmp_path, m, n, seed=3):
    """Methylation-like rows in [0, 1] with marker-specific ranges, one
    constant row, and a phenotype."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 0.6, m)
    X = lo[:, None] + rng.uniform(0.0, 0.4, m)[:, None] * rng.random((m, n))
    X[4] = 0.25
    paths = {"bin": str(tmp_path / "m.bin"), "phen": str(tmp_path / "m.phen")}
    X.astype("<f8").tofile(paths["bin"])
    with open(paths["phen"], "w") as f:
        f.writelines(f"{i} {i} {float(v)!r}\n" for i, v in enumerate(rng.normal(size=n)))
    return paths


def _same_design(got, want):
    for k in ("X", "mave", "msig", "mmask", "inv_sqrt_n"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert (got.n, got.mt, got.shard) == (want.n, want.mt, want.shard)


@pytest.mark.parametrize("name", DTYPES)
def test_streamed_load_is_build_design_bitwise(tmp_path, monkeypatch, name):
    """Chunks of 9 rows (the last of 4), two threads: the design, qscale and
    phenotype are those of build_design on the whole matrix, bit for bit."""
    m, n = 49, 40
    d = _fixture(tmp_path, m, n)
    monkeypatch.setattr(dataset, "CHUNK_BYTES", 9 * n * 8)
    monkeypatch.setattr(dataset, "INGEST_THREADS", 2)
    dt = RunConfig(compute_dtype=name).resolved_compute_dtype()
    ds = dataset.load_dataset(d["bin"], d["phen"], n, m, "linear", dt, "cpu")
    q = {}
    want = build_design(bin_io.read_meth_bin_plain(d["bin"], n, m), dt, "cpu", quant_out=q)
    _same_design(ds.dm, want)
    if name in ("int8", "int4"):
        assert ds.qscale.tobytes() == q["scale"].tobytes()
    else:
        assert ds.qscale is None and not q


@pytest.mark.parametrize("name", DTYPES)
def test_streamed_slabs_of_two_ranks_are_the_global_rows(tmp_path, monkeypatch, name):
    """Under a 2-way shard each rank streams only its slab (the chunk size
    does not divide it) and holds build_design's rows of the whole matrix."""
    m, n = 31, 40
    d = _fixture(tmp_path, m, n, seed=4)
    monkeypatch.setattr(dataset, "CHUNK_BYTES", 4 * n * 8)
    dt = RunConfig(compute_dtype=name).resolved_compute_dtype()
    q = {}
    whole = build_design(bin_io.read_meth_bin_plain(d["bin"], n, m), dt, "cpu", quant_out=q)
    for r, (cnt, lo) in enumerate(sharding.divide_work(m, 2)):
        sh = sharding.Shard(rank=r, world=2, lo=lo, hi=lo + cnt, mt=m, device=torch.device("cpu"))
        dm, scale = dataset.stream_design(d["bin"], n, cnt, lo, dt, torch.device("cpu"), shard=sh)
        assert dm.shard is sh and dm.mt == float(m) and dm.m_pad == cnt
        for k in ("X", "mave", "msig"):
            assert torch.equal(getattr(dm, k), getattr(whole, k)[lo:lo + cnt]), k
        if scale is not None:
            assert scale.tobytes() == q["scale"][lo:lo + cnt].tobytes()


def test_streamed_load_of_a_short_file_raises_before_any_work(tmp_path):
    d = _fixture(tmp_path, 10, 8)
    with pytest.raises(ValueError, match="too small"):
        dataset.load_dataset(d["bin"], d["phen"], 8, 11, "linear", torch.int8, "cpu")


@pytest.mark.parametrize("name", DTYPES)
def test_streamed_load_matches_jax_load_dataset(tmp_path, monkeypatch, name):
    """Against vampomi_tpu.dataset.load_dataset (mesh=None, its numpy f64
    path) on the same files: codes and qscale bitwise; mave and msig at the
    tolerance tests/test_torch_operator.py states for designs (the same f64
    statistics, rounded once to the work dtype)."""
    m, n = 45, 40
    d = _fixture(tmp_path, m, n, seed=5)
    monkeypatch.setattr(dataset, "CHUNK_BYTES", 8 * n * 8)
    dt = RunConfig(compute_dtype=name).resolved_compute_dtype()
    ds = dataset.load_dataset(d["bin"], d["phen"], n, m, "linear", dt, "cpu")
    jds = jload(d["bin"], d["phen"], n, m, "linear", None,
                JConfig(compute_dtype=name).resolved_compute_dtype())
    X = ds.dm.X.float().numpy() if name == "bfloat16" else ds.dm.X.numpy()
    jX = np.asarray(jds.dm.X[:m])
    np.testing.assert_array_equal(X, jX.astype(np.float32) if name == "bfloat16" else jX)
    rtol = 1e-12 if name == "float64" else 0.0
    for k in ("mave", "msig"):
        np.testing.assert_allclose(getattr(ds.dm, k).numpy(), np.asarray(getattr(jds.dm, k))[:m],
                                   rtol=rtol, err_msg=k)
    if name in ("int8", "int4"):
        assert ds.qscale.tobytes() == np.asarray(jds.qscale)[:m].tobytes()
    np.testing.assert_array_equal(ds.phen.y, jds.phen.y)


def test_ingest_memory_is_bounded_by_chunks(tmp_path, monkeypatch):
    """Each chunk task reads only its own rows: no read is longer than a
    chunk, whatever Mt is."""
    m, n = 64, 16
    d = _fixture(tmp_path, m, n)
    monkeypatch.setattr(dataset, "CHUNK_BYTES", 5 * n * 8)
    sizes = []
    real = bin_io.read_meth_bin
    monkeypatch.setattr(dataset, "read_meth_bin",
                        lambda p, n_, cnt, start_marker: sizes.append(cnt) or
                        real(p, n_, cnt, start_marker))
    dataset.load_dataset(d["bin"], d["phen"], n, m, "linear", torch.int8, "cpu")
    assert sum(sizes) == m and max(sizes) == 5 and len(sizes) == 13
    assert os.path.getsize(d["bin"]) == 8 * m * n
