"""The port's copies of the production input path (io/zarr_lite.py,
io/blosc_lite.py, sim/sim_top_iid.py): tests/test_zarr.py's cases on them,
then stores written by either package read by the other, and
sim_top_iid's files byte-identical to the JAX package's at the same seed."""

import json
import os

import numpy as np
import pytest

from vampomi_tpu.io import zarr_lite as jzarr
from vampomi_tpu_torch.sim.sim_top_iid import simulate_top as jsimulate_top
from vampomi_tpu_torch.io.zarr_lite import open_array, save_array


@pytest.mark.parametrize("compressor", [None, "zlib", "gzip"])
@pytest.mark.parametrize("chunks", [None, (7, 5), (16, 16)])
def test_roundtrip(tmp_path, compressor, chunks):
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(13, 11))
    p = str(tmp_path / "a.zarr")
    save_array(p, arr, chunks=chunks, compressor=compressor)
    z = open_array(p)
    assert z.shape == arr.shape and z.dtype == arr.dtype
    np.testing.assert_array_equal(np.asarray(z), arr)
    np.testing.assert_array_equal(z[3:7, 2:], arr[3:7, 2:])


def test_missing_chunk_is_fill_value(tmp_path):
    arr = np.arange(24, dtype=np.float64).reshape(6, 4)
    p = str(tmp_path / "b.zarr")
    save_array(p, arr, chunks=(3, 4), compressor=None)
    os.remove(os.path.join(p, "1.0"))  # drop the second chunk row-group
    out = np.asarray(open_array(p))
    np.testing.assert_array_equal(out[:3], arr[:3])
    np.testing.assert_array_equal(out[3:], 0.0)


def test_corrupt_chunk_fatal(tmp_path):
    arr = np.ones((4, 4))
    p = str(tmp_path / "c.zarr")
    save_array(p, arr, compressor=None)
    with open(os.path.join(p, "0.0"), "wb") as f:
        f.write(b"\0" * 16)  # wrong byte count
    with pytest.raises(ValueError, match="chunk holds"):
        np.asarray(open_array(p))


def test_unknown_compressor_reported_clearly(tmp_path):
    p = tmp_path / "d.zarr"
    p.mkdir()
    meta = dict(zarr_format=2, shape=[2, 2], chunks=[2, 2], dtype="<f8",
                compressor={"id": "lzma"}, fill_value=0,
                order="C", filters=None)
    (p / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="lzma"):
        open_array(str(p))


def test_lz4_block_handcrafted():
    """Literals + far match + OVERLAPPING match (period-2 repeat), byte-
    exact against the LZ4 block spec."""
    from vampomi_tpu_torch.io.blosc_lite import lz4_decompress_block

    # seq1: 8 literals "ABCDEFGH", match len 8 at offset 8 -> repeats them
    # seq2: 2 literals "xy", overlapping match len 6 at offset 2 -> "xyxyxyxy"
    # seq3: final literals "tail!"
    blk = bytes([0x84]) + b"ABCDEFGH" + bytes([0x08, 0x00])
    blk += bytes([0x22]) + b"xy" + bytes([0x02, 0x00])
    blk += bytes([0x50]) + b"tail!"
    want = b"ABCDEFGH" + b"ABCDEFGH" + b"xy" + b"xyxyxy" + b"tail!"
    got = lz4_decompress_block(blk, len(want))
    assert got == want


def test_lz4_block_long_runs():
    """Literal-run and match-run length extension bytes (>= 15)."""
    from vampomi_tpu_torch.io.blosc_lite import (
        _lz4_compress_naive, lz4_decompress_block,
    )

    data = b"\xab" * 4096  # period-1: long overlapping match with extensions
    comp = _lz4_compress_naive(data)
    assert len(comp) < 64
    assert lz4_decompress_block(comp, len(data)) == data

    rng = np.random.default_rng(0)
    blob = rng.integers(0, 256, size=777, dtype=np.uint8).tobytes()
    comp = _lz4_compress_naive(blob)  # all-literals path with extension
    assert lz4_decompress_block(comp, len(blob)) == blob


def test_blosc_chunk_roundtrip_shuffle_split():
    """A real Blosc1 frame: byte-shuffle, lz4 codec, typesize streams."""
    from vampomi_tpu_torch.io.blosc_lite import blosc_compress_lz4, blosc_decompress

    rng = np.random.default_rng(2)
    # f64 data in a narrow window: sign/exponent/high-mantissa bytes are
    # constant -> several shuffled streams are pure runs and compress
    arr = 1.0 + np.arange(2048) * 1e-12
    raw = arr.astype("<f8").tobytes()
    chunk = blosc_compress_lz4(raw, typesize=8, shuffle=True)
    assert len(chunk) < len(raw)  # compression actually happened
    assert blosc_decompress(chunk) == raw

    # incompressible data: every stream stored verbatim, still round-trips
    blob = rng.integers(0, 256, size=8 * 2048, dtype=np.uint8).tobytes()
    chunk2 = blosc_compress_lz4(blob, typesize=8, shuffle=True)
    assert blosc_decompress(chunk2) == blob


def test_blosc_multiblock_partial_leftover():
    """A multi-block chunk whose FINAL block is partial: c-blosc compresses
    the leftover block as ONE stream even when its size divides typesize
    with >=128 B/stream (split_block is gated on !leftoverblock, blosc.c) —
    the round-3 advisor found the decoder mis-split it.  The fixture writer
    mirrors c-blosc, so an asymmetric encode/decode would fail round-trip."""
    from vampomi_tpu_torch.io.blosc_lite import blosc_compress_lz4, blosc_decompress

    rng = np.random.default_rng(7)
    # 3 full 4096-byte blocks + a 2048-byte leftover.  2048 % 8 == 0 and
    # 2048/8 = 256 >= 128, so a naive decoder WOULD split the leftover.
    arr = 1.0 + np.arange((3 * 4096 + 2048) // 8) * 1e-12
    raw = arr.astype("<f8").tobytes()
    chunk = blosc_compress_lz4(raw, typesize=8, shuffle=True, blocksize=4096)
    assert blosc_decompress(chunk) == raw

    # incompressible variant: leftover stored verbatim, still one stream
    blob = rng.integers(0, 256, size=3 * 4096 + 2048, dtype=np.uint8).tobytes()
    chunk2 = blosc_compress_lz4(blob, typesize=8, shuffle=True, blocksize=4096)
    assert blosc_decompress(chunk2) == blob

    # exact multiple of blocksize: no leftover, all blocks split normally
    blob3 = raw[: 2 * 4096]
    chunk3 = blosc_compress_lz4(blob3, typesize=8, shuffle=True, blocksize=4096)
    assert blosc_decompress(chunk3) == blob3


def test_blosc_memcpyed_chunk():
    from vampomi_tpu_torch.io.blosc_lite import blosc_decompress
    import struct

    payload = bytes(range(48))
    header = bytearray(16)
    header[0], header[1], header[2], header[3] = 2, 1, 0x2, 8
    struct.pack_into("<III", header, 4, len(payload), len(payload),
                     16 + len(payload))
    assert blosc_decompress(bytes(header) + payload) == payload


def test_blosc_unsupported_inner_codec():
    from vampomi_tpu_torch.io.blosc_lite import blosc_decompress
    import struct

    header = bytearray(16)
    header[0], header[1], header[3] = 2, 1, 8
    header[2] = 4 << 5  # zstd
    struct.pack_into("<III", header, 4, 256, 256, 16 + 4 + 8)
    chunk = bytes(header) + struct.pack("<i", 20) + struct.pack("<i", 4) + b"xxxx"
    with pytest.raises(ValueError, match="zstd"):
        blosc_decompress(chunk)


def test_zarr_store_with_blosc_chunks(tmp_path):
    """End-to-end: a zarr v2 directory store whose chunks are Blosc/LZ4
    frames — the real zarr package's DEFAULT configuration — reads through
    ZarrLiteArray."""
    from vampomi_tpu_torch.io.blosc_lite import blosc_compress_lz4

    rng = np.random.default_rng(3)
    arr = np.cumsum(rng.normal(size=(64, 32))) .reshape(64, 32)
    p = tmp_path / "bl.zarr"
    p.mkdir()
    meta = dict(
        zarr_format=2, shape=[64, 32], chunks=[32, 32], dtype="<f8",
        compressor={"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                    "blocksize": 0},
        fill_value=0.0, order="C", filters=None,
    )
    (p / ".zarray").write_text(json.dumps(meta))
    for i in range(2):
        block = arr[i * 32:(i + 1) * 32].astype("<f8").tobytes()
        (p / f"{i}.0").write_bytes(blosc_compress_lz4(block, typesize=8))
    z = open_array(str(p))
    np.testing.assert_array_equal(np.asarray(z), arr)


def test_real_zarr_interop(tmp_path):
    """When the real zarr package exists, stores written by zarr_lite must
    be readable by it and vice versa (skipped in zarr-free environments)."""
    zarr = pytest.importorskip("zarr")
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(9, 6))

    ours = str(tmp_path / "ours.zarr")
    save_array(ours, arr, chunks=(4, 3), compressor="zlib")
    np.testing.assert_array_equal(np.array(zarr.open(ours)), arr)

    theirs = str(tmp_path / "theirs.zarr")
    z = zarr.open(theirs, mode="w", shape=arr.shape, chunks=(4, 3),
                  dtype="<f8")
    z[:] = arr
    np.testing.assert_array_equal(np.asarray(open_array(theirs)), arr)


def test_sim_top_iid_zarr_stores(tmp_path):
    """The streaming simulator consumes zarr v2 directory stores — the
    reference's actual input path — and matches the .npy route bit-for-bit."""
    from vampomi_tpu_torch.sim.sim_top_iid import simulate_top
    from vampomi_tpu_torch.io.bin_io import read_meth_bin

    rng = np.random.default_rng(5)
    n, m_chr = 40, [18, 9]
    stores_z = tmp_path / "zarr_stores"
    stores_n = tmp_path / "npy_stores"
    stores_z.mkdir()
    stores_n.mkdir()
    chroms = []
    for i, mc in enumerate(m_chr):
        arr = rng.normal(size=(n, mc))
        save_array(str(stores_z / f"chr{i+1:02d}"), arr,
                   chunks=(n, 5), compressor="zlib")
        np.save(stores_n / f"chr{i+1:02d}.npy", arr)
        chroms.append(arr)
    X_full = np.concatenate(chroms, axis=1)
    m = X_full.shape[1]

    out_z = tmp_path / "out_z"
    out_n = tmp_path / "out_n"
    out_z.mkdir()
    out_n.mkdir()
    rz = simulate_top(str(stores_z), str(out_z), "ds", h2=0.8, lam=0.1,
                      ratio=0.7, m=m, n=n, seed=11)
    rn = simulate_top(str(stores_n), str(out_n), "ds", h2=0.8, lam=0.1,
                      ratio=0.7, m=m, n=n, seed=11)

    msk = np.loadtxt(out_z / (rz["fname"] + ".msk")).astype(bool)
    Xtr = read_meth_bin(rz["train_bin"], rz["n_train"], m)
    np.testing.assert_allclose(Xtr, X_full[msk].T)

    # identical bytes to the .npy route at the same seed
    for key in ("train_bin", "test_bin"):
        with open(rz[key], "rb") as a, open(rn[key], "rb") as b:
            assert a.read() == b.read()


# -- the two packages against each other ------------------------------------


@pytest.mark.parametrize("compressor", [None, "zlib", "gzip"])
def test_stores_cross_read_between_packages(tmp_path, compressor):
    arr = np.random.default_rng(8).normal(size=(17, 9))
    ours, theirs = str(tmp_path / "ours.zarr"), str(tmp_path / "theirs.zarr")
    save_array(ours, arr, chunks=(5, 4), compressor=compressor)
    jzarr.save_array(theirs, arr, chunks=(5, 4), compressor=compressor)
    for f in sorted(os.listdir(ours)):  # the same files, byte for byte
        assert open(os.path.join(ours, f), "rb").read() == \
            open(os.path.join(theirs, f), "rb").read(), f
    np.testing.assert_array_equal(np.asarray(jzarr.open_array(ours)), arr)
    np.testing.assert_array_equal(np.asarray(open_array(theirs)), arr)


def _blosc_store(path, arr, compress):
    """A zarr v2 store of Blosc/LZ4 chunks (zarr's default compressor),
    two chunk rows."""
    path.mkdir()
    rows = arr.shape[0] // 2
    meta = dict(zarr_format=2, shape=list(arr.shape), chunks=[rows, arr.shape[1]], dtype="<f8",
                compressor={"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                            "blocksize": 0},
                fill_value=0.0, order="C", filters=None)
    (path / ".zarray").write_text(json.dumps(meta))
    for i in range(2):
        (path / f"{i}.0").write_bytes(compress(arr[i * rows:(i + 1) * rows].astype("<f8").tobytes(),
                                               typesize=8))


def test_blosc_stores_cross_read_between_packages(tmp_path):
    from vampomi_tpu.io.blosc_lite import blosc_compress_lz4 as jcompress
    from vampomi_tpu_torch.io.blosc_lite import blosc_compress_lz4

    arr = 1.0 + np.arange(64 * 16).reshape(64, 16) * 1e-12
    _blosc_store(tmp_path / "ours", arr, blosc_compress_lz4)
    _blosc_store(tmp_path / "theirs", arr, jcompress)
    for f in ("0.0", "1.0"):
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "theirs" / f).read_bytes()
    np.testing.assert_array_equal(np.asarray(jzarr.open_array(str(tmp_path / "ours"))), arr)
    np.testing.assert_array_equal(np.asarray(open_array(str(tmp_path / "theirs"))), arr)


@pytest.mark.parametrize("kind", ["npy", "zarr", "blosc"])
def test_sim_top_iid_files_are_jaxs_bytes(tmp_path, kind):
    """Every file sim_top_iid writes (the .msk, .dim, train/test .bin and
    .phen, the true effects) equals the JAX package's, byte for byte, from
    the same stores and seed."""
    from vampomi_tpu_torch.io.blosc_lite import blosc_compress_lz4
    from vampomi_tpu_torch.sim.sim_top_iid import simulate_top

    rng = np.random.default_rng(9)
    n, m_chr = 40, [12, 8]
    stores = tmp_path / "stores"
    stores.mkdir()
    for i, mc in enumerate(m_chr):
        arr = rng.random((n, mc))
        name = stores / f"chr{i + 1:02d}"
        if kind == "npy":
            np.save(f"{name}.npy", arr)
        elif kind == "zarr":
            save_array(str(name), arr, chunks=(n, 5), compressor="zlib")
        else:
            _blosc_store(name, arr, blosc_compress_lz4)
    outs = {}
    for tag, sim in (("port", simulate_top), ("jax", jsimulate_top)):
        out = tmp_path / tag
        out.mkdir()
        sim(str(stores), str(out), "ds", h2=0.8, lam=0.1, ratio=0.7, m=sum(m_chr), n=n, seed=11)
        outs[tag] = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
    assert len(outs["port"]) == 8 and outs["port"] == outs["jax"]
