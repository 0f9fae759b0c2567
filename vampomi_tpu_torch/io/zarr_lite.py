# Copied from vampomi_tpu/io/zarr_lite.py (stdlib + numpy; the port imports no JAX).
"""Minimal zarr-v2 directory-store reader/writer (stdlib + numpy only).

The reference's production input path is per-chromosome zarr arrays of
pre-standardized methylation data (reference simulation/sim_top_iid.py:1-16,
103-126: `zarr.open(path)` then `np.array(store)`).  This module implements
the zarr v2 on-disk format (https://zarr-specs.readthedocs.io/, v2 spec)
directly so that path works without the zarr package:

  * `.zarray` JSON metadata: shape, chunks, dtype, compressor, fill_value,
    order, filters;
  * chunk files named by dot-separated grid indices ("0.0", "1.3", ...),
    C-order within each chunk, edge chunks stored FULL-SIZE (overhang
    truncated on read, zero-padded on write), missing chunks = fill_value;
  * compressors: null (raw), zlib and gzip (stdlib) — stores written here
    are readable by the real zarr package and vice versa.  Blosc (zarr's
    default, a C library) is detected and reported with a clear error.

When the real `zarr` package IS importable, callers (sim/sim_top_iid.py)
prefer it; this is the fallback that keeps the reference's input format
first-class in zarr-free environments.
"""

from __future__ import annotations

import gzip
import json
import os
import zlib

import numpy as np


class ZarrLiteArray:
    """Read-only view of a zarr v2 directory-store array."""

    def __init__(self, path: str):
        self.path = path
        meta_path = os.path.join(path, ".zarray")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{meta_path}: only zarr format 2 is supported "
                             f"(got {meta.get('zarr_format')!r})")
        if meta.get("filters"):
            raise ValueError(f"{meta_path}: filters are not supported")
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        fv = meta.get("fill_value", 0)
        # zarr v2 JSON-encodes non-finite float fills as strings
        if isinstance(fv, str):
            fv = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(fv, fv)
        self.fill_value = fv
        self.order = meta.get("order", "C")
        comp = meta.get("compressor")
        self._comp_id = comp["id"] if comp else None
        if self._comp_id not in (None, "zlib", "gzip", "blosc"):
            raise ValueError(
                f"{meta_path}: compressor {self._comp_id!r} needs the real "
                f"zarr package (only null/zlib/gzip/blosc(lz4,zlib) decode "
                f"without it)"
            )
        self._sep = meta.get("dimension_separator", ".")

    def _decompress(self, raw: bytes) -> bytes:
        if self._comp_id == "zlib":
            return zlib.decompress(raw)
        if self._comp_id == "gzip":
            return gzip.decompress(raw)
        if self._comp_id == "blosc":
            # zarr's DEFAULT compressor (numcodecs Blosc, cname lz4 +
            # byte-shuffle) — decoded in pure Python (io/blosc_lite.py)
            from .blosc_lite import blosc_decompress

            return blosc_decompress(raw)
        return raw

    def _chunk(self, idx: tuple[int, ...]) -> np.ndarray:
        name = self._sep.join(str(i) for i in idx)
        p = os.path.join(self.path, name)
        if not os.path.exists(p):
            fv = 0 if self.fill_value is None else self.fill_value
            return np.full(self.chunks, fv, dtype=self.dtype)
        with open(p, "rb") as f:
            raw = self._decompress(f.read())
        n_expect = int(np.prod(self.chunks))
        arr = np.frombuffer(raw, dtype=self.dtype)
        if arr.size != n_expect:
            raise ValueError(
                f"{p}: chunk holds {arr.size} elements, expected {n_expect}"
            )
        return arr.reshape(self.chunks, order=self.order)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = np.empty(self.shape, dtype=self.dtype)
        grid = [range((s + c - 1) // c) for s, c in zip(self.shape, self.chunks)]
        import itertools

        for idx in itertools.product(*grid):
            block = self._chunk(idx)
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, self.chunks, self.shape)
            )
            trim = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            out[sel] = block[trim]
        if dtype is not None:
            return out.astype(dtype)
        return out

    def __getitem__(self, key):
        # whole-array-read semantics: every access materializes the full
        # array (the consumer, sim_top_iid, streams one chromosome store at
        # a time and reads it completely — reference usage is np.array(store),
        # simulation/sim_top_iid.py:112).  Chunk-selective reads are not
        # implemented; use the real zarr package for random access.
        return np.asarray(self)[key]

    def __len__(self) -> int:
        return self.shape[0]


def open_array(path: str) -> ZarrLiteArray:
    """Open a zarr v2 directory store for reading (shape/dtype/np.array)."""
    return ZarrLiteArray(path)


def save_array(
    path: str,
    arr: np.ndarray,
    chunks: tuple[int, ...] | None = None,
    compressor: str | None = "zlib",
    level: int = 1,
) -> None:
    """Write `arr` as a zarr v2 directory store readable by the real zarr
    package (and by `open_array`).  compressor: None | "zlib" | "gzip"."""
    arr = np.asarray(arr)
    if chunks is None:
        chunks = arr.shape
    chunks = tuple(int(min(c, s)) for c, s in zip(chunks, arr.shape))
    os.makedirs(path, exist_ok=True)
    comp_meta = None
    if compressor == "zlib":
        comp_meta = {"id": "zlib", "level": int(level)}
    elif compressor == "gzip":
        comp_meta = {"id": "gzip", "level": int(level)}
    elif compressor is not None:
        raise ValueError(f"unsupported compressor {compressor!r}")
    meta = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": list(chunks),
        "dtype": arr.dtype.str,
        "compressor": comp_meta,
        "fill_value": 0,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)

    grid = [range((s + c - 1) // c) for s, c in zip(arr.shape, chunks)]
    import itertools

    for idx in itertools.product(*grid):
        sel = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, arr.shape)
        )
        block = arr[sel]
        if block.shape != chunks:  # edge chunk: stored full-size, zero-padded
            pad = np.zeros(chunks, dtype=arr.dtype)
            pad[tuple(slice(0, b) for b in block.shape)] = block
            block = pad
        raw = np.ascontiguousarray(block).tobytes()
        if compressor == "zlib":
            raw = zlib.compress(raw, level)
        elif compressor == "gzip":
            raw = gzip.compress(raw, compresslevel=level)
        name = ".".join(str(i) for i in idx)
        with open(os.path.join(path, name), "wb") as f:
            f.write(raw)
