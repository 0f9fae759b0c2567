"""The port's native IO runtime: `csrc/host_io.cpp`, a copy of the JAX
package's extension (native/vampomi_native.cpp) with plain C entry points,
built by the host C++ compiler at first use (ops/_build.py) and loaded with
ctypes, on the CPU as on the card's host.

    read_into(path, out, offset)              pread into a buffer
    read_f64_as_f32(path, out, offset)        f64 file values narrowed to f32
    read_f64_as_f32_stats(path, out, offset)  ... plus per-row f64 mean and
                                              centered sum of squares
    write_from(path, data, offset)            pwrite (O_CREAT, no O_TRUNC)
    format_csv_row(iteration, values)         "%5d" + ", %20.15f"... bytes
    write_csv_row(path, iteration, values)    that row at iteration * length

A read of 128 MiB or more is split over threads (one per 64 MiB, at most
16 and at most the host's cores); a shorter one is one pread.  Offsets are
in bytes.  A failure (a missing file, a read past the end of the file)
raises OSError with the runtime's message; a failed build raises
RuntimeError with the compiler's output.  ctypes releases the interpreter
lock for each call, so reads on several threads overlap.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_ERR_BYTES = 1024
_P = ctypes.c_void_p
_U64 = ctypes.c_uint64


def _fn(symbol: str, argtypes: list, restype=ctypes.c_int):
    fn = _build.function("host_io", symbol, argtypes)
    fn.restype = restype
    return fn


def _call(symbol: str, argtypes: list, path: str, *args) -> None:
    err = ctypes.create_string_buffer(_ERR_BYTES)
    rc = _fn(symbol, [ctypes.c_char_p, *argtypes, ctypes.c_char_p, _U64])(
        path.encode(), *args, err, _ERR_BYTES)
    if rc != 0:
        raise OSError(f"{symbol}({path!r}): {err.value.decode(errors='replace')}")


def _writable(out: np.ndarray, dtype=None) -> np.ndarray:
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("the buffer must be a writable C-contiguous numpy array")
    if dtype is not None and out.dtype != np.dtype(dtype):
        raise ValueError(f"the buffer must hold {np.dtype(dtype)}, not {out.dtype}")
    return out


def read_into(path: str, out: np.ndarray, offset: int) -> int:
    """Fill `out` with the file's bytes from `offset`; returns the bytes
    read.  Reading past the end of the file raises."""
    _writable(out)
    _call("read_into", [_P, _U64, _U64], path, out.ctypes.data, out.nbytes, offset)
    return out.nbytes


def read_f64_as_f32(path: str, out: np.ndarray, offset: int) -> int:
    """Fill the f32 `out` with the file's f64 values from `offset`, each
    rounded to f32; returns the count."""
    _writable(out, np.float32)
    _call("read_f64_as_f32", [_P, _U64, _U64], path, out.ctypes.data, out.size, offset)
    return out.size


def read_f64_as_f32_stats(path: str, out: np.ndarray, offset: int,
                          mave: np.ndarray, sumsq: np.ndarray) -> int:
    """read_f64_as_f32 into the (rows, n) f32 `out`, and each row's f64 mean
    and centered sum of squares into `mave` and `sumsq` (rows f64 each),
    in the same pass over the file; returns the rows."""
    _writable(out, np.float32)
    if out.ndim != 2:
        raise ValueError("the buffer must be (rows, n)")
    rows, n = out.shape
    for a in (mave, sumsq):
        _writable(a, np.float64)
        if a.shape != (rows,):
            raise ValueError(f"statistics buffers must be ({rows},)")
    _call("read_f64_as_f32_stats", [_P, _U64, _U64, _U64, _P, _P], path, out.ctypes.data,
          rows, n, offset, mave.ctypes.data, sumsq.ctypes.data)
    return rows


def write_from(path: str, data: np.ndarray, offset: int) -> int:
    """pwrite the C-contiguous `data`'s bytes at `offset`, creating the file
    if needed and never truncating it; returns the bytes written."""
    if not data.flags.c_contiguous:
        raise ValueError("the buffer must be C-contiguous")
    _call("write_from", [_P, _U64, _U64], path, data.ctypes.data, data.nbytes, offset)
    return data.nbytes


def _values(values) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(values, dtype=np.float64).reshape(-1))


def format_csv_row(iteration: int, values) -> bytes:
    """The row "%5d" % iteration + ", %20.15f" % v for each value + "\\n",
    as C's snprintf formats it."""
    v = _values(values)
    out = ctypes.create_string_buffer(64 * (v.size + 1) + 1)
    n = _fn("format_csv_row", [ctypes.c_long, _P, _U64, ctypes.c_char_p, _U64],
            ctypes.c_int64)(iteration, v.ctypes.data, v.size, out, len(out))
    if n < 0:
        raise ValueError("format_csv_row: row longer than its buffer")
    return out.raw[:n]


def write_csv_row(path: str, iteration: int, values) -> None:
    """Write format_csv_row(iteration, values) at byte offset iteration *
    its length (reference utilities.cpp:383)."""
    v = _values(values)
    _call("write_csv_row", [ctypes.c_long, _P, _U64], path, iteration, v.ctypes.data, v.size)
