# Copied from vampomi_tpu/io/bin_io.py:27-189, its native paths through the port's runtime (io/native.py); write_marker_file is the port's own.
"""Binary vector/matrix IO matching the reference's byte formats.

Formats (reference: SURVEY §2.4):
  * meth `.bin`   — Mt consecutive marker blocks of N float64 each
                    (marker-major; reference simulation/data_sim.py:58,
                    slab offset math src/data.cpp:134)
  * vector `.bin` — Mt float64 (estimates, r1, true signals, p-values;
                    reference src/utilities.cpp:241-267)

Reads and writes go through the port's native IO runtime (io/native.py,
built from csrc/host_io.cpp) where the JAX package routes through its
extension: `read_bin_slab` and the f64 `read_meth_bin` by its pread,
`write_bin_slab` by its pwrite; the other `read_meth_bin` dtypes by a
numpy memory map.  The tests hold the bytes against the JAX package's
numpy IO.  Ranks of a sharded run read their own slab of a meth
file (`read_meth_bin`'s `start_marker`) or of an estimate or r1 file
(`read_bin_slab`'s and `read_vec_from_text`'s `start`) and write their own
slab of an artifact (`write_marker_file`'s and `write_bin_slab`'s `start`:
the dumps, a p-value file), so the bytes on disk are those of one process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import native


def _short_read(path: str, count: int, start: int, have: int) -> ValueError:
    return ValueError(
        f"{path}: expected {count} float64 at element offset {start} "
        f"but the file holds only {have} past it "
        f"(file size {os.path.getsize(path)} bytes)"
    )


def read_bin_slab(path: str, count: int, start: int = 0) -> np.ndarray:
    """Read `count` float64 values starting at element offset `start`.
    Mirrors `mpi_read_vec_from_file` (src/utilities.cpp:251-267).

    A short read is fatal (the reference asserts the MPI-IO byte count,
    src/utilities.cpp:373-381): truncated estimate/r1/true-signal inputs must
    never silently flow into the engine as shorter vectors."""
    have = max(0, os.path.getsize(path) // 8 - start)
    if have < count:
        raise _short_read(path, count, start, have)
    out = np.empty(count, dtype="<f8")
    native.read_into(path, out, start * 8)
    return out


def write_bin_slab(path: str, vec: np.ndarray, start: int = 0) -> None:
    """Write float64 `vec` at element offset `start`, creating the file if
    needed.  Mirrors `mpi_store_vec_to_file` (src/utilities.cpp:241-249):
    the runtime's pwrite opens with O_CREAT and without O_TRUNC, so writers
    of disjoint slabs of one shared file never truncate each other, and it
    writes from the array's own memory (no bytes copy)."""
    native.write_from(path, np.ascontiguousarray(vec, dtype="<f8"), start * 8)


def check_meth_size(path: str, n: int, m: int, start_marker: int) -> int:
    """Guard against truncated / wrong-shape meth files up front with a clear
    message (the reference asserts byte counts after the collective read,
    src/utilities.cpp:38-46, 373-381; np.memmap's own error is opaque).
    Returns the byte offset of the slab."""
    offset = start_marker * n * 8
    need = offset + m * n * 8
    size = os.path.getsize(path)
    if size < need:
        raise ValueError(
            f"{path}: meth file too small — need {need} bytes for markers "
            f"[{start_marker}, {start_marker + m}) x N={n} float64, file has "
            f"{size} (is N or the marker count wrong?)"
        )
    return offset


def read_meth_bin(
    path: str, n: int, m: int, start_marker: int = 0, dtype=np.float64
) -> np.ndarray:
    """Load `m` markers starting at `start_marker` of the marker-major meth
    matrix as an (m, n) array (reference slab read at byte offset S·N·8,
    src/data.cpp:116-153), f64 through the runtime's pread, other dtypes
    through read_meth_bin_plain."""
    if np.dtype(dtype) != np.float64:
        return read_meth_bin_plain(path, n, m, start_marker, dtype)
    offset = check_meth_size(path, n, m, start_marker)
    out = np.empty((m, n), dtype="<f8")
    native.read_into(path, out, offset)
    return out


def read_meth_bin_plain(
    path: str, n: int, m: int, start_marker: int = 0, dtype=np.float64
) -> np.ndarray:
    """read_meth_bin through a numpy memory map."""
    offset = check_meth_size(path, n, m, start_marker)
    mm = np.memmap(path, dtype="<f8", mode="r", shape=(m, n), offset=offset)
    return np.asarray(mm, dtype=np.dtype(dtype))


def read_vec_from_text(path: str, count: int, start: int = 0) -> np.ndarray:
    """Whitespace-separated text vector window [start, start+count)
    (reference src/utilities.cpp:104-122)."""
    vals = []
    it = 0
    with open(path) as f:
        for tok in f.read().split():
            if start <= it < start + count:
                vals.append(float(tok))
            elif it >= start + count:
                break
            it += 1
    if len(vals) != count:
        raise ValueError(
            f"{path}: expected {count} values from position {start} but the "
            f"file holds only {len(vals)} past it"
        )
    return np.asarray(vals, dtype=np.float64)


def iteration_file(out_dir: str, out_name: str, it: int, kind: str = "") -> str:
    """Output naming contract: `<out>_it_<k>.bin`, `<out>_r1_it_<k>.bin`, …
    The `it_<k>` substring is load-bearing — downstream modes parse the
    iteration number back out of the filename (src/main_meth.cpp:151-166)."""
    prefix = f"{out_name}_{kind}it_{it}" if kind else f"{out_name}_it_{it}"
    return os.path.join(out_dir, prefix + ".bin")


def substitute_iteration(file_name: str, it: int) -> str:
    """Rewrite `..._it_<k>.<ext>` to iteration `it`, replicating the
    substring surgery in the reference test mode (src/main_meth.cpp:150-166):
    everything from the last "it" through the first "." is replaced.  The
    surgery is scoped to the BASENAME so dotted directory components
    ("./out", "results.v2/") don't corrupt the path (the reference operates
    on the raw argv string and has no such protection)."""
    head, base = os.path.split(file_name)
    pos_it = base.rfind("it")
    if pos_it < 0:
        raise ValueError(
            f"estimate/r1 filename must contain an 'it_<k>' tag: {file_name!r}"
        )
    ext = base[base.find(".") + 1 :]
    return os.path.join(head, base[:pos_it] + f"it_{it}." + ext)


def parse_iteration(file_name: str) -> str:
    """Extract the iteration substring between the last 'it_' and '.bin'
    (reference src/main_meth.cpp:222-226, 247-251)."""
    base = os.path.basename(file_name)
    pos1 = base.rfind("it_")
    if pos1 < 0:
        raise ValueError(
            f"filename must contain an 'it_<k>' tag: {file_name!r}"
        )
    return base[pos1 + 3 : base.rfind(".bin")]


class HostCopy:
    """Host copies of device vectors in flight: `wait()` returns them once
    they have landed."""

    def __init__(self, tensors: list[torch.Tensor], done=None):
        self._tensors = tensors
        self._done = done

    def wait(self) -> list[torch.Tensor]:
        if self._done is not None:
            self._done.synchronize()
        return self._tensors


class HostStager:
    """Copies per-iteration vectors to the host for the artifact writer
    without stalling the compute stream.

    On a card, `copy` records an event on the current stream after the work
    that produced the vectors, makes a side stream wait on it, and copies
    each vector there into a pinned host buffer; `record_stream` keeps the
    caching allocator from handing a source to new work before its copy is
    done.  The writer thread waits on the copies' own event only.  The
    pinned buffers come from PyTorch's caching host allocator, which reuses
    a buffer once the writer has dropped it, so the writer's backlog bounds
    how many exist.  (A plain `.cpu()` on the writer thread instead copies
    to pageable memory on the compute stream, behind the next iteration's
    work.)  On the CPU, `copy` hands back the vectors themselves."""

    def __init__(self, device: torch.device):
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def copy(self, vecs) -> HostCopy:
        if self._stream is None:
            return HostCopy(list(vecs))
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self._stream.device))
        self._stream.wait_event(ready)
        host = []
        with torch.cuda.stream(self._stream):
            for v in vecs:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                v.record_stream(self._stream)
                host.append(buf)
            done = torch.cuda.Event()
            done.record(self._stream)
        return HostCopy(host, done)


def write_marker_file(path: str, vec: torch.Tensor, mt: int, divisor: float,
                      start: int = 0) -> int:
    """Write an M-vector tensor (on any device) to an f64 artifact file, at
    element offset `start` (a rank's slab: the POSIX counterpart of the
    reference's per-rank MPI_File_set_view writes, src/utilities.cpp:241-249),
    truncated to the Mt real markers and divided by `divisor` on the host in
    f64 — division, not reciprocal multiplication, for bit parity with the
    reference's x/sqrt(N) (src/vamp.cpp:237-239) and the JAX package.
    Returns the bytes written."""
    host = vec.detach().cpu().numpy().astype(np.float64)[:mt - start] / divisor
    write_bin_slab(path, host, start)
    return host.nbytes
