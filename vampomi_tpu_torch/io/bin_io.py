# Copied from vampomi_tpu/io/bin_io.py:27-189 (pure-numpy paths only); write_marker_file is the port's own.
"""Binary vector/matrix IO matching the reference's byte formats.

Formats (reference: SURVEY §2.4):
  * meth `.bin`   — Mt consecutive marker blocks of N float64 each
                    (marker-major; reference simulation/data_sim.py:58,
                    slab offset math src/data.cpp:134)
  * vector `.bin` — Mt float64 (estimates, r1, true signals, p-values;
                    reference src/utilities.cpp:241-267)

The port is single-process and uses the pure-numpy readers and writers of
the JAX package; it never loads that package's native extension.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def read_bin_slab(path: str, count: int, start: int = 0) -> np.ndarray:
    """Read `count` float64 values starting at element offset `start`.
    Mirrors `mpi_read_vec_from_file` (src/utilities.cpp:251-267).

    A short read is fatal (the reference asserts the MPI-IO byte count,
    src/utilities.cpp:373-381): truncated estimate/r1/true-signal inputs must
    never silently flow into the engine as shorter vectors."""
    out = np.fromfile(path, dtype="<f8", count=count, offset=start * 8)
    if out.size != count:
        raise ValueError(
            f"{path}: expected {count} float64 at element offset {start} "
            f"but the file holds only {out.size} past it "
            f"(file size {os.path.getsize(path)} bytes)"
        )
    return out


def write_bin_slab(path: str, vec: np.ndarray, start: int = 0) -> None:
    """Write float64 `vec` at element offset `start`, creating the file if
    needed.  Mirrors `mpi_store_vec_to_file` (src/utilities.cpp:241-249)."""
    vec = np.ascontiguousarray(vec, dtype="<f8")
    # O_CREAT WITHOUT O_TRUNC + pwrite: writers of disjoint slabs of one
    # shared file must never truncate each other
    fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.pwrite(fd, vec.tobytes(), start * 8)
    finally:
        os.close(fd)


def _check_meth_size(path: str, n: int, m: int, start_marker: int) -> int:
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
    src/data.cpp:116-153)."""
    dt = np.dtype(dtype)
    offset = _check_meth_size(path, n, m, start_marker)
    mm = np.memmap(path, dtype="<f8", mode="r", shape=(m, n), offset=offset)
    return np.asarray(mm, dtype=dt)


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


def write_marker_file(path: str, vec: torch.Tensor, mt: int, divisor: float) -> None:
    """Write an M-vector tensor (on any device) to an f64 artifact file,
    truncated to the Mt real markers and divided by `divisor` on the host in
    f64 — division, not reciprocal multiplication, for bit parity with the
    reference's x/sqrt(N) (src/vamp.cpp:237-239) and the JAX package."""
    host = vec.detach().cpu().numpy().astype(np.float64)
    write_bin_slab(path, host[:mt] / divisor)
