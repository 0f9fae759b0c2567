# Copied from vampomi_tpu/io/csv_writer.py, its rank check (:20-33) on torch.distributed's rank (sharding.is_writer) and its native rows through the port's runtime (io/native.py).
"""Fixed-width positional CSV writer, byte-compatible with the reference.

The reference writes row k at byte offset k * strlen(row) with fields
"%5d" + ", %20.15f" per value (src/utilities.cpp:366-401); the header sits
at offset 0.  Skipped iterations leave NUL gaps, which downstream readers
strip (scripts/metrics.py:41).  We reproduce the layout exactly, including
the quirk that each row's offset is computed from *its own* formatted length.
"""

from __future__ import annotations

import os

from ..sharding import is_writer
from . import native

# CSV files are written by rank 0 only, like the reference's rank-0 MPI-IO
# writes (src/utilities.cpp:366-401): a shared out_dir must not see
# create/recreate races or duplicate positional writes from other ranks


class PositionalCSV:
    def __init__(self, path: str, header: list[str], create: bool = True):
        self.path = path
        if create and is_writer():
            if os.path.exists(path):
                os.remove(path)  # reference MPI_File_delete (src/vamp.cpp:857)
            with open(path, "wb") as f:
                f.write((", ".join(header) + "\n").encode())

    def write_row(self, iteration: int, values: list[float]) -> None:
        """Row `iteration` at byte offset iteration * its length, formatted
        and written by the native runtime (C's snprintf: "%5d" % iteration
        + ", %20.15f" % v a value + "\n", the bytes Python's % gives)."""
        if not is_writer():
            return
        values = [float(v) for v in values]
        if not os.path.exists(self.path):
            # as the JAX package's r+b write: a positional write to a
            # missing file is a misconfiguration, not a creation
            raise FileNotFoundError(self.path)
        native.write_csv_row(self.path, iteration, values)


def read_positional_csv(path: str) -> list[list[float]]:
    """NUL-stripping reader for positional CSVs (the oracle used by the
    reference's analysis scripts, scripts/metrics.py:40-41)."""
    rows = []
    with open(path, "rb") as f:
        text = f.read().replace(b"\x00", b"").decode()
    for i, line in enumerate(text.splitlines()):
        if i == 0 or not line.strip():
            continue
        rows.append([float(tok) for tok in line.split(",")])
    return rows
