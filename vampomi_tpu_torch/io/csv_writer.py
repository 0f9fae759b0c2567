# Copied from vampomi_tpu/io/csv_writer.py, without the jax rank check (:20-33): the port is single-process.
"""Fixed-width positional CSV writer, byte-compatible with the reference.

The reference writes row k at byte offset k * strlen(row) with fields
"%5d" + ", %20.15f" per value (src/utilities.cpp:366-401); the header sits
at offset 0.  Skipped iterations leave NUL gaps, which downstream readers
strip (scripts/metrics.py:41).  We reproduce the layout exactly, including
the quirk that each row's offset is computed from *its own* formatted length.
"""

from __future__ import annotations

import os


class PositionalCSV:
    def __init__(self, path: str, header: list[str], create: bool = True):
        self.path = path
        if create:
            if os.path.exists(path):
                os.remove(path)  # reference MPI_File_delete (src/vamp.cpp:857)
            with open(path, "wb") as f:
                f.write((", ".join(header) + "\n").encode())

    def write_row(self, iteration: int, values: list[float]) -> None:
        values = [float(v) for v in values]
        row = "%5d" % iteration
        for v in values:
            row += ", %20.15f" % v
        row += "\n"
        data = row.encode()
        offset = iteration * len(data)
        with open(self.path, "r+b") as f:
            f.seek(offset)
            f.write(data)


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
