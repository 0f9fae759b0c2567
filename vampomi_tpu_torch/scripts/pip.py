# Copied from vampomi_tpu/scripts/pip.py (numpy only; the port imports no JAX).
"""Posterior inclusion probability from a GMRMomi MCMC `.bet` stream
(reference: scripts/pip.py).

.bet format: uint32 marker count, then per iteration [uint32 iteration
number, M float64 betas].  PIP = fraction of iterations in [start, end) in
which each marker's beta is non-zero.
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np


def compute_pip(betfile: str, it_start: int, it_end: int) -> np.ndarray:
    with open(betfile, "rb") as f:
        (m,) = struct.unpack("I", f.read(4))
        pip = np.zeros(m)
        for _ in range(it_end):
            head = f.read(4)
            if len(head) < 4:
                break
            (it,) = struct.unpack("I", head)
            buf = f.read(m * 8)
            if it >= it_start:
                beta = np.frombuffer(buf, dtype="<f8", count=m)
                pip += (np.abs(beta) > 0).astype(np.float64)
    return pip / (it_end - it_start)


def main(argv=None):
    p = argparse.ArgumentParser(description="Posterior inclusion probability from .bet")
    p.add_argument("-bet", "--bet", required=True)
    p.add_argument("-iterations", "--iterations", required=True, help="start:end")
    a = p.parse_args(argv)

    it_start, it_end = (int(v) for v in a.iterations.split(":"))
    pip = compute_pip(a.bet, it_start, it_end)

    base = os.path.basename(a.bet).split(".")[0]
    out = os.path.join(os.path.dirname(a.bet), base + ".pip")
    pip.astype("<f8").tofile(out)
    print("...saved PIP to", out)
    return pip


if __name__ == "__main__":
    main()
