"""The inputs of a cell that every model shares, drawn from the run's seed:
the design's codes, and the seeds of the run's streams.

The codes are uniform, drawn on the device in blocks of rows from one
generator (int8 codes in [-127, 127]; packed int4 bytes of two uniform
nibbles), as the port's measurement tools draw them.  The pool of
phenotypes is the model's (benchmark/models/<model>.py `phenotype`).
Nothing here calls the program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_BYTES = 256 << 20  # codes drawn in one call


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed (any
    non-negative integer) and the stream's tags."""
    state = np.random.SeedSequence([int(seed), *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def draw_codes(m: int, n: int, packed: bool, seed: int, device) -> torch.Tensor:
    """(m, n) int8 codes, or (m, n/2) packed int4 bytes, on `device`."""
    cols = n // 2 if packed else n
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, 1))
    dtype, lo, hi = (torch.uint8, 0, 256) if packed else (torch.int8, -127, 128)
    X = torch.empty((m, cols), dtype=dtype, device=device)
    rows = max(1, BLOCK_BYTES // cols)
    for r in range(0, m, rows):
        r1 = min(m, r + rows)
        X[r:r1] = torch.randint(lo, hi, (r1 - r, cols), dtype=dtype, device=device, generator=g)
    return X
