"""The inputs of a cell, drawn from the run's seed: the design's codes and a
pool of planted phenotypes.

The codes are uniform, drawn on the device in blocks of rows from one
generator (int8 codes in [-127, 127]; packed int4 bytes of two uniform
nibbles), as the port's measurement tools draw them.  A phenotype plants
one causal marker per `markers_per_causal` with effects N(0, h2/causal) in
file units, adds N(0, 1 - h2) noise and scales y to unit sample variance
(as the port's phenotype reader does), so that y = A beta + e holds for the
standardized design.  Every phenotype has its own causal set and noise.
Nothing here calls the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .reference.gvamp import unpack_codes

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


class Phenotype(NamedTuple):
    y: np.ndarray       # (N,) file units, unit sample variance
    beta: np.ndarray    # (M,) the planted effects, file units
    probs: list         # the prior at the planted truth: [1 - c/M, c/M]
    vars: list          # [0, h2/c]


def planted(codes: torch.Tensor, packed: bool, n: int, seed: int, index: int,
            markers_per_causal: int, h2: float) -> Phenotype:
    """Phenotype `index` of the pool of run `seed` on the design of `codes`."""
    m = codes.shape[0]
    causal = max(1, m // markers_per_causal)
    rng = np.random.default_rng(subseed(seed, 2, index))
    idx = np.sort(rng.choice(m, causal, replace=False))
    effects = rng.normal(0.0, math.sqrt(h2 / causal), causal)
    rows = codes[torch.as_tensor(idx, device=codes.device)]
    c = unpack_codes(rows, torch.float64) if packed else rows.double()
    mean = c.mean(dim=1, keepdim=True)
    sd = torch.sqrt(((c - mean) ** 2).sum(dim=1, keepdim=True) / (n - 1))
    g = (((c - mean) / sd) * torch.as_tensor(effects, device=c.device)[:, None]).sum(dim=0)
    y = g.cpu().numpy() + rng.normal(0.0, math.sqrt(1.0 - h2), n)
    y = y * math.sqrt((n - 1.0) / np.sum((y - y.mean()) ** 2))
    beta = np.zeros(m)
    beta[idx] = effects
    return Phenotype(y=y, beta=beta, probs=[1.0 - causal / m, causal / m],
                     vars=[0.0, h2 / causal])
