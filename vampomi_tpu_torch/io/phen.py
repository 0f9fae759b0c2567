# Copied from vampomi_tpu/io/phen.py.
"""Phenotype and covariate text parsers, matching reference semantics.

read_phen (reference src/data.cpp:58-110): PLINK rows `FID IID value`;
"NA" is fatal; when standardizing, y is multiplied by
sqrt((n-1) / sum((y - mean)^2)) — scaled by the inverse sd but **not
centered** (the mean is recorded as `intercept` but never subtracted).

read_covariates (reference src/data.cpp:159-227): header row then
`ID FID c1..cC`; each covariate column is z-scored with the 1/N variance
denominator; near-constant columns are zeroed.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np


class Phenotype(NamedTuple):
    y: np.ndarray
    intercept: float   # mean of the raw values (recorded, never subtracted)
    scale: float       # multiplicative factor applied (1/sd); 1.0 if raw


def read_phen(path: str, n: int, standardize: bool = True) -> Phenotype:
    vals = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            toks = re.split(r"\s+", line.strip())
            if not toks or toks == [""]:
                continue
            if len(toks) < 3:
                raise ValueError(
                    f"{path}:{lineno}: expected 'FID IID value', got {line.strip()!r}"
                )
            if toks[2] == "NA":
                raise ValueError("NAN in data!")  # reference throws (data.cpp:73-75)
            vals.append(float(toks[2]))
    y = np.asarray(vals, dtype=np.float64)
    if y.size != n:
        raise ValueError(f"{path}: phenotype rows {y.size} != N {n}")
    avg = float(y.sum() / y.size)
    if not standardize:
        return Phenotype(y=y, intercept=avg, scale=1.0)
    sqn = float(np.sqrt((y.size - 1.0) / np.sum((y - avg) ** 2)))
    return Phenotype(y=y * sqn, intercept=avg, scale=sqn)


def read_covariates(path: str, c: int, n: int) -> np.ndarray:
    """Returns the z-scored (N, C) covariate matrix."""
    if c == 0:
        return np.zeros((n, 0), dtype=np.float64)
    rows = []
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue  # header
            toks = re.split(r"\s+", line.strip())
            entries = [float(t) for t in toks[2:]]
            if len(entries) != c:
                raise ValueError(
                    f"number of covariates = {len(entries)} does not match C = {c}"
                )
            rows.append(entries)
    Z = np.asarray(rows, dtype=np.float64)
    assert Z.shape[0] == n, f"covariate rows {Z.shape[0]} != N {n}"
    mean = Z.mean(axis=0)
    sig = np.sqrt(((Z - mean) ** 2).mean(axis=0))  # 1/N denominator (data.cpp:218)
    out = np.where(sig < 1e-8, 0.0, (Z - mean) / np.where(sig == 0, 1.0, sig))
    return out
