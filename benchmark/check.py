"""The comparison that decides `correct`.

The numbers compared are the model's: each configuration's `model` names
its module, benchmark/models/<model>.py (spec.model), whose `Reference`
runs the plain reference from the same inputs as the fits checked, and
whose `readings` give the compared numbers of a sample of those fits (the
program's, or the control's in its place).  A cell compares those that its
limits file lists, each against its limit (`verdict`).  What is here is the
arithmetic that every model's readings share.
"""

from __future__ import annotations

import math

import numpy as np


def gap(prog_row, ref_row) -> float:
    """The largest of |program - reference| / max(1, |reference|)."""
    p = np.asarray(prog_row, dtype=np.float64)
    r = np.asarray(ref_row, dtype=np.float64)
    return float(np.max(np.abs(p - r) / np.maximum(1.0, np.abs(r))))


def per_iteration(answers: list, follow: list, k: int) -> list:
    """The largest row gap over the fits of each of the first k iterations."""
    return [max(gap(a.rows[i], f.rows[i]) for a, f in zip(answers, follow)) for i in range(k)]


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out = {name: {"value": values.get(name, math.nan), "limit": lim}
           for name, lim in limits["limits"].items()}
    return all(v["value"] <= v["limit"] for v in out.values()), out
