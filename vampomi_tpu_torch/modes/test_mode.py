"""Out-of-sample `test` run mode (port of vampomi_tpu/modes/test_mode.py).

Linear (reference src/main_meth.cpp:112-205): for each saved iteration's
estimate, rescale by sqrt(N_test), predict z = A_test x, and record
R2 = 1 - ||y - z||^2 / (sigma_y^2 N) and Corr(z, y)^2 into `_test.csv`.

Probit (reference src/main_meth_probit.cpp:104-200): confusion matrix of
Phi(z) >= 0.5 against the 0/1 labels, rows [TP, TN, FP, FN, ACC]; the
probit test CSV has NO header row (the reference never writes one).  It
needs no probit engine: only the estimates and the test design.

Sharded over markers (`dm.shard`), each rank reads its slab of every
estimate; the batched pass's one all_reduce hands every rank the whole z,
and rank 0 alone writes the CSV.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy.special import ndtr

from ..config import RunConfig
from ..dataset import Dataset
from ..io.bin_io import read_bin_slab, read_vec_from_text, substitute_iteration
from ..io.csv_writer import PositionalCSV
from ..ops.atx_int8 import K_MAX
from ..ops.operator import ax_batch
from ..sharding import is_writer, span

# estimates that share one pass over the test design.  The JAX package
# batches 16 (test_mode.py:37-64); the port's quantized ax_batch kernels take
# at most K_MAX = 8 right-hand sides (csrc/xtw.cuh keeps K*P*VB accumulators
# a lane in registers), so the port batches 8.  A column's z does not depend
# on the batch it rides in beyond f32 rounding (tests/test_torch_modes.py).
CHUNK = K_MAX


def _read_estimate(est_file_it: str, count: int, start: int = 0) -> np.ndarray:
    """Values [start, start + count) of an estimate file."""
    # extension = everything after the basename's FIRST dot (reference
    # main_meth.cpp:151-152, scoped to the filename so dotted dirs work)
    base = os.path.basename(est_file_it)
    ext = base[base.find(".") + 1:]
    if ext == "bin":
        return read_bin_slab(est_file_it, count, start)
    return read_vec_from_text(est_file_it, count, start)


def _collect_predictions(ds: Dataset, cfg: RunConfig, chunk: int = CHUNK):
    """Yield (iteration, z) for every saved estimate in test_iter_range,
    `chunk` estimates to a pass over the test design (multi-RHS ax_batch)
    instead of the reference's one pass per iteration (main_meth.cpp:163-202)."""
    dm = ds.dm
    m_lo, m_hi = span(int(dm.mt), dm.shard)
    scale = np.sqrt(float(cfg.N_test))

    lo, hi = cfg.test_iter_range
    pending = []
    for it in range(lo, hi + 1):
        est_file_it = substitute_iteration(cfg.estimate_file, it)
        if os.path.exists(est_file_it):
            pending.append((it, est_file_it))

    for i in range(0, len(pending), chunk):
        grp = pending[i:i + chunk]
        cols = np.zeros((dm.m_pad, len(grp)))
        for k, (_, f) in enumerate(grp):
            x_est = _read_estimate(f, m_hi - m_lo, m_lo)
            cols[:len(x_est), k] = x_est * scale
        xs = torch.as_tensor(cols).to(device=dm.device, dtype=dm.wd)
        Z = ax_batch(dm, xs).cpu().numpy().astype(np.float64)
        for k, (it, _) in enumerate(grp):
            yield it, Z[:, k]


def run_test_linear(ds: Dataset, cfg: RunConfig) -> list[list[float]]:
    y = ds.phen.y
    # stdev with the (n-1) denominator (reference utilities.cpp:183-205);
    # constant across iterations
    stdev = float(np.std(y, ddof=1))

    out = PositionalCSV(
        os.path.join(cfg.out_dir, cfg.out_name + "_test.csv"),
        ["iteration", "R2 test", "z correlation test"],
    )

    rows = []
    for it, z in _collect_predictions(ds, cfg):
        l2 = float(np.sum((y - z) ** 2))
        r2 = 1.0 - l2 / (stdev * stdev * len(y))
        # zero-norm guard: an all-zero estimate (iteration 1 of a cold start)
        # predicts z = 0; the reference divides by 0 and writes NaN
        # (src/main_meth.cpp:181-192) — the JAX package's deliberate divergence
        den = float(np.sqrt(np.dot(z, z) * np.dot(y, y)))
        corr = float(np.dot(z, y)) / den if den > 0.0 else 0.0
        row = [r2, corr * corr]
        rows.append(row)
        out.write_row(it, row)
    return rows


def run_test_probit(ds: Dataset, cfg: RunConfig) -> list[list[float]]:
    y = ds.phen.y

    # probit test csv: rows only, no header (src/main_meth_probit.cpp:106-199)
    path = os.path.join(cfg.out_dir, cfg.out_name + "_test.csv")
    if is_writer():
        if os.path.exists(path):
            os.remove(path)
        open(path, "wb").close()
    out = PositionalCSV(path, [], create=False)

    rows = []
    for it, z in _collect_predictions(ds, cfg):
        yhat = (ndtr(z) >= 0.5).astype(np.float64)
        tp = int(np.sum((y == 1) & (yhat == 1)))
        tn = int(np.sum((y == 0) & (yhat == 0)))
        fp = int(np.sum((y == 0) & (yhat == 1)))
        fn = int(np.sum((y == 1) & (yhat == 0)))
        acc = (tp + tn) / max(tp + tn + fp + fn, 1)
        row = [float(tp), float(tn), float(fp), float(fn), acc]
        rows.append(row)
        out.write_row(it, row)
    return rows
