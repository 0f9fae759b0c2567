"""`predict` run mode (port of vampomi_tpu/modes/predict.py; reference
src/main_meth_probit.cpp:201-227): z_hat = A_test (x_est * sqrt(N_test))
written as text, one value per line with C++ default stream formatting
(6 significant digits), to `<estimate prefix>.yhat`.  Sharded over markers,
each rank reads its slab of the estimate, `ax`'s all_reduce hands every rank
the whole z, and rank 0 alone writes the file."""

from __future__ import annotations

import numpy as np
import torch

from ..config import RunConfig
from ..dataset import Dataset
from ..io.bin_io import read_bin_slab
from ..ops.operator import ax
from ..sharding import is_writer, span


def run_predict(ds: Dataset, cfg: RunConfig) -> np.ndarray:
    dm = ds.dm
    lo, hi = span(int(dm.mt), dm.shard)

    est_file = cfg.estimate_file
    pos_it = est_file.rfind("it")
    if pos_it < 0:
        raise SystemExit(
            f"FATAL  : --estimate-file must contain an 'it_<k>' tag "
            f"(reference src/main_meth_probit.cpp:204-209): {est_file!r}"
        )
    pred_file = est_file[:pos_it] + ".yhat"

    xp = np.zeros(dm.m_pad)
    xp[:hi - lo] = read_bin_slab(est_file, hi - lo, lo) * np.sqrt(float(cfg.N_test))
    z = ax(dm, torch.as_tensor(xp).to(device=dm.device, dtype=dm.wd))
    z = z.cpu().numpy().astype(np.float64)

    if is_writer():
        with open(pred_file, "w") as f:
            for v in z:
                f.write(f"{v:g}\n")
    return z
