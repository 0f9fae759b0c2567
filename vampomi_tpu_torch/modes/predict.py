"""`predict` run mode (port of vampomi_tpu/modes/predict.py; reference
src/main_meth_probit.cpp:201-227): z_hat = A_test (x_est * sqrt(N_test))
written as text, one value per line with C++ default stream formatting
(6 significant digits), to `<estimate prefix>.yhat`."""

from __future__ import annotations

import numpy as np
import torch

from ..config import RunConfig
from ..dataset import Dataset
from ..io.bin_io import read_bin_slab
from ..ops.operator import ax


def run_predict(ds: Dataset, cfg: RunConfig) -> np.ndarray:
    dm = ds.dm
    mt = int(dm.mt)

    est_file = cfg.estimate_file
    pos_it = est_file.rfind("it")
    if pos_it < 0:
        raise SystemExit(
            f"FATAL  : --estimate-file must contain an 'it_<k>' tag "
            f"(reference src/main_meth_probit.cpp:204-209): {est_file!r}"
        )
    pred_file = est_file[:pos_it] + ".yhat"

    xp = np.zeros(dm.m_pad)
    xp[:mt] = read_bin_slab(est_file, mt) * np.sqrt(float(cfg.N_test))
    z = ax(dm, torch.as_tensor(xp).to(device=dm.device, dtype=dm.wd))
    z = z.cpu().numpy().astype(np.float64)

    with open(pred_file, "w") as f:
        for v in z:
            f.write(f"{v:g}\n")
    return z
