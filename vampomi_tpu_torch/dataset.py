"""Dataset assembly: file → DesignMatrix on one device + phenotype (port of
vampomi_tpu/dataset.py:24-83, single process).

Loading is host-side numpy: the whole (Mt, N) f64 marker-major `.bin` is
read, quantized or cast, and copied to the device once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .io.bin_io import read_meth_bin
from .io.phen import Phenotype, read_phen
from .ops.operator import DesignMatrix, build_design


class Dataset(NamedTuple):
    dm: DesignMatrix
    phen: Phenotype
    covariates: np.ndarray | None


def load_dataset(
    meth_file: str,
    phen_file: str,
    n: int,
    mt: int,
    model: str,
    compute_dtype: torch.dtype,
    device: str | torch.device,
    alpha_scale: float = 1.0,
) -> Dataset:
    """Load a (train or test) dataset onto `device`."""
    standardize = model != "bin_class"  # reference src/data.cpp:40-43
    phen = read_phen(phen_file, n, standardize=standardize)
    X = read_meth_bin(meth_file, n, mt)
    dm = build_design(X, compute_dtype=compute_dtype, device=device,
                      alpha_scale=alpha_scale)
    return Dataset(dm=dm, phen=phen, covariates=None)
