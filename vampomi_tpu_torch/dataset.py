"""Dataset assembly: file → DesignMatrix on one device + phenotype and
covariates (port of vampomi_tpu/dataset.py:24-83, single process).

Loading is host-side numpy: the whole (Mt, N) f64 marker-major `.bin` is
read, quantized (and for int4 packed two codes to a byte) or cast, and
copied to the device once.  The same loader reads the training split
(`--meth-file`, `--N`) and the test split (`--meth-file-test`, `--N-test`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .io.bin_io import read_meth_bin
from .io.phen import Phenotype, read_covariates, read_phen
from .ops.operator import PACKED4_DTYPE, DesignMatrix, build_design


class Dataset(NamedTuple):
    dm: DesignMatrix
    phen: Phenotype
    covariates: np.ndarray | None
    # per-marker dequantization scale (length Mt f64) when dm.X holds affine-
    # quantized codes; None for float designs.  The LOO association add-back
    # (modes/association.py pvals_loo) needs it to express the reference's
    # raw-marker coefficient in code space.
    qscale: np.ndarray | None = None


def load_dataset(
    meth_file: str,
    phen_file: str,
    n: int,
    mt: int,
    model: str,
    compute_dtype: torch.dtype,
    device: str | torch.device,
    alpha_scale: float = 1.0,
    cov_file: str = "",
    c: int = 0,
) -> Dataset:
    """Load a (train or test) dataset onto `device`; with `c` > 0 and a
    `cov_file`, also the z-scored (N, c) covariates (io/phen.py)."""
    if compute_dtype == PACKED4_DTYPE and n % 2 != 0:
        raise ValueError(
            f"{meth_file}: the packed int4 design (--compute-dtype int4) holds two "
            f"samples per byte and needs an even sample count, got {n} (--N or "
            "--N-test); use --compute-dtype int8")
    standardize = model != "bin_class"  # reference src/data.cpp:40-43
    phen = read_phen(phen_file, n, standardize=standardize)
    covs = read_covariates(cov_file, c, n) if c > 0 and cov_file else None
    X = read_meth_bin(meth_file, n, mt)
    qinfo: dict = {}
    dm = build_design(X, compute_dtype=compute_dtype, device=device,
                      alpha_scale=alpha_scale, quant_out=qinfo)
    return Dataset(dm=dm, phen=phen, covariates=covs, qscale=qinfo.get("scale"))
