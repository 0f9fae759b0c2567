"""Dataset assembly: file → DesignMatrix on one device + phenotype and
covariates (port of vampomi_tpu/dataset.py:24-133).

Loading is host-side numpy: the (Mt, N) f64 marker-major `.bin` is read,
quantized row by row (and for int4 packed two codes to a byte) or cast, and
copied to the device once.  With a shard (sharding.py) a rank reads only its
slab of rows [lo, hi), and the quantization scales are all-gathered to the
global Mt vector (vampomi_tpu/dataset.py:119-131).  The same loader reads
the training split (`--meth-file`, `--N`) and the test split
(`--meth-file-test`, `--N-test`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .io.bin_io import read_meth_bin
from .io.phen import Phenotype, read_covariates, read_phen
from .ops.operator import PACKED4_DTYPE, DesignMatrix, build_design
from .sharding import Shard, gather_m


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
    shard: Shard | None = None,
) -> Dataset:
    """Load a (train or test) dataset onto `device`; with `c` > 0 and a
    `cov_file`, also the z-scored (N, c) covariates (io/phen.py).  With a
    `shard`, the design holds the rank's slab of markers and `qscale` is
    global, the same on every rank."""
    if compute_dtype == PACKED4_DTYPE and n % 2 != 0:
        raise ValueError(
            f"{meth_file}: the packed int4 design (--compute-dtype int4) holds two "
            f"samples per byte and needs an even sample count, got {n} (--N or "
            "--N-test); use --compute-dtype int8")
    standardize = model != "bin_class"  # reference src/data.cpp:40-43
    phen = read_phen(phen_file, n, standardize=standardize)
    covs = read_covariates(cov_file, c, n) if c > 0 and cov_file else None
    if shard is None:
        X = read_meth_bin(meth_file, n, mt)
    else:
        X = read_meth_bin(meth_file, n, shard.hi - shard.lo, start_marker=shard.lo)
    qinfo: dict = {}
    dm = build_design(X, compute_dtype=compute_dtype, device=device,
                      alpha_scale=alpha_scale, quant_out=qinfo, shard=shard)
    qscale = qinfo.get("scale")
    if qscale is not None and shard is not None:
        qscale = gather_m(torch.as_tensor(qscale), shard).numpy()
    return Dataset(dm=dm, phen=phen, covariates=covs, qscale=qscale)
