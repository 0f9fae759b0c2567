"""Dataset assembly: file → DesignMatrix on one device + phenotype and
covariates (port of vampomi_tpu/dataset.py:24-133).

The (Mt, N) f64 marker-major `.bin` is streamed to the device in chunks of
CHUNK_BYTES of file: each chunk's rows are read by one pread of the native
runtime (io/bin_io.py read_meth_bin), quantized (and for int4 packed two
codes to a byte) or cast by ops/operator.py design_rows, the function
build_design applies to the whole matrix, and copied into their rows of a
design tensor allocated once on the device.  Every quantizer and statistic
is per marker, so the design is build_design's bit for bit, and host memory
holds a few chunks whatever Mt is (the whole f64 matrix and its
quantization temporaries would be several times the file).  INGEST_THREADS
chunks are read and processed at once on a thread pool (the pread and
numpy's loops release the interpreter lock); the calling thread copies
each finished chunk to the device in file order.

With a shard (sharding.py) a rank streams only its slab of rows [lo, hi),
and the quantization scales are all-gathered to the global Mt vector
(vampomi_tpu/dataset.py:119-131).  The same loader reads the training split
(`--meth-file`, `--N`) and the test split (`--meth-file-test`, `--N-test`).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .io.bin_io import check_meth_size, read_meth_bin
from .io.phen import Phenotype, read_covariates, read_phen
from .ops.operator import PACKED4_DTYPE, QUANTIZED, DesignMatrix, assemble, design_rows
from .sharding import Shard, gather_m

# f64 bytes of the meth file in one chunk of the streamed ingest (at least
# one marker row a chunk)
CHUNK_BYTES = 16 << 20
# chunks read and processed at once; each holds a few chunk-sized f64
# temporaries while it is quantized
INGEST_THREADS = 6


class Dataset(NamedTuple):
    dm: DesignMatrix
    phen: Phenotype
    covariates: np.ndarray | None
    # per-marker dequantization scale (length Mt f64) when dm.X holds affine-
    # quantized codes; None for float designs.  The LOO association add-back
    # (modes/association.py pvals_loo) needs it to express the reference's
    # raw-marker coefficient in code space.
    qscale: np.ndarray | None = None


def stream_design(meth_file: str, n: int, m: int, start: int, compute_dtype: torch.dtype,
                  device: torch.device, alpha_scale: float = 1.0,
                  shard: Shard | None = None) -> tuple[DesignMatrix, np.ndarray | None]:
    """The design of markers [start, start + m) of `meth_file` on `device`,
    streamed in chunks (module docstring), and for a quantized design the
    f64 scale of each of its m rows (else None): build_design's design and
    quant_out["scale"] for read_meth_bin(meth_file, n, m, start), bit for
    bit."""
    check_meth_size(meth_file, n, m, start)  # the whole slab, before any work
    rows = max(1, min(m, CHUNK_BYTES // (8 * n)))
    width = n // 2 if compute_dtype == PACKED4_DTYPE else n
    X = torch.empty((m, width), dtype=compute_dtype, device=device)
    mave, msig = np.empty(m), np.empty(m)
    scale = np.empty(m) if compute_dtype in QUANTIZED else None

    def chunk(lo: int):
        raw = read_meth_bin(meth_file, n, min(m, lo + rows) - lo, start_marker=start + lo)
        return design_rows(raw, compute_dtype, alpha_scale)

    todo = iter(range(0, m, rows))
    with ThreadPoolExecutor(INGEST_THREADS) as pool:
        # range first: zip would draw one chunk too many from todo and drop it
        pending = deque((lo, pool.submit(chunk, lo)) for _, lo in
                        zip(range(INGEST_THREADS + 1), todo))
        while pending:
            lo, fut = pending.popleft()
            Xc, mv, ms, qs, _ = fut.result()
            nxt = next(todo, None)
            if nxt is not None:
                pending.append((nxt, pool.submit(chunk, nxt)))
            hi = lo + Xc.shape[0]
            X[lo:hi].copy_(Xc)
            mave[lo:hi], msig[lo:hi] = mv, ms
            if scale is not None:
                scale[lo:hi] = qs
    return assemble(X, mave, msig, n, device, shard), scale


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
    lo, hi = (0, mt) if shard is None else (shard.lo, shard.hi)
    dm, qscale = stream_design(meth_file, n, hi - lo, lo, compute_dtype, torch.device(device),
                               alpha_scale, shard)
    if qscale is not None and shard is not None:
        qscale = gather_m(torch.as_tensor(qscale), shard).numpy()
    return Dataset(dm=dm, phen=phen, covariates=covs, qscale=qscale)
