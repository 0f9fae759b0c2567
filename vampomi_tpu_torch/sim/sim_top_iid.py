# Copied from vampomi_tpu/sim/sim_top_iid.py (numpy; zarr_lite from the port's io/).
"""Simulate an i.i.d. phenotype on top of real (pre-standardized) methylation
data stored per-chromosome, streaming one chromosome at a time
(reference: simulation/sim_top_iid.py — the N~1e4 × M~1e6 path).

Inputs: a directory of per-chromosome stores — zarr groups (as in the
reference) or `.npy` files (tests / zarr-free environments), each of shape
(N, M_chr).  Outputs (reference formats):
  * `<name>_{train,test}_....bin`  — marker-major float64 design matrices
  * `<name>_{train,test}_....dim`  — "N M" text
  * `<name>_....msk`               — np.savetxt train mask
  * `<name>_..._beta_true.bin`     — M float64 true effects
  * `<name>_{train,test}_....phen` — PLINK text, standardized y
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _open_store(path: str):
    """Load one chromosome as an (N, M_chr) float array.

    zarr v2 directory stores — the reference's production input format
    (simulation/sim_top_iid.py:8-16) — are read with the zarr package when
    installed, else with the built-in stdlib reader (io/zarr_lite.py, which
    handles null/zlib/gzip-compressed v2 stores).  `.npy` files remain the
    lightweight test format."""
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    try:
        import zarr
    except ImportError:
        from ..io.zarr_lite import open_array

        return open_array(path)
    return zarr.open(path)


def simulate_top(
    store_dir: str,
    out_dir: str,
    dataset_name: str,
    phen_name: str = "sim",
    h2: float = 0.8,
    lam: float = 0.01,
    run: int = 0,
    ratio: float = 0.9,
    m: int | None = None,
    n: int | None = None,
    seed: int | None = None,
) -> dict:
    rng = np.random.default_rng(seed)
    sub = "h2_%d_lam_%d_run_%d" % (h2 * 100, lam * 100, run)
    fname = f"{dataset_name}_{phen_name}_{sub}"
    fname_train = f"{dataset_name}_train_{phen_name}_{sub}"
    fname_test = f"{dataset_name}_test_{phen_name}_{sub}"

    files = sorted(os.listdir(store_dir))
    if not files:
        raise FileNotFoundError(f"no chromosome stores in {store_dir}")

    # train/test split mask over samples
    msk = rng.random(n) < ratio
    n_train = int(msk.sum())
    n_test = int((~msk).sum())
    np.savetxt(os.path.join(out_dir, fname + ".msk"), msk)

    for name, cnt in ((fname_train, n_train), (fname_test, n_test)):
        with open(os.path.join(out_dir, name + ".dim"), "w") as f:
            f.write("%d %d" % (cnt, m))

    # sparse effects
    cm = int(m * lam)
    bvar = 1.0 / cm
    idx = rng.choice(m, size=cm, replace=False)
    beta = np.zeros(m)
    beta[idx] = rng.normal(0.0, np.sqrt(bvar), cm)
    beta.astype("<f8").tofile(os.path.join(out_dir, fname + "_beta_true.bin"))

    g = np.zeros(n)
    mtot = 0
    train_path = os.path.join(out_dir, fname_train + ".bin")
    test_path = os.path.join(out_dir, fname_test + ".bin")
    with open(train_path, "wb") as ftr, open(test_path, "wb") as fte:
        for f in files:
            store = _open_store(os.path.join(store_dir, f))
            ni, mi = store.shape
            if ni != n:
                raise Exception("Number of samples in store and specified do not match!")
            block = np.asarray(store, dtype=np.float64)
            # marker-major slabs per split
            np.ascontiguousarray(block[msk, :].T).astype("<f8").tofile(ftr)
            np.ascontiguousarray(block[~msk, :].T).astype("<f8").tofile(fte)
            g += block @ beta[mtot : mtot + mi]
            mtot += mi
            del store, block
    if mtot != m:
        raise Exception("Number of markers in stores and specified do not match!")

    evar = 1.0 / h2 - 1.0
    y = g + rng.normal(0.0, np.sqrt(evar), n)
    y = (y - y.mean()) / y.std()  # standardized phenotype (reference line 147)

    with open(os.path.join(out_dir, fname_train + ".phen"), "w") as ftr, open(
        os.path.join(out_dir, fname_test + ".phen"), "w"
    ) as fte:
        for i, v in enumerate(y):
            line = "%d %d %0.10f\n" % (i, i, v)
            (ftr if msk[i] else fte).write(line)

    return dict(
        beta=beta, mask=msk, n_train=n_train, n_test=n_test,
        train_bin=train_path, test_bin=test_path,
        fname=fname, fname_train=fname_train, fname_test=fname_test,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description="Simulate iid phenotype on real data")
    p.add_argument("-zarr", "--zarr", required=True, help="Path to per-chromosome stores")
    p.add_argument("-out", "--out", required=True)
    p.add_argument("-phen", "--phen", default="sim")
    p.add_argument("-dataset", "--dataset", required=True)
    p.add_argument("-h2", "--h2", type=float, default=0.8)
    p.add_argument("-lam", "--lam", type=float, default=0.01)
    p.add_argument("-run", "--run", type=int, default=0)
    p.add_argument("-ratio", "--ratio", type=float, default=0.9)
    p.add_argument("-M", "--M", type=int, required=True)
    p.add_argument("-N", "--N", type=int, required=True)
    p.add_argument("--seed", type=int, default=None)
    a = p.parse_args(argv)
    r = simulate_top(
        a.zarr, a.out, a.dataset, a.phen, a.h2, a.lam, a.run, a.ratio, a.M, a.N, a.seed
    )
    print("Number of train samples:", r["n_train"])
    print("Number of test samples:", r["n_test"])


if __name__ == "__main__":
    main()
