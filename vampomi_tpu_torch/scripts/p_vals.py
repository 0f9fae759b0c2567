# Copied from vampomi_tpu/scripts/p_vals.py (the port's io/csv_writer and modes/association.pvals_se; numpy and scipy).
"""Offline SE p-values from a saved r1 vector + the params CSV
(reference: scripts/p_vals.py — an independent cross-check of the
`association_test --pval-method se` run mode).

p_j = Phi(0; loc=r1_j, scale=sqrt(1/(gam1_it * N))), flipped for r1_j <= 0;
gam1 is read from column 2 of `_params.csv` at the target iteration.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.csv_writer import read_positional_csv
from ..modes.association import pvals_se


def main(argv=None):
    p = argparse.ArgumentParser(description="Compute VAMPomi SE p-values")
    p.add_argument("-out_name", "--out-name", required=True)
    p.add_argument("-csv_params", "--csv-params", required=True)
    p.add_argument("-r1_file", "--r1-file", required=True)
    p.add_argument("-it", "--it", type=int, default=35)
    p.add_argument("-th", "--th", type=float, default=0.05)
    p.add_argument("-M", "--M", type=int, required=True)
    p.add_argument("-N", "--N", type=int, required=True)
    a = p.parse_args(argv)

    rows = read_positional_csv(a.csv_params)
    gam1_by_it = {int(r[0]): r[2] for r in rows}
    if a.it not in gam1_by_it:
        raise SystemExit(
            f"FATAL  : iteration {a.it} not found in {a.csv_params} "
            f"(available: {sorted(gam1_by_it)})"
        )
    gam1 = gam1_by_it[a.it]

    r1 = np.fromfile(a.r1_file, dtype="<f8", count=a.M)
    pvals = pvals_se(r1, gam1, a.N)

    out = os.path.join(os.path.dirname(a.csv_params), a.out_name + ".bin")
    pvals.astype("<f8").tofile(out)

    thr = a.th / a.M
    print("-" * 45)
    print("| %3s | %8s | %24s |" % ("It.", "gam1", "Number of causal markers"))
    print("-" * 45)
    print("| %3d | %8.4f | %24d |" % (a.it, gam1, int((pvals <= thr).sum())))
    print("-" * 45)
    print("saved:", out)
    return pvals


if __name__ == "__main__":
    main()
