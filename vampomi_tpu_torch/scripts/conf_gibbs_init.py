# Copied from vampomi_tpu/scripts/conf_gibbs_init.py (numpy only; the port imports no JAX).
"""Warm-start configuration from a GMRMomi Gibbs-sampler CSV: average the
mixture probabilities / h2 over an iteration window and emit a tab-separated
`.conf` consumed by run scripts (reference: scripts/conf_gibbs_init.py,
README.md:170-213)."""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def get_probs(L: int, lam: float):
    """Geometric slab-prob ladder summing to 1 with spike prob 1-lam
    (reference conf_gibbs_init.py:6-22)."""
    probs = [1 - lam]
    while len(probs) <= (L - 1):
        prob = np.round(1 - sum(probs), 10)
        if len(probs) == (L - 1):
            probs.append(prob)
        else:
            probs.append(prob / 2)
    if np.round(sum(probs), 10) != 1:
        raise Exception("Sum of probs should be 1!")
    return probs, ",".join("%0.10f" % p for p in probs)


def get_vars(L: int, var_max: float = 0.1):
    """Decade ladder of slab variances up to var_max, spike at 0
    (reference conf_gibbs_init.py:24-34)."""
    vars_ = [0.0]
    var = (10 * var_max) / (10 ** (L - 1))
    while len(vars_) <= (L - 1):
        vars_.append(var)
        var = var * 10
    return vars_, ",".join("%0.12f" % v for v in vars_)


def main(argv=None):
    p = argparse.ArgumentParser(description="Gibbs warm-start .conf from GMRMomi CSV")
    p.add_argument("-csv", "--csv", required=True)
    p.add_argument("-grm", "--grm", default="", help="Path to group mixtures file")
    p.add_argument("-out_dir", "--out-dir", default="")
    p.add_argument("-iterations", "--iterations", default="100:200")
    p.add_argument("-rho", "--rho", type=float, default=0.5)
    a = p.parse_args(argv)

    start, end = (int(v) for v in a.iterations.split(":"))
    base = os.path.basename(a.csv).split(".")[0]

    h2, mincl, probs = [], [], []
    L = 0
    with open(a.csv) as f:
        for row in csv.reader(f):
            h2.append(float(row[4]))
            mincl.append(float(row[5]))
            L = int(row[7])
            probs.append([float(row[8 + i]) for i in range(L)])

    h2 = np.array(h2[start:end])
    mincl = np.array(mincl[start:end])
    probs = np.array(probs[start:end])

    if a.grm:
        with open(a.grm) as f:
            vars_ = [float(m) for m in f.readline().split(" ")]
        vars_str = ",".join("%0.12f" % v for v in vars_)
    else:
        # no group-mixtures file: fall back to the decade variance ladder
        # (the reference declares -grm optional but crashes without it and
        # leaves its get_vars fallback dead; wire the evident intent)
        _, vars_str = get_vars(L)

    prob_means = probs.mean(axis=0)
    lam = 1.0 - prob_means[0]
    h2_mean = float(h2.mean())
    probs_str = ",".join("%0.12f" % p for p in prob_means)

    print("h2 = %0.4f" % h2_mean)
    print("Incl. markers = %d" % mincl.mean())
    print("lam = %0.4f" % lam)

    fout = os.path.join(a.out_dir, base + ".conf")
    with open(fout, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["ID", "rho", "mix_comp", "lambda", "probs", "vars", "h2"])
        w.writerow([0, a.rho, L, lam, probs_str, vars_str, h2_mean])
    print("...saved", fout)
    return fout


if __name__ == "__main__":
    main()
