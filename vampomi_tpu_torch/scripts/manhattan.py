# Copied from vampomi_tpu/scripts/manhattan.py (numpy; pandas and matplotlib imported lazily).
"""Manhattan plot of -log10(p) by chromosome, with a Bonferroni line and an
association-count CSV (reference: scripts/manhattan.py).

Probe files: one text file per chromosome, `<probes><chr>.txt`, one probe ID
per line; chromosome sizes define the x-axis segmentation.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Manhattan plot for VAMPomi p-values")
    p.add_argument("-pval", "--pval", required=True)
    p.add_argument("-probes", "--probes", required=True,
                   help="Path prefix; '<probes><chr>.txt' per chromosome")
    p.add_argument("-out_name", "--out-name", required=True)
    p.add_argument("-trait", "--trait", default="")
    p.add_argument("-M", "--M", type=int, required=True)
    p.add_argument("-th", "--th", type=float, default=0.05)
    p.add_argument("--n-chr", type=int, default=22)
    a = p.parse_args(argv)

    import pandas as pd

    dirpath = os.path.dirname(a.pval)

    m_per_chr = []
    total = 0
    for c in range(a.n_chr):
        df = pd.read_csv(a.probes + str(c + 1) + ".txt", header=None)
        m_per_chr.append(len(df[0]))
        total += m_per_chr[-1]
    if total != a.M:
        raise Exception(
            "Number of markers specified %d is not same as in probes file %d!" % (a.M, total)
        )

    pvals = np.fromfile(a.pval, dtype="<f8", count=a.M)
    pval_th = a.th / a.M

    # saturate exact zeros at the smallest positive value
    pvals_sat = pvals.copy()
    if (pvals_sat > 0).any():
        pvals_sat[pvals_sat <= 0] = pvals_sat[pvals_sat > 0].min()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(12, 8), dpi=300)
    plt.plot([0, a.M], [-np.log10(pval_th)] * 2, "k--")
    plt.xlabel("Chromosome", fontsize=22)
    plt.ylabel(r"$-log_{10}(p)$", fontsize=22)
    plt.title("VAMPomi - %s" % a.trait, fontsize=26)

    centers, ticks = [], []
    js = 0
    for c, mc in enumerate(m_per_chr):
        je = js + mc
        plt.scatter(x=np.arange(js, je), y=-np.log10(pvals_sat[js:je]), s=6)
        ticks.append("" if c % 2 == 0 else str(c + 1))
        centers.append(js + round(mc / 2))
        js = je
    plt.xticks(centers, ticks, fontsize=15)
    plt.yticks(fontsize=15)

    fout = os.path.join(dirpath, a.out_name + ".png")
    plt.savefig(fout)
    print("...saved manhattan figure to", fout)

    n_assoc = int((pvals <= pval_th).sum())
    print("| Number of associations | %d" % n_assoc)

    fout_csv = os.path.join(dirpath, a.out_name + ".csv")
    with open(fout_csv, "w", newline="") as f:
        csv.writer(f, delimiter="\t").writerow([n_assoc])
    print("...saved metrics to", fout_csv)
    return n_assoc


if __name__ == "__main__":
    main()
