# Copied from vampomi_tpu/scripts/metrics.py (the port's io/csv_writer; matplotlib imported lazily).
"""Convergence report + 3-panel figure (R2 curves, gamw, gam1) from the
run's CSV outputs, plus h2 = 1 - 1/gamw (reference: scripts/metrics.py)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.csv_writer import read_positional_csv


def main(argv=None):
    p = argparse.ArgumentParser(description="Plot VAMPomi metrics and parameters")
    p.add_argument("-csv_metrics", "--csv-metrics", required=True)
    p.add_argument("-csv_test", "--csv-test", required=True)
    p.add_argument("-csv_params", "--csv-params", required=True)
    p.add_argument("-csv_prior", "--csv-prior", required=True)
    p.add_argument("-iterations", "--iterations", type=int, default=35)
    a = p.parse_args(argv)
    it = a.iterations

    base = os.path.basename(a.csv_metrics).split(".")[0]
    dirpath = os.path.dirname(a.csv_metrics)

    test_rows = read_positional_csv(a.csv_test)
    r2_test = np.array([r[1] for r in test_rows])
    corr2_test = np.array([r[2] for r in test_rows])

    met_rows = read_positional_csv(a.csv_metrics)
    r2_denoising = np.array([r[1] for r in met_rows])
    corr_train = np.array([r[2] for r in met_rows])
    r2_lmmse = np.array([r[3] for r in met_rows])

    par_rows = read_positional_csv(a.csv_params)
    gam1 = np.array([r[2] for r in par_rows])
    gamw = np.array([r[5] for r in par_rows])

    prior_rows = read_positional_csv(a.csv_prior)
    lam = np.array([1.0 - r[2] for r in prior_rows]) if prior_rows else np.array([])

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(3, figsize=(12, 10), dpi=300)
    color = plt.rcParams["axes.prop_cycle"].by_key()["color"][0]
    # early-converged runs have fewer rows than --iterations; clip to what
    # the files actually contain so the report never crashes
    it = min(it, len(r2_denoising), len(r2_test), len(gam1), len(gamw))
    x = np.arange(1, it + 1)
    fig.suptitle(base)

    ax[0].plot(x, r2_denoising[:it], color=color, linestyle="--", marker=".", label="Denoising")
    ax[0].plot(x, r2_lmmse[:it], color=color, linestyle=":", marker=".", label="LMMSE")
    ax[0].plot(x, r2_test[:it], color=color, linestyle="-", marker=".", label="Test")
    ax[0].xaxis.set_ticks(x)
    ax[0].set_ylim([0, 1])
    ax[0].set_ylabel("R2")
    ax[0].legend()

    ax[1].plot(x, gamw[:it], color=color, marker=".", label="gamw")
    ax[1].xaxis.set_ticks(x)
    ax[1].set_ylabel("gamw")

    ax[2].plot(x, gam1[:it], color=color, marker=".", label="gam1")
    ax[2].xaxis.set_ticks(x)
    ax[2].set_xlabel("Iteration")
    ax[2].set_ylabel("gam1")

    outf = os.path.join(dirpath, base + ".png")
    fig.savefig(outf)
    print("...saving figure to file", outf)

    h2 = 1.0 - 1.0 / gamw[it - 1]
    header = "| %10s | %13s | %13s | %13s | %13s | %13s | %13s | %13s |" % (
        "Iteration", "R2_test", "Corr2_test", "R2_denoising", "R2_lmmse", "gam1", "gamw", "h2",
    )
    line = "-" * len(header)
    row = "| %10d | %13.4f | %13.4f | %13.4f | %13.4f | %13.4f | %13.4f | %13.4f |" % (
        it, r2_test[it - 1], corr2_test[it - 1], r2_denoising[it - 1],
        r2_lmmse[it - 1], gam1[it - 1], gamw[it - 1], h2,
    )
    print(line); print(header); print(line); print(row); print(line)
    return dict(h2=h2, r2_test=r2_test, gam1=gam1, gamw=gamw, lam=lam,
                corr_train=corr_train, corr2_test=corr2_test)


if __name__ == "__main__":
    main()
