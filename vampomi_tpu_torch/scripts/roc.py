# Copied from vampomi_tpu/scripts/roc.py (numpy; sklearn and matplotlib imported lazily).
"""ROC / AUC / FDR / TPR of association p-values against the true signal
support (reference: scripts/roc.py)."""

from __future__ import annotations

import argparse
import os

import numpy as np

EPS = 1e-32


def roc_metrics(pvals: np.ndarray, beta: np.ndarray, th: float = 0.05):
    from sklearn.metrics import auc, confusion_matrix, roc_curve

    m = len(pvals)
    true = (np.abs(beta) > 0).astype(float)
    fprs, tprs, _ = roc_curve(true, 1.0 - pvals)
    area = auc(fprs, tprs)

    pval_th = th / m
    est = (pvals < pval_th).astype(float)
    # labels pinned so single-class inputs (null simulations, no discoveries)
    # still yield a 2x2 matrix instead of an unpack crash
    tn, fp, fn, tp = confusion_matrix(true, est, labels=[0.0, 1.0]).ravel()
    fdr = fp / (fp + tp + EPS)
    tpr = tp / (tp + fn + EPS)
    n_causal = int(est.sum())  # same `<` threshold as the confusion matrix
    return dict(auc=area, fdr=fdr, tpr=tpr, n_causal=n_causal, fprs=fprs, tprs=tprs)


def main(argv=None):
    p = argparse.ArgumentParser(description="ROC curve for VAMPomi p-values")
    p.add_argument("-pval", "--pval", required=True)
    p.add_argument("-true_signal", "--true-signal", required=True)
    p.add_argument("-out_name", "--out-name", required=True)
    p.add_argument("-it", "--it", type=int, default=35)
    p.add_argument("-M", "--M", type=int, required=True)
    p.add_argument("-th", "--th", type=float, default=0.05)
    a = p.parse_args(argv)

    beta = np.fromfile(a.true_signal, dtype="<f8", count=a.M)
    pvals = np.fromfile(a.pval, dtype="<f8", count=a.M)
    r = roc_metrics(pvals, beta, a.th)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.plot([0, 1], [0, 1], "k--")
    plt.xlabel("False Positive Rate")
    plt.ylabel("True Positive Rate")
    plt.plot(r["fprs"], r["tprs"], label=a.it)
    plt.legend()
    out = os.path.join(os.path.dirname(a.pval), a.out_name + ".png")
    plt.savefig(out)
    print("...saved ROC figure to", out)

    print("-" * 62)
    print("| %3s | %25s | %6s | %6s | %6s |" % ("It.", "Number of causal markers", "AUC", "FDR", "TPR"))
    print("-" * 62)
    print("| %3d | %25d | %6.4f | %6.4f | %6.4f |" % (a.it, r["n_causal"], r["auc"], r["fdr"], r["tpr"]))
    print("-" * 62)
    return r


if __name__ == "__main__":
    main()
