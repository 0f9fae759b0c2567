# Copied from vampomi_tpu/scripts/r2.py (numpy; sklearn imported lazily).
"""Offline R2 of a `.yhat` prediction file against a PLINK `.phen` file
(reference: scripts/r2.py)."""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Calculate R2 metric")
    p.add_argument("-est", "--est", required=True, help="Path to y estimates file")
    p.add_argument("-true", "--true", required=True, help="Path to true phen file")
    a = p.parse_args(argv)

    def load_col(path, col):
        vals = []
        with open(path) as f:
            for row in f:
                toks = row.split()
                if toks:
                    vals.append(float(toks[col]))
        return np.array(vals)

    y_est = load_col(a.est, 0)
    y_true = load_col(a.true, 2)

    from sklearn.metrics import r2_score

    r2 = r2_score(y_true, y_est)
    print("R2 = %0.4f" % r2, flush=True)
    return r2


if __name__ == "__main__":
    main()
