# Copied from vampomi_tpu/sim/data_sim.py.
"""i.i.d. Gaussian fixture generator (reference: simulation/data_sim.py).

Produces the reference's exact file formats:
  * `<name>.bin`    — marker-major (M blocks of N float64) design matrix
  * `<name>.phen`   — PLINK text rows "FID IID value" (%.10f)
  * `<name>_ts.bin` — M float64 true effects

Model: X ~ N(0,1)^{N×M}; CM = floor(M·lam) causal markers with effects
~ N(0, h2/CM); y = X beta + N(0, 1-h2) (reference data_sim.py:35-47).
"""

from __future__ import annotations

import argparse
import os
from typing import NamedTuple

import numpy as np


class Fixture(NamedTuple):
    X: np.ndarray      # (N, M) sample-major
    beta: np.ndarray   # (M,)
    y: np.ndarray      # (N,)


def simulate_iid(
    n: int, m: int, lam: float = 0.1, h2: float = 0.8, seed: int | None = None
) -> Fixture:
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, size=(n, m))
    cm = int(m * lam)
    sigma2 = h2 / cm
    idx = rng.choice(m, size=cm, replace=False)
    beta = np.zeros(m)
    beta[idx] = rng.normal(0.0, np.sqrt(sigma2), cm)
    g = X @ beta
    y = g + rng.normal(0.0, np.sqrt(1.0 - h2), n)
    return Fixture(X=X, beta=beta, y=y)


def write_fixture(fx: Fixture, out_dir: str, out_name: str = "example") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    n, m = fx.X.shape
    paths = {
        "bin": os.path.join(out_dir, f"{out_name}.bin"),
        "phen": os.path.join(out_dir, f"{out_name}.phen"),
        "ts": os.path.join(out_dir, f"{out_name}_ts.bin"),
    }
    # marker-major layout (reference data_sim.py:58: X.transpose().ravel())
    np.ascontiguousarray(fx.X.T, dtype="<f8").tofile(paths["bin"])
    with open(paths["phen"], "w") as f:
        for i, v in enumerate(fx.y):
            f.write("%d %d %0.10f\n" % (i, i, v))
    np.ascontiguousarray(fx.beta, dtype="<f8").tofile(paths["ts"])
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description="Simulate example i.i.d. data")
    p.add_argument("-out_dir", "--out-dir", required=True)
    p.add_argument("-out_name", "--out-name", default="example")
    p.add_argument("-N", "--N", type=int, default=1000)
    p.add_argument("-M", "--M", type=int, default=2000)
    p.add_argument("-lam", "--lam", type=float, default=0.1)
    p.add_argument("-h2", "--h2", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=None)
    a = p.parse_args(argv)
    fx = simulate_iid(a.N, a.M, a.lam, a.h2, a.seed)
    paths = write_fixture(fx, a.out_dir, a.out_name)
    print("Var(y) =", np.var(fx.y))
    g = fx.X @ fx.beta
    print("h2 =", np.var(g) / np.var(fx.y))
    for k, v in paths.items():
        print(k, v)


if __name__ == "__main__":
    main()
