#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch port once, on the cards of
this machine, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  `--trace 0` prints the cell's end-to-end
metrics; `--trace 1` runs the same window under torch.profiler and prints
its per-layer metrics, the card's busy and window seconds and a breakdown.
Both check the fits against the plain reference (benchmark/check.py) and
print each compared number beside its limit, last on standard error and
under "checks", last in the result line.  Without enough CUDA cards the run
exits 2 and prints no result.  See benchmark/cell.py for what a run does.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout's root, not this directory (trace.py is no stdlib trace)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="draws the design and phenotypes")
    p.add_argument("--seconds", type=float, required=True, help="length of the timed window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark import cell
    return cell.main(args, T_START)


if __name__ == "__main__":
    raise SystemExit(main())
