#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from: the
program's compared numbers over many seeds, and the control's (the
reference computed in TF32, in the program's place) on some of them, at
the cell's own size, on the card, by the model's reference
(benchmark/models/<model>.py).

    python3 benchmark/calibrate.py --workloads C1[,C2...] --seeds S1,S2,... \\
        [--control-seeds S1,S2,S3] [--fits 2]

The cells share one design and model (markers, samples, codes, model):
each seed's design is drawn once and each cell fits it `--fits` times
through the timed path (cell.fit), as a run's window does.  Per seed and
cell one JSON line: the program's compared numbers (the model's readings)
and its largest row gap in each compared iteration, and on a control seed
the control's, with each fit's seconds.  The benchmark's own runs never run
this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workloads", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fits", type=int, default=2)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from benchmark import cell, check, spec
    cells = [spec.cell(w) for w in args.workloads.split(",")]
    shape = {(c.config["markers"], c.config["samples"], c.config["codes"], c.config["model"])
             for c in cells}
    if len(shape) != 1:
        raise SystemExit("calibrate: the cells do not share one design and model")
    device = cell.require_cards(1)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        setup = cell.prepare(cells[0], seed, device)
        t_setup = time.perf_counter() - t0
        runs = []
        for c in cells:
            s = setup._replace(cell=c)
            t1 = time.perf_counter()
            fits = [cell.fit(s, i) for i in range(args.fits)]
            runs.append((c, fits, time.perf_counter() - t1))
        model = setup.model
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        ref = model.Reference(setup.codes, setup.packed)
        t_ref = time.perf_counter() - t2
        ctl = model.Reference(setup.codes, setup.packed, "tf32") if seed in controls else None
        for c, fits, t_fits in runs:
            good = [f for f in fits if f.ok]
            k = int(c.limits["head_iterations"])
            inputs = [f.inputs for f in good]
            answers = [model.answer_of(f.result) for f in good]
            t3 = time.perf_counter()
            follow = ref.fits(inputs, c.config, k)
            out = {"cell": c.name, "seed": seed, "ok": [f.ok for f in fits],
                   "errors": [f.error for f in fits if f.error],
                   "program": model.readings(answers, inputs, ref, c.config, k, follow),
                   "per_iteration": check.per_iteration(answers, follow, k),
                   "x1_corr": [np.round(a.rows[:, 1], 4).tolist() for a in answers],
                   "fit_s": [round(sum(f.result.iter_seconds) + sum(
                       v for key, v in f.result.setup.items()
                       if key in ("aty", "gram", "eigh")), 3) for f in good],
                   "iter_ms": [[round(1e3 * x, 1) for x in f.result.iter_seconds[:8]]
                               for f in good],
                   "seconds": {"setup": t_setup, "fits": t_fits, "gram_eigh": t_ref,
                               "check": time.perf_counter() - t3}}
            if ctl is not None:
                t4 = time.perf_counter()
                control = ctl.fits(inputs, c.config, k)
                out["control"] = model.readings(control, inputs, ref, c.config, k, follow)
                out["control_per_iteration"] = check.per_iteration(control, follow, k)
                out["seconds"]["control"] = time.perf_counter() - t4
            print(json.dumps(out), flush=True)
        del setup, s, runs, ref, ctl
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
