"""The linear model as the reference's CLI runs it: what a run of a
configuration with `"model": "linear_dumps"` does that depends on the
model.

The pool, the inputs, the result's answer and the reference's first
iterations are the linear model's (benchmark/models/linear.py).

The fit: the same call of the port's entry, `vampomi_tpu_torch.engine.
linear.infere_linear(dm, y, cfg, true_signal=beta, write_outputs=True)`,
with the configuration's `out_dir` (under the checkout) and `out_name`:
every iteration's x1_hat/sqrt(N) and r1/sqrt(N) as `<out>_it_<k>.bin` and
`<out>_r1_it_<k>.bin` (src/vamp.cpp:234-252), the metrics, params and
prior CSVs and the port's trace file.  Each fit overwrites the last fit's
files, as a user's rerun under one --out-name does, and a run's first fit
(the set-up's) removes those of an earlier run, so a run leaves one fit's
files behind.

A fit is whole when the linear model's is, each of its .bin files holds
8 Mt bytes, and its metrics CSV holds the rows the fit returned, laid out
as the reference's positional writer lays them (row k at k times its own
length, so a value wider than its 20 characters shifts its row, and a line
count does not count the rows): stat calls and one read of the CSV's few
KiB; no .bin file is read back while the window runs.

The compared numbers: the linear model's (`head_gap`, `tail_gap`), and of
the files that the run's last fit left on disk, read after the window:

  * `dump_gap`: the largest relative L2 distance ||file - reference|| /
    ||reference|| over iterations j = 1..k (k the limits file's
    `head_iterations`) of the x1 file of iteration j against the
    reference's x1/sqrt(N) after j iterations, and of the r1 file of
    iteration j against its r1/sqrt(N) after j - 1 (the r1 that iteration
    j denoised); a distance to a zero vector is the file's norm.
  * `dump_last`: the largest |difference| between the x1 file of the last
    iteration and the x1_hat_scaled the fit returned; both are the same
    float32 x1 divided by sqrt(N) in float64.

The control (`Reference(..., "tf32")`) puts its own iterations in the
files' place: its `fits` gives the last fit it is given the vectors of
each of its first k iterations, which `readings` then compares instead of
the files.

The module is loaded anew for each run (spec.model); `_run` holds what
the run's fits left on disk.
"""

from __future__ import annotations

import glob
import os
from typing import NamedTuple

import numpy as np
import torch

from benchmark import spec
from benchmark.models import linear
from benchmark.models.linear import Inputs, Phenotype, answer_of, inputs, phenotype  # noqa: F401
from benchmark.reference import gvamp


class Dumped(NamedTuple):
    """A fit whose files are on disk."""
    base: str            # <out_dir>/<out_name>
    iterations: int
    inputs: Inputs
    x1: np.ndarray       # the x1_hat_scaled it returned


# the run's state: whether its files have been cleared, and its last fit
_run = {"cleared": False, "last": None}


def out_of(config: dict) -> tuple[str, str]:
    """(out_dir, out_name) of the configuration; out_dir under the
    checkout where it is relative."""
    return str(spec.ROOT / config["out_dir"]), config["out_name"]


def bin_file(base: str, k: int, kind: str = "") -> str:
    """The engine's name of iteration k's x1 (kind "") or r1 ("r1_")
    file (io/bin_io.py iteration_file)."""
    return f"{base}_{kind}it_{k}.bin"


def fit(dm, ph: Phenotype, iterations: int, probe_seed: int, config: dict, traffic: dict):
    """The engine's LinearResult of a fit of `ph` on the DesignMatrix `dm`,
    its outputs written."""
    from vampomi_tpu_torch.config import RunConfig
    from vampomi_tpu_torch.engine.linear import infere_linear
    out_dir, out_name = out_of(config)
    if not _run["cleared"]:
        os.makedirs(out_dir, exist_ok=True)
        for path in glob.glob(os.path.join(glob.escape(out_dir), glob.escape(out_name) + "_*")):
            os.remove(path)
        _run["cleared"] = True
    _run["last"] = None
    cfg = RunConfig(iterations=iterations, lmmse_solver=traffic["lmmse_solver"],
                    device=str(dm.device), seed=probe_seed, probs=ph.probs,
                    vars=ph.vars, out_dir=out_dir, out_name=out_name, **config["run_config"])
    res = infere_linear(dm, ph.y, cfg, true_signal=ph.beta, write_outputs=True)
    _run["last"] = Dumped(base=os.path.join(out_dir, out_name), iterations=iterations,
                          inputs=inputs(ph, probe_seed, traffic), x1=res.x1_hat_scaled)
    return res


def positional_csv(header: list, rows) -> bytes:
    """The bytes of a positional CSV of `rows` (io/csv_writer.py, the
    reference's src/utilities.cpp:366-401): the header at 0, row k
    ("%5d" and ", %20.15f" a value) at k times its own length, NULs in the
    gaps, a later row over an earlier one where they overlap."""
    out = bytearray((", ".join(header) + "\n").encode())
    for k, values in enumerate(rows, start=1):
        row = ("%5d" % k + "".join(", %20.15f" % float(v) for v in values) + "\n").encode()
        at = k * len(row)
        out.extend(b"\0" * (at - len(out)))
        out[at:at + len(row)] = row
    return bytes(out)


def finite_and_whole(res, iterations: int) -> bool:
    """The linear model's test, and the last fit's files all there: each
    .bin file of its iterations 8 Mt bytes, and the metrics CSV that of
    its rows."""
    from vampomi_tpu_torch.engine.linear import METRICS_HEADER
    last = _run["last"]
    if last is None or not linear.finite_and_whole(res, iterations):
        return False
    want = 8 * len(res.x1_hat_scaled)
    try:
        sizes = [os.stat(bin_file(last.base, k, kind)).st_size
                 for k in range(1, iterations + 1) for kind in ("", "r1_")]
        with open(last.base + "_metrics.csv", "rb") as f:
            csv = f.read()
    except FileNotFoundError:
        return False
    return (all(s == want for s in sizes)
            and csv == positional_csv(METRICS_HEADER, res.metrics_history))


class Answer(NamedTuple):
    """The reference's Answer with the vectors that the files of its
    first k iterations would hold: [(x1, r1) of iteration j]."""
    rows: list
    x1: torch.Tensor
    r1: torch.Tensor
    gam1: float
    gamw: float
    dumps: list


class Reference(linear.Reference):
    """The linear model's reference, which also works out what the files
    of a fit's first iterations hold."""

    def dumps(self, i: Inputs, config: dict, k: int) -> list:
        """[(x1/sqrt(N) after j iterations, r1/sqrt(N) after j - 1)] for
        j = 1..k, from the cold start (r1 = 0 before the first)."""
        runs = [linear.Reference.fits(self, [i], config, j)[0] for j in range(1, k + 1)]
        r1 = [torch.zeros_like(runs[0].r1)] + [a.r1 for a in runs[:-1]]
        return [(a.x1, r) for a, r in zip(runs, r1)]

    def fits(self, inputs: list, config: dict, k: int) -> list:
        """The linear model's, the last with the vectors of its first k
        iterations: the control's in the files' place."""
        out = super().fits(inputs, config, k)
        if out:
            out[-1] = Answer(*out[-1], dumps=self.dumps(inputs[-1], config, k))
        return out


def _read(path: str) -> torch.Tensor:
    return torch.from_numpy(np.fromfile(path, dtype="<f8"))


def _distance(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, or ||a|| where b is zero; a file of another
    length than b is infinitely far."""
    a, b = a.double().cpu(), b.double().cpu()
    if a.shape != b.shape:
        return float("inf")
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / (den if den > 0 else 1.0)


def readings(answers: list, inputs: list, ref: Reference, config: dict, k: int,
             follow: list | None = None) -> dict:
    """The linear model's compared numbers of `answers` (program's or
    control's), and `dump_gap` and `dump_last` of the run's last fit's
    files, or `dump_gap` of the control's own iterations where the last
    answer carries them."""
    if follow is None:
        follow = linear.Reference.fits(ref, inputs, config, k)
    out = linear.readings(answers, inputs, ref, config, k, follow)
    carried = getattr(answers[-1], "dumps", None)
    if carried is not None:
        got, i = carried, inputs[-1]
    else:
        last = _run["last"]
        if last is None:  # the last fit raised: no numbers of its files, so not correct
            return out
        try:
            got = [(_read(bin_file(last.base, j)), _read(bin_file(last.base, j, "r1_")))
                   for j in range(1, k + 1)]
            end = _read(bin_file(last.base, last.iterations)).numpy()
        except FileNotFoundError:
            return out
        i = last.inputs
        out["dump_last"] = (float(np.max(np.abs(end - last.x1)))
                            if end.shape == last.x1.shape else float("inf"))
    want = ref.dumps(i, config, k)
    out["dump_gap"] = max(max(_distance(gx, wx), _distance(gr, wr))
                          for (gx, gr), (wx, wr) in zip(got, want))
    return out
