"""What a cell is, read from BENCHMARK.json and the files it names.

Every item sits in files of its own, found by its name:

  * a configuration: the `file` its BENCHMARK.json entry names
    (benchmark/configs/<config>.json): the model, the design's shape, its
    codes, the iterations of a fit, the run settings, and where it comes
    from;
  * a model, the one a configuration's `model` key names:
    benchmark/models/<model>.py, which holds all that a run does that
    depends on the model (see `model`);
  * a traffic mix: benchmark/traffic/<traffic>.json: the solver, the
    phenotype recipe and the size of the pool (the iterations of a fit are
    the configuration's);
  * a cell's correctness limits: benchmark/limits/<cell>.json;
  * a per-layer metric: its reader, benchmark/metrics/<metric>.py;
  * a kernel that reads the design: benchmark/kernels/<kernel>.json.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MODELS = HERE / "models"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration's file
    traffic: dict       # the traffic mix's file
    limits: dict        # the cell's correctness limits
    end_to_end: list    # the BENCHMARK.json entries of the cell's end-to-end metrics
    per_layer: list     # those of its per-layer metrics


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str) -> Cell:
    bench = _load(ROOT / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=_load(ROOT / conf["file"]),
        traffic=_load(HERE / "traffic" / f"{work['traffic']}.json"),
        limits=_load(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, name)],
    )


def _module(package: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{package}." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read(run)` function of benchmark/metrics/<metric>.py."""
    return _module("metrics", HERE / "metrics" / f"{metric}.py").read


def model(name: str):
    """The module MODELS/<name>.py of the model `name`.  It holds:

      * the phenotype pool: `phenotype(codes, packed, n, seed, index,
        config, traffic)`, item `index` of the pool of run `seed` on the
        design of `codes`, which holds what the fit and the reference are
        given;
      * the fit: `inputs(item, probe_seed, traffic)`, what the reference is
        given of a fit, and `fit(dm, item, iterations, probe_seed, config,
        traffic)`, the one call into the port's entry point for the model,
        which returns the engine's result;
      * the result reader: `answer_of(result)`, the result as the
        reference's answer, and `finite_and_whole(result, iterations)`;
      * the reference: `Reference(codes, packed, precision)` with
        `fits(inputs, config, k)` and `tail(answer, inputs)`, and
        `readings(answers, inputs, ref, config, k, follow=None)`, the
        compared numbers that the cell's limits file names.
    """
    return _module("models", MODELS / f"{name}.py")


def xpass_kernels() -> list[dict]:
    """Every kernel pattern file: {"match": [substrings that the kernel's
    name holds, all of them], "x_reads": passes over the design a launch
    makes}."""
    return [_load(p) for p in sorted((HERE / "kernels").glob("*.json"))]
