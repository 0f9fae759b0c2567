"""One run of one cell: set-up, the timed window of fits, the check, the
result line.

A cell fits one planted phenotype after another on one design, as a user
fitting trait after trait does.  What depends on the model is the module
that the configuration's `model` names (benchmark/models/<model>.py,
spec.model): the pool of phenotypes, the fit (one call of the port's entry
for the model, with no files written), the reader of its result, and the
reference and the numbers it compares.  Nothing here names an engine.

Set-up (`setup_s`, from the process's start): CUDA's start, the design
drawn on the card from the seed, the port's DesignMatrix over it, the pool
of phenotypes, and one fit of two iterations (so that the EM update runs)
on the first rows of the design, which loads every kernel the cell's fits
launch (building it on a checkout's first run), cuBLAS and cuSOLVER, at the
cell's N.  The window then starts fit after fit until `seconds` have
passed, and ends when the last fit started ends: `fit_s` is its length over
its fits.  The check then holds a sample of the fits, drawn from the seed,
against the model's reference (check.py).  A traced
run (`--trace 1`) first runs fit 0 under torch.profiler, which gives the
per-layer metrics of the device (xpass_roofline, device_idle) and the
breakdown, and then the window untraced, whose fits give those of the
program's spans (iter_ms, factor_s).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import check, roofline, spec, trace
from .design import draw_codes, subseed

BANNED = ("jax", "jaxlib", "flax", "vampomi_tpu")  # top-level names no run may load
WARMUP_ROWS = 65_536   # rows of the set-up fit's design (at least 4 N: auto picks as at full size)
WARMUP_ITERATIONS = 2
TRACE_FILE = spec.ROOT / "build" / "benchmark" / "fit0.pt.trace.json"


class Setup(NamedTuple):
    dm: object           # the port's DesignMatrix over `codes`
    codes: torch.Tensor
    packed: bool
    m: int
    n: int
    seed: int            # the seed the design, the phenotypes and the probes are drawn from
    cell: spec.Cell
    model: object        # the configuration's model (spec.model)
    pool: list           # the planted phenotypes (the model's `phenotype`)
    order: list          # the pool's indices in the order the fits take them


class Fit(NamedTuple):
    inputs: object       # what the fit was given, and so the reference too (the model's `inputs`)
    result: object       # the engine's result, None where the fit raised
    ok: bool             # no raise, finite, all iterations
    error: str = ""      # what a fit that raised raised


class Run(NamedTuple):
    """What a per-layer metric's reader reads."""
    fits: list           # Fit of every untraced fit of the window
    events: list | None  # the Chrome trace events of the traced fit
    kernels: list        # the kernel pattern files (spec.xpass_kernels)
    x_bytes: int         # bytes of the stored design: one pass reads them
    busy_s: float | None
    window_s: float | None


def require_cards(chips: int) -> torch.device:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        raise SystemExit(2)
    from vampomi_tpu_torch.config import resolve_device
    return resolve_device("cuda")


def _design(codes: torch.Tensor, packed: bool):
    from vampomi_tpu_torch.ops.operator import design_from_codes, design_from_packed
    return design_from_packed(codes) if packed else design_from_codes(codes)


def prepare(cell: spec.Cell, seed: int, device) -> Setup:
    """The cell's design and pool of phenotypes on `device`, drawn from
    `seed`, and the loaded kernels and libraries of one short fit."""
    conf = cell.config
    m, n, packed = int(conf["markers"]), int(conf["samples"]), conf["codes"] == "int4"
    t = cell.traffic
    p = int(t["phenotypes"])
    model = spec.model(conf["model"])
    codes = draw_codes(m, n, packed, seed, device)

    def pool(rows, indices):
        return [model.phenotype(codes[:rows], packed, n, seed, i, conf, t) for i in indices]

    order = np.random.default_rng(subseed(seed, 4)).permutation(p).tolist()
    setup = Setup(dm=_design(codes, packed), codes=codes, packed=packed, m=m, n=n,
                  seed=seed, cell=cell, model=model, pool=pool(m, range(p)), order=order)
    w = min(m, max(WARMUP_ROWS, 4 * n))
    warm = setup._replace(dm=_design(codes[:w], packed), codes=codes[:w], m=w,
                          pool=pool(w, [p]), order=[0])
    fit(warm, 0, WARMUP_ITERATIONS)
    if _on_card(device):
        torch.cuda.synchronize(device)
    return setup


def fit(setup: Setup, i: int, iterations: int | None = None) -> Fit:
    """Fit i of the run: the pool's phenotype order[i] (the order repeats
    past its end), with that phenotype's own probe seed."""
    model, conf, t = setup.model, setup.cell.config, setup.cell.traffic
    j = setup.order[i % len(setup.order)]
    item = setup.pool[j]
    probe_seed = subseed(setup.seed, 3, j)
    its = int(conf["iterations"]) if iterations is None else iterations
    inputs = model.inputs(item, probe_seed, t)
    sink = io.StringIO()  # the engine's narration, as api.fit_linear(quiet=True) drops it
    try:
        with contextlib.redirect_stdout(sink), contextlib.redirect_stderr(sink):
            res = model.fit(setup.dm, item, its, probe_seed, conf, t)
    except Exception as e:  # a fit that raises is a failed fit: the window goes on
        msg = f"fit {i}: {type(e).__name__}: {e}"
        print(f"benchmark: {msg}", file=sys.stderr)
        return Fit(inputs=inputs, result=None, ok=False, error=msg)
    return Fit(inputs=inputs, result=res, ok=model.finite_and_whole(res, its))


def window(setup: Setup, seconds: float, first: int = 0) -> tuple[list, float]:
    """Fits `first`, `first` + 1, ... one after another until `seconds`
    have passed; (the fits, the window's seconds from the first fit's start
    to the last fit's end)."""
    fits = []
    t0 = time.perf_counter()
    while not fits or time.perf_counter() - t0 < seconds:
        fits.append(fit(setup, first + len(fits)))
    return fits, time.perf_counter() - t0


def traced_fit(setup: Setup) -> tuple[Fit, list]:
    """Fit 0 under torch.profiler, and the events of its Chrome trace.  One
    fit is the traced window: its trace is ~110-140 MB of JSON at the
    north star, and a window of fits would not load in a run's time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        first = fit(setup, 0)
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_FILE))
    del prof
    with open(TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    TRACE_FILE.unlink()
    return first, events


def sample(setup: Setup, fits: list) -> list:
    """The fits that came back whole, or at most the limits file's "sample"
    of them, drawn from the seed."""
    good = [f for f in fits if f.ok]
    most = int(setup.cell.limits["sample"])
    if len(good) <= most:
        return good
    pick = np.random.default_rng(subseed(setup.seed, 5)).choice(len(good), most, replace=False)
    return [good[j] for j in sorted(pick)]


def check_fits(setup: Setup, fits: list) -> dict:
    """The compared numbers of a sample of the fits that came back whole,
    by the model's reference."""
    chosen = sample(setup, fits)
    if not chosen:
        return {}
    model = setup.model
    ref = model.Reference(setup.codes, setup.packed)
    return model.readings([model.answer_of(f.result) for f in chosen],
                          [f.inputs for f in chosen], ref, setup.cell.config,
                          int(setup.cell.limits["head_iterations"]))


def loaded_banned() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """One run of `cell` on `device`: the result line's fields, "checks"
    last.  On the CPU (the harness's tests) no memory is read and the
    device fields are those of the CPU."""
    card = _on_card(device)
    setup = prepare(cell, seed, device)
    setup_s = time.perf_counter() - t_start

    events = None
    if traced:  # fit 0 traced, then the window's fits untraced
        first, events = traced_fit(setup)
        fits, window_s = window(setup, seconds, first=1)
        fits.insert(0, first)
    else:
        fits, window_s = window(setup, seconds)
    peak = torch.cuda.max_memory_allocated(device) if card else 0  # set-up's and the window's

    if card:
        torch.cuda.empty_cache()
    values = check_fits(setup, fits)
    failed = sum(not f.ok for f in fits)
    within, checks = check.verdict(values, cell.limits)

    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(device) if card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        busy_s, trace_s = trace.busy_and_window_s(events)
        run = Run(fits=[f for f in fits[1:] if f.result is not None], events=events,
                  kernels=spec.xpass_kernels(),
                  x_bytes=roofline.design_bytes(setup.m, setup.n, setup.packed),
                  busy_s=busy_s, window_s=trace_s)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = busy_s, trace_s
    else:
        e2e = {"setup_s": setup_s, "fit_s": window_s / len(fits)}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": bool(within and failed == 0), "attempted": len(fits), "failed": failed,
            "metrics": metrics, "device": dev}
    if traced:
        line["breakdown"] = {"device_ops": trace.top_device_ops(events),
                             "idle_gaps": trace.idle_gaps(events)}
    checks["failed_fits"] = {"value": failed, "limit": 0}
    for c in checks.values():  # a number that could not be read is null
        if not math.isfinite(c["value"]):
            c["value"] = None
    line["checks"] = checks
    return line


def main(args, t_start: float) -> int:
    cell = spec.cell(args.workload)
    device = require_cards(cell.chips)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    banned = loaded_banned()
    if banned:
        print(f"benchmark: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
