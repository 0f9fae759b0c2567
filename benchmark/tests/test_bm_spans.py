"""The readers of the program's spans on hand-made runs: iter_host_share
and probe_ms from fake iteration phases, eigh_solve_s from fake set-up
walls, loop_idle from a synthetic trace of two iterations with known
kernel intervals; and nothing from a run whose program records none of
them, as a program from before the spans does."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.cell import Run

NEW = ("iter_host_share", "probe_ms", "loop_idle", "eigh_solve_s")


def _fit(phases, setup):
    return SimpleNamespace(result=SimpleNamespace(iter_seconds=[p["iteration"] for p in phases],
                                                  iter_phases=phases, setup=setup))


def _phases(iteration, fetch, probe):
    return {"em": 0.001, "solve": 0.004, "probe": probe, "fetch": fetch, "report": 0.001,
            "iteration": iteration, "passes": 2}


def _run(fits, events=None):
    return Run(fits=fits, events=events, kernels=spec.xpass_kernels(), x_bytes=1, busy_s=None,
               window_s=None)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_host_share_and_probe_over_iterations_past_the_first():
    # the first iteration of each fit is left out: its fetch waits on more
    fits = [_fit([_phases(0.5, 0.4, 0.9), _phases(0.020, 0.002, 0.006),
                  _phases(0.020, 0.004, 0.008)], {"eigh": 1.3, "eigen_solve": 1.0}),
            _fit([_phases(0.5, 0.4, 0.9), _phases(0.025, 0.005, 0.007)],
                 {"eigh": 1.4, "eigen_solve": 1.2})]
    run = _run(fits)
    # shares 90%, 80%, 80%
    assert spec.reader("iter_host_share")(run) == pytest.approx(80.0)
    assert spec.reader("probe_ms")(run) == pytest.approx(7.0)
    assert spec.reader("eigh_solve_s")(run) == pytest.approx(1.1)


def test_loop_idle_inside_the_iteration_spans_past_the_first():
    events = [
        # iteration 1, 0-100 us, all busy: left out
        _ev("user_annotation", "vampomi.iteration", 0, 100), _ev("kernel", "k", 0, 100),
        # iteration 2, 200-300: busy 190-220 (cut to 200-220) and 250-260
        # with an overlapping copy 255-270: 20 + 20 busy, 60 idle
        _ev("user_annotation", "vampomi.iteration", 200, 100),
        _ev("kernel", "k", 190, 30), _ev("kernel", "k", 250, 10),
        _ev("gpu_memcpy", "Memcpy DtoH", 255, 15),
        # iteration 3, 400-500: busy 450-550, cut to 450-500: 50 idle
        _ev("user_annotation", "vampomi.iteration", 400, 100), _ev("kernel", "k", 450, 100),
        # the same name on the card's timeline and other spans are not iterations
        _ev("gpu_user_annotation", "vampomi.iteration", 0, 600),
        _ev("user_annotation", "vampomi.fetch", 600, 50),
    ]
    assert spec.reader("loop_idle")(_run([], events)) == pytest.approx(100 * 110 / 200)


def test_nothing_to_read_where_the_program_records_no_spans():
    old = SimpleNamespace(result=SimpleNamespace(iter_seconds=[9.0, 0.02],
                                                 setup={"gram": 4.0, "eigh": 1.5}))
    trace = [_ev("user_annotation", "vampomi.iteration", 0, 100), _ev("kernel", "k", 0, 50),
             _ev("cpu_op", "aten::mm", 0, 300)]
    for run in (_run([old], trace[1:]), _run([old]), _run([_fit([], {})], [])):
        for name in NEW:
            assert spec.reader(name)(run) is None, name
    # one iteration span: it is the first, and left out
    assert spec.reader("loop_idle")(_run([], trace)) is None


def test_new_metrics_name_their_readers_and_the_eigen_cells():
    import json

    with open(spec.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = got[name]
        assert m["moves"] == "fit_s" and callable(spec.reader(name))
        assert m["workloads"] == ["ns_int8.eigen_fits", "ns_int4.eigen_fits"]
    assert [m["name"] for m in bench["per_layer"]][-4:] == list(NEW)
