"""The port's spans and counted passes (vampomi_tpu_torch/utils/telemetry.py):
each iteration's phases and its passes over X as ops/operator.py counts
them, under every LMMSE solver and both models; the eigh's own span inside
the factor; no record_function while the profiler is off; and, under
torch.profiler, the phases as annotations nested in their iteration."""

import json
import os

import numpy as np
import pytest
import torch

from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.engine import probit as tprob
from vampomi_tpu_torch.ops import operator
from vampomi_tpu_torch.ops.operator import build_design
from vampomi_tpu_torch.sim.data_sim import simulate_iid
from vampomi_tpu_torch.utils import telemetry

TOP = ("em", "solve", "probe", "fetch", "report")
ITERS = 3


@pytest.fixture(scope="module")
def fx():
    return simulate_iid(n=200, m=400, lam=0.1, h2=0.8, seed=5)


@pytest.fixture(scope="module")
def dm(fx):
    return build_design(fx.X.T, compute_dtype=torch.int8, device="cpu")


def _cfg(tmp, solver, **kw):
    d = dict(out_dir=str(tmp), out_name="t", iterations=ITERS, rho=0.5, h2=0.8, gam1=1e-6,
             probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], CG_max_iter=500,
             CG_err_tol=1e-5, EM_max_iter=1, EM_err_thr=1e-2, learn_vars=1,
             learn_prior_delay=1, merge_vars_thr=0.5, stop_criteria_thr=0.0, seed=7,
             lmmse_solver=solver, device="cpu")
    d.update(kw)
    return RunConfig(**d)


def _fit(model, dm, fx, cfg, **kw):
    if model == "linear":
        return tlin.infere_linear(dm, fx.y, cfg, true_signal=fx.beta, **kw)
    return tprob.infere_bin_class(dm, (fx.y > 0).astype(float), cfg, true_signal=fx.beta, **kw)


@pytest.mark.parametrize("model", ["linear", "bin_class"])
@pytest.mark.parametrize("solver", ["eigen", "spectral", "cg"])
def test_iteration_phases_and_counted_passes(dm, fx, tmp_path, solver, model):
    """Every top-level phase an iteration, none negative, together within
    the iteration's wall; the passes over X counted at the operator: 2 an
    exact linear iteration, 3 an exact probit one, and under CG
    2 (steps + 1) plus the passes around the solve.  A^T y is the fit's
    one pass outside the iterations.  The trace file carries the same."""
    before = operator.x_passes()
    kw = dict(rho=0.3, gam1=1e-2) if model == "bin_class" else {}
    res = _fit(model, dm, fx, _cfg(tmp_path, solver, **kw))
    total = operator.x_passes() - before
    recs = [json.loads(line) for line in open(os.path.join(tmp_path, "t_trace.jsonl"))]
    assert len(res.iter_phases) == len(recs) == ITERS
    for phases, rec in zip(res.iter_phases, recs):
        assert set(TOP) | {"iteration", "passes"} <= set(phases)
        assert all(v >= 0 for v in phases.values())
        assert sum(phases[k] for k in TOP) <= phases["iteration"]
        assert phases["iteration"] == rec["seconds"]
        assert rec["phases"] == phases and rec["matrix_passes"] == phases["passes"]
        assert rec["bytes_moved"] == phases["passes"] * dm.X.numel()
        assert phases["probe_draws"] == (1 if solver == "cg" else 0)  # no checkpoint
        if solver != "cg":
            assert phases["passes"] == (2 if model == "linear" else 3)
            assert "dense" in phases or model == "bin_class"
        elif model == "linear":  # A x1; the solve; A x2 and A^T A probe
            assert phases["passes"] == 2 * (rec["cg_iters"] + 1) + 4
        else:  # A^T p2, A x1; the solve; A x2
            assert phases["passes"] == 2 * (rec["cg_iters"] + 1) + 3
    around = 1 if model == "linear" else 0  # linear's A^T y, once before the loop
    assert total == around + sum(p["passes"] for p in res.iter_phases)


def test_tracer_counters_count_an_iteration_and_stay_out_of_the_line():
    """A counter puts its increase over an iteration in the phases under
    its name, as the passes are; the log line lists only walls."""
    count = [0]
    tracer = telemetry.Tracer(None, lambda: 0, 1, counters={"draws": lambda: count[0]})
    for it, n in enumerate((2, 0, 1), start=1):
        tracer.start()
        with telemetry.span("probe"):
            count[0] += n
        rec = tracer.stop(it, 0)
        assert rec.phases["draws"] == n and rec.phases["passes"] == 0
        line = tracer.line(rec)
        assert "probe" in line and "draws" not in line


def test_eigh_solve_is_a_part_of_the_eigh(dm, fx, tmp_path):
    res = _fit("linear", dm, fx, _cfg(tmp_path, "eigen"), write_outputs=False)
    assert 0 < res.setup["eigen_solve"] < res.setup["eigh"]
    assert res.iter_phases and all(p["passes"] == 2 for p in res.iter_phases)


@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_spans_never_enter_record_function_with_the_profiler_off(dm, fx, tmp_path,
                                                                monkeypatch, model):
    def boom(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    res = _fit(model, dm, fx, _cfg(tmp_path, "eigen"), write_outputs=False)
    assert res.iterations_run == ITERS and len(res.iter_phases) == ITERS


def test_phases_nest_in_their_iteration_in_the_profilers_trace(dm, fx, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit("linear", dm, fx, _cfg(tmp_path, "cg"), write_outputs=False)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("vampomi.")]
    its = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "vampomi.iteration")
    assert len(its) == ITERS
    def inside(name, spans):
        got = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name]
        return [any(a <= s and t <= b for a, b in spans) for s, t in got]

    for name in ("vampomi.probe", "vampomi.fetch", "vampomi.solve", "vampomi.em",
                 "vampomi.report"):
        assert inside(name, its) == [True] * ITERS
    # every X pass in an iteration but A^T y, which is in the set-up's span
    aty = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "vampomi.aty"]
    passes = inside("vampomi.xpass", its)
    assert len(passes) > ITERS and passes.count(False) == 1
    assert inside("vampomi.xpass", aty).count(True) == 1
    assert telemetry._open is None


def test_a_raise_inside_an_iteration_closes_it(dm, fx, tmp_path, monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("failed inside the iteration")

    monkeypatch.setattr(tlin, "_iteration_phase_exact", fail)
    with pytest.raises(RuntimeError):
        _fit("linear", dm, fx, _cfg(tmp_path, "eigen"), write_outputs=False)
    assert telemetry._open is None


def test_span_into_a_dict_and_outside_an_iteration():
    got = {}
    with telemetry.span("gram", into=got) as s:
        pass
    assert got == {"gram": s.seconds} and s.seconds >= 0
    with telemetry.span("xpass") as s:  # no iteration open: the wall alone
        pass
    assert s.seconds >= 0 and telemetry._open is None


def test_a_gibbs_sweep_counts_no_pass_and_opens_no_span(dm, fx, monkeypatch):
    """The sweep reads X a block of rows at a time: no block is a pass, so
    it adds nothing to the count and, even under the profiler, makes no
    `xpass` span, while the public products count one pass each."""
    from vampomi_tpu_torch.gibbs import sampler

    opened = []
    monkeypatch.setattr(operator, "span", lambda name: opened.append(name) or
                        telemetry.span(name))
    grams = sampler.build_block_grams(dm, block=64)
    state = sampler.init_state(dm, fx.y, 3)
    before = operator.x_passes()
    with torch.autograd.profiler.profile():
        sampler.gibbs_sweep(dm, grams, state, torch.as_tensor(sampler.decade_cvars(3)),
                            sampler.TorchDraws(11), torch.as_tensor(fx.y, dtype=torch.float32),
                            block=64)
    assert operator.x_passes() == before and opened == []
    v = torch.ones(dm.m_pad, dtype=dm.wd)
    operator.atx(dm, operator.ax(dm, v))
    operator.atx_batch(dm, operator.ax_batch(dm, v[:, None]))
    assert operator.x_passes() == before + 4 and opened == ["xpass"] * 4


PROBIT_SOLVE = ("denoise", "zdenoise", "dense", "zlmmse", "confusion")


@pytest.mark.parametrize("solver", ["eigen", "spectral"])
def test_a_probit_exact_iteration_times_its_z_channel_inside_solve(dm, fx, tmp_path, solver):
    """Each exact probit iteration records the phase's five spans and its
    three passes; the spans sum within `solve` and, under torch.profiler,
    each annotation lies inside a `vampomi.solve` (`confusion` twice an
    iteration, one a classification half)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _fit("bin_class", dm, fx, _cfg(tmp_path, solver, rho=0.3, gam1=1e-2),
                   write_outputs=False)
    for phases in res.iter_phases:
        assert set(PROBIT_SOLVE) <= set(phases) and phases["passes"] == 3
        assert sum(phases[k] for k in PROBIT_SOLVE) <= phases["solve"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("vampomi.")]
    solves = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "vampomi.solve"]
    assert len(solves) == ITERS
    for name in PROBIT_SOLVE:
        got = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "vampomi." + name]
        assert len(got) == ITERS * (2 if name == "confusion" else 1), name
        assert all(any(a <= s and t <= b for a, b in solves) for s, t in got), name


def test_params_history_is_the_params_csv(dm, fx, tmp_path):
    """One params row a finished iteration, the values the params CSV
    writes (its "%20.15f" a value)."""
    from vampomi_tpu_torch.io.csv_writer import read_positional_csv

    res = _fit("bin_class", dm, fx, _cfg(tmp_path, "eigen", rho=0.3, gam1=1e-2))
    rows = read_positional_csv(os.path.join(tmp_path, "t_params.csv"))
    assert len(res.params_history) == res.iterations_run == len(rows) == ITERS
    for it, (params, row) in enumerate(zip(res.params_history, rows), start=1):
        assert len(params) == 8
        assert row == [float(it)] + [float("%20.15f" % v) for v in params]
    off = _fit("bin_class", dm, fx, _cfg(tmp_path, "eigen", rho=0.3, gam1=1e-2),
               write_outputs=False)
    np.testing.assert_array_equal(np.asarray(off.params_history), np.asarray(res.params_history))
