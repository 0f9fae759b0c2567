"""A run of each cell driven on the CPU at a small size (the look for a
card skipped; the port's kernels run their plain versions), with its
committed limits: sound, it is correct; with the timed path broken
underneath, or with the TF32 control in the program's place, it is not.

A cell is tested here where benchmark/tests/small/<cell>.json gives its
small size (markers, samples, at the full size's M/N); the faults below
patch the linear engine, and are planted in the cells whose model is
linear.

The faults: an iteration that returns its state unchanged, from the first
or, in a cell that compares `tail_gap`, only past the compared head; each
pass of A x over half the markers, scaled by two (half the batch left out,
the mean taken over the rest); the A^T pass's answer altered by one part
in 10^3 where its kernel produces it.  The cells run on one chip, so there
is no exchange between chips to leave out."""

import inspect
import json
import math

import numpy as np
import pytest
import torch

import vampomi_tpu_torch.engine.linear as linear
import vampomi_tpu_torch.ops.operator as operator
from benchmark import cell, check, spec

SMALL = spec.HERE / "tests" / "small"
ITERATIONS = 4  # one past the compared head


def _sizes() -> dict:
    """{cell: its small size} of every cell of BENCHMARK.json that has one."""
    with open(spec.ROOT / "BENCHMARK.json") as f:
        names = [w["name"] for w in json.load(f)["workloads"]]
    return {n: json.loads((SMALL / f"{n}.json").read_text())
            for n in names if (SMALL / f"{n}.json").is_file()}


SIZES = _sizes()
CELLS = list(SIZES)
LINEAR = [n for n in CELLS if spec.cell(n).config["model"] == "linear"]


def small(name: str) -> spec.Cell:
    c = spec.cell(name)
    m, n = SIZES[name]["markers"], SIZES[name]["samples"]
    return c._replace(config=dict(c.config, markers=m, samples=n, iterations=ITERATIONS),
                      traffic=dict(c.traffic, phenotypes=2))


def run(name: str, seed: int = 2**33 + 5) -> dict:
    torch.set_num_threads(4)
    return cell.run_cell(small(name), seed, 0.0, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert list(line)[-1] == "checks" and line["checks"]["failed_fits"]["value"] == 0
    assert set(line["metrics"]) == {"fit_s", "setup_s"}
    assert set(line["checks"]) == set(spec.cell(name).limits["limits"]) | {"failed_fits"}


def _stale_from(monkeypatch, first: int):
    """Iterations `first`, `first` + 1, ... of every fit return the state
    they were given (their rows are still worked out)."""
    for fname in ("_iteration_phase", "_iteration_phase_exact"):
        real = getattr(linear, fname)
        sig = inspect.signature(real)
        seen = {}

        def broken(*args, _real=real, _sig=sig, _seen=seen, **kw):
            out = _real(*args, **kw)
            a = _sig.bind(*args, **kw).arguments
            it = _seen[id(a["dm"])] = _seen.get(id(a["dm"]), 0) + 1
            if it >= first:
                out.update(r1=a["r1"], gam1=a["gam1"], gamw=a["gamw"], x1_hat=a["x1_hat_prev"])
            return out
        monkeypatch.setattr(linear, fname, broken)


def _state_unchanged(monkeypatch):
    _stale_from(monkeypatch, 1)


def _state_unchanged_past_the_head(monkeypatch):
    _stale_from(monkeypatch, ITERATIONS)


def _half_the_markers(monkeypatch):
    real = operator.ax_batch

    def broken(dm, xs):
        half = xs.clone()
        half[dm.m_pad // 2:] = 0
        return 2 * real(dm, half)
    monkeypatch.setattr(operator, "ax_batch", broken)
    monkeypatch.setattr(linear, "ax_batch", broken)


def _answer_altered(monkeypatch):
    for fname in ("atx_int8", "atx_packed4", "atx_batch_int8", "atx_batch_packed4"):
        real = getattr(operator, fname)
        monkeypatch.setattr(operator, fname,
                            lambda *a, _real=real: _real(*a) * (1 + 1e-3))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_markers, _answer_altered])
@pytest.mark.parametrize("name", LINEAR)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run(name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", [n for n in LINEAR if "tail_gap" in spec.cell(n).limits["limits"]])
def test_a_state_left_unchanged_past_the_head_is_not_correct(name, monkeypatch):
    _state_unchanged_past_the_head(monkeypatch)
    line = run(name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(name):
    c = small(name)
    setup = cell.prepare(c, 77, torch.device("cpu"))
    f = cell.fit(setup, 0)
    k = int(c.limits["head_iterations"])
    model = setup.model
    ref = model.Reference(setup.codes, setup.packed)
    ctl = model.Reference(setup.codes, setup.packed, "tf32").fits([f.inputs], c.config, k)
    # the control in the program's place, judged as a run judges the program
    control = model.readings(ctl, [f.inputs], ref, c.config, k)
    assert not check.verdict(control, c.limits)[0], control


def _not_finite(value):
    """`value` with its first number infinite, or None where it holds no
    floating-point numbers."""
    if isinstance(value, float):
        return math.inf
    if isinstance(value, (list, np.ndarray)):
        try:
            a = np.array(value, dtype=float)
        except (TypeError, ValueError):
            return None
        if a.size == 0 or (isinstance(value, np.ndarray) and value.dtype.kind != "f"):
            return None
        a.flat[0] = math.inf
        return a if isinstance(value, np.ndarray) else a.tolist()
    return None


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("name", CELLS)
def test_a_fit_that_is_not_finite_or_stops_early_failed(name):
    """A sound fit's result, stopped one iteration early, fails; so does
    every value of it made infinite that the answer reads (a value the
    answer does not read leaves it as it was)."""
    setup = cell.prepare(small(name), 78, torch.device("cpu"))
    f = cell.fit(setup, 0)
    model, res = setup.model, f.result
    assert f.ok and model.finite_and_whole(res, ITERATIONS)
    assert not model.finite_and_whole(res._replace(iterations_run=ITERATIONS - 1), ITERATIONS)
    read = 0
    for field, value in res._asdict().items():
        bad = _not_finite(value)
        if bad is None:
            continue
        broken = res._replace(**{field: bad})
        if model.finite_and_whole(broken, ITERATIONS):
            assert _same(model.answer_of(broken), model.answer_of(res)), field
        else:
            read += 1
    assert read >= 2  # at least the estimate and the metrics rows
    ok, out = check.verdict({"head_gap": math.nan}, {"limits": {"head_gap": 1.0}})
    assert not ok and math.isnan(out["head_gap"]["value"])


def test_a_fit_cut_inside_the_head_is_held_by_its_state():
    """A CG fit cut to the compared head (the Open questions' CG cell):
    its probes reach the reference, its returned state is compared, and a
    returned r1 that is not the iteration's (x1 in its place), or the
    control, reads over the state_gap its chip readings set (program 1.6e-5 to 7.0e-5, control
    3.8e-3 and over, at the cell's full size)."""
    base = small("ns_int8.eigen_fits")
    c = base._replace(traffic=dict(base.traffic, lmmse_solver="cg"),
                      limits={"head_iterations": ITERATIONS, "sample": 12,
                              "limits": {"head_gap": 6e-4, "state_gap": 6e-4}})
    setup = cell.prepare(c, 2**33 + 5, torch.device("cpu"))
    f = cell.fit(setup, 0)
    assert f.ok and f.inputs.probe_seed is not None
    model, conf = setup.model, c.config
    ref = model.Reference(setup.codes, setup.packed)
    prog = model.readings([model.answer_of(f.result)], [f.inputs], ref, conf, ITERATIONS)
    assert check.verdict(prog, c.limits)[0], prog
    ctl = model.Reference(setup.codes, setup.packed, "tf32").fits([f.inputs], conf, ITERATIONS)
    assert not check.verdict(model.readings(ctl, [f.inputs], ref, conf, ITERATIONS),
                             c.limits)[0]
    wrong = model.answer_of(f.result._replace(r1_scaled=f.result.x1_hat_scaled))
    assert not check.verdict(model.readings([wrong], [f.inputs], ref, conf, ITERATIONS),
                             c.limits)[0]
