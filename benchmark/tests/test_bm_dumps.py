"""The cell whose fits write the reference CLI's outputs
(ns_int8_dumps.eigen_fits, benchmark/models/linear_dumps.py), driven on the
CPU at its small size: sound, it is correct and leaves one fit's files;
with its files wrong underneath, or the TF32 control in the files' place,
it is not.  The readers of the output pipeline's spans read them from a
sound run, and nothing from fits that record none, as a program from
before the spans."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import vampomi_tpu_torch.engine.linear as linear
from benchmark import cell, check, spec
from benchmark.cell import Run
from benchmark.tests.test_bm_harness import ITERATIONS, SIZES

NAME = "ns_int8_dumps.eigen_fits"
SEED = 2**33 + 5
READERS = ("dump_wait_ms", "dump_write_ms", "dump_flush_ms", "dump_loop_idle")


def small(out_dir) -> spec.Cell:
    c = spec.cell(NAME)
    return c._replace(config=dict(c.config, **SIZES[NAME], iterations=ITERATIONS,
                                  out_dir=str(out_dir)),
                      traffic=dict(c.traffic, phenotypes=2))


def run(out_dir) -> dict:
    torch.set_num_threads(4)
    return cell.run_cell(small(out_dir), SEED, 0.0, False, torch.device("cpu"), 0.0)


def _fit_files(k: int) -> set:
    return ({f"fit_{kind}it_{j}.bin" for kind in ("", "r1_") for j in range(1, k + 1)}
            | {f"fit_{s}.csv" for s in ("metrics", "params", "prior")} | {"fit_trace.jsonl"})


def test_sound_run_is_correct_and_leaves_one_fits_files(tmp_path):
    (tmp_path / "fit_it_99.bin").write_bytes(b"an earlier run's")
    (tmp_path / "other.txt").write_text("not the run's")
    line = run(tmp_path)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["checks"]) == {"head_gap", "dump_gap", "dump_last", "failed_fits"}
    assert line["checks"]["dump_last"]["value"] == 0.0
    assert set(os.listdir(tmp_path)) == _fit_files(ITERATIONS) | {"other.txt"}


def test_the_metrics_csv_is_checked_in_the_writers_own_layout(tmp_path):
    """A row with a value wider than its 20 characters is longer, so the
    positional writer puts it elsewhere and the next row overwrites its
    end: the layout `finite_and_whole` compares with is the writer's."""
    from vampomi_tpu_torch.engine.linear import METRICS_HEADER
    from vampomi_tpu_torch.io.csv_writer import PositionalCSV

    model = spec.model("linear_dumps")
    rows = [[0.0, 0.0, 0.96, 0.08, 0.0, 0.99], [-64.75, 0.28, 0.98, 0.28, 0.96, 0.99],
            [-123456.5, -0.15, 0.99, -0.14, 0.81, 0.99], [0.7, 0.37, 0.97, 0.37, 0.97, 0.99]]
    csv = PositionalCSV(str(tmp_path / "m.csv"), METRICS_HEADER)
    for k, row in enumerate(rows, start=1):
        csv.write_row(k, row)
    got = (tmp_path / "m.csv").read_bytes()
    assert got == model.positional_csv(METRICS_HEADER, rows)
    assert got.count(b"\n") != len(rows) + 1  # a line count would miss the rows


def _shifted(monkeypatch):
    """Iteration k's x1 and r1 go to the files of iteration k + 1 (and the
    first iteration's to its own as well, so every file is there)."""
    real = linear.dump_iteration

    def shifted(cfg, mt, sqrt_n, k, copy, start, into):
        if k == 1:
            real(cfg, mt, sqrt_n, 1, copy, start, {})
        real(cfg, mt, sqrt_n, k + 1, copy, start, into)
    monkeypatch.setattr(linear, "dump_iteration", shifted)


def _float32(monkeypatch):
    def f32(path, vec, mt, divisor, start=0):
        host = (vec.detach().cpu().numpy()[:mt - start] / divisor).astype("<f4")
        with open(path, "wb") as f:
            f.write(host.tobytes())
        return host.nbytes
    monkeypatch.setattr(linear, "write_marker_file", f32)


def _last_left_out(monkeypatch):
    real = linear.dump_iteration

    def all_but_last(cfg, mt, sqrt_n, k, copy, start, into):
        if k < cfg.iterations:
            real(cfg, mt, sqrt_n, k, copy, start, into)
    monkeypatch.setattr(linear, "dump_iteration", all_but_last)


@pytest.mark.parametrize("fault", [_shifted, _float32, _last_left_out])
def test_wrong_files_are_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    line = run(tmp_path)
    assert not line["correct"], line["checks"]


def test_the_control_in_the_files_place_is_not_correct(tmp_path):
    c = small(tmp_path)
    setup = cell.prepare(c, 77, torch.device("cpu"))
    f = cell.fit(setup, 0)
    k = int(c.limits["head_iterations"])
    model = setup.model
    ref = model.Reference(setup.codes, setup.packed)
    prog = model.readings([model.answer_of(f.result)], [f.inputs], ref, c.config, k)
    assert check.verdict(prog, c.limits)[0], prog
    ctl = model.Reference(setup.codes, setup.packed, "tf32").fits([f.inputs], c.config, k)
    control = model.readings(ctl, [f.inputs], ref, c.config, k)
    # its dumps alone are over their limit, by more than 3x
    assert control["dump_gap"] > 3 * c.limits["limits"]["dump_gap"], control
    assert not check.verdict(control, c.limits)[0], control


def _run(fits, events=None):
    return Run(fits=fits, events=events, kernels=spec.xpass_kernels(), x_bytes=1, busy_s=None,
               window_s=None)


def test_readers_read_the_spans_of_a_sound_run(tmp_path):
    setup = cell.prepare(small(tmp_path), SEED, torch.device("cpu"))
    fits = [cell.fit(setup, i) for i in range(2)]
    assert all(f.ok for f in fits)
    run_ = _run(fits)
    for name in READERS[:3]:
        v = spec.reader(name)(run_)
        assert v is not None and v >= 0, name
    writes = [p["dump.write"] for f in fits for p in f.result.iter_phases]
    assert spec.reader("dump_write_ms")(run_) == pytest.approx(1e3 * np.median(writes))


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_loop_idle_of_a_dumping_trace_and_nothing_without_the_spans():
    loop = [_ev("user_annotation", "vampomi.iteration", 0, 100), _ev("kernel", "k", 0, 100),
            _ev("user_annotation", "vampomi.iteration", 200, 100), _ev("kernel", "k", 200, 40)]
    dumping = loop + [_ev("user_annotation", "vampomi.dump.stage", 290, 5)]
    assert spec.reader("dump_loop_idle")(_run([], dumping)) == pytest.approx(60.0)
    old = SimpleNamespace(result=SimpleNamespace(
        iter_seconds=[0.5, 0.02], setup={"gram": 4.0, "eigh": 1.5},
        iter_phases=[{"iteration": 0.5, "report": 0.001}, {"iteration": 0.02, "report": 0.001}]))
    for r in (_run([old], loop), _run([old]), _run([], [])):
        for name in READERS:
            assert spec.reader(name)(r) is None, name
