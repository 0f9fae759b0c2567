"""The probit cell (benchmark/models/probit.py) on the CPU at its small size
(benchmark/tests/small/<cell>.json, the full size's M/N): sound, it is
correct; with one iteration of the engine returning the state it was
given, or with the z-denoiser's answer altered by one part in 10^3, it is
not (the TF32 control in the program's place is test_bm_harness.py's,
over every cell).  A program whose result records no params rows stops
the run in the set-up, as the parent of the cell does.  The probit
reference loads nothing of the program or of JAX.  The readers of the
z-channel's spans on hand-made runs, and on a run of a program that has
no such span."""

import inspect
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import vampomi_tpu_torch.engine.probit as probit
from benchmark import cell, spec
from benchmark.cell import Run

CELL = "ns_int8_probit.eigen_fits"
ITERATIONS = 4
BANNED = {"jax", "jaxlib", "flax", "vampomi_tpu", "vampomi_tpu_torch"}


def small() -> spec.Cell:
    c = spec.cell(CELL)
    size = json.loads((spec.HERE / "tests" / "small" / f"{CELL}.json").read_text())
    return c._replace(config=dict(c.config, iterations=ITERATIONS, **size),
                      traffic=dict(c.traffic, phenotypes=2))


def run() -> dict:
    torch.set_num_threads(4)
    return cell.run_cell(small(), 2**33 + 5, 0.0, False, torch.device("cpu"), 0.0)


def test_sound_run_is_correct():
    line = run()
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert line["checks"]["head_gap"]["value"] > 0


def _stale_iteration(monkeypatch, which: int = 2):
    """Iteration `which` of every fit returns the state it was given (its
    rows are still worked out)."""
    real = probit._probit_phase
    sig = inspect.signature(real)
    seen = {}

    def broken(*args, **kw):
        out = real(*args, **kw)
        a = sig.bind(*args, **kw).arguments
        it = seen[id(a["dm"])] = seen.get(id(a["dm"]), 0) + 1
        if it == which:
            out.update(r1=a["r1"], r2=a["r2"], p1=a["p1"], p2=a["p2"], gam1=a["gam1"],
                       tau1=a["tau1"], alpha1=a["alpha1_prev"], x1_hat=a["x1_hat_prev"])
        return out
    monkeypatch.setattr(probit, "_probit_phase", broken)


def _zdenoiser_altered(monkeypatch):
    real = probit.g1_bin_class
    monkeypatch.setattr(probit, "g1_bin_class", lambda *a: real(*a) * (1 + 1e-3))


@pytest.mark.parametrize("fault", [_stale_iteration, _zdenoiser_altered])
def test_a_broken_probit_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line = run()
    assert not line["correct"], line["checks"]


def test_a_program_without_params_rows_stops_in_the_set_up(monkeypatch):
    """The engine before ProbitResult.params_history: the set-up's fit
    raises, so the run gives no result line and no window."""
    real = probit.infere_bin_class

    def old(*a, **kw):
        res = real(*a, **kw)
        return SimpleNamespace(**{k: v for k, v in res._asdict().items()
                                  if k != "params_history"})
    monkeypatch.setattr(probit, "infere_bin_class", old)
    with pytest.raises(RuntimeError, match="params_history"):
        run()


def test_the_probit_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.gvamp_probit; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names and not names & BANNED


def _fit(*phases):
    return SimpleNamespace(result=SimpleNamespace(iter_phases=list(phases)))


def _run(fits, events=None):
    return Run(fits=fits, events=events, kernels=spec.xpass_kernels(), x_bytes=1, busy_s=None,
               window_s=None)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_zchannel_ms_over_iterations_past_the_first():
    z = lambda zd, zl: {"zdenoise": zd, "zlmmse": zl, "iteration": 0.03}  # noqa: E731
    fits = [_fit(z(0.5, 0.5), z(0.0010, 0.0002), z(0.0012, 0.0003)),
            _fit(z(0.5, 0.5), z(0.0020, 0.0004))]
    # 1.2, 1.5 and 2.4 ms past the first iterations
    assert spec.reader("zchannel_ms")(_run(fits)) == pytest.approx(1.5)


def test_zchannel_idle_inside_the_spans_past_the_first_iteration():
    events = [
        # iteration 1, 0-100: its z-channel spans, all idle, are left out
        _ev("user_annotation", "vampomi.iteration", 0, 100),
        _ev("user_annotation", "vampomi.zdenoise", 10, 20),
        _ev("user_annotation", "vampomi.zlmmse", 60, 20),
        # iteration 2, 200-300: zdenoise 210-250, busy 200-220 and 240-260
        # (cut to 210-220 and 240-250): 20 of 40 busy; zlmmse 270-290 with a
        # copy 275-280 under a kernel 270-285: 15 of 20 busy
        _ev("user_annotation", "vampomi.iteration", 200, 100),
        _ev("user_annotation", "vampomi.zdenoise", 210, 40),
        _ev("kernel", "k", 200, 20), _ev("kernel", "k", 240, 20),
        _ev("user_annotation", "vampomi.zlmmse", 270, 20),
        _ev("kernel", "k", 270, 15), _ev("gpu_memcpy", "Memcpy DtoH", 275, 5),
        # other spans and the card's own copy of an annotation are not read
        _ev("user_annotation", "vampomi.dense", 300, 50), _ev("kernel", "k", 300, 50),
        _ev("gpu_user_annotation", "vampomi.zlmmse", 0, 400),
    ]
    assert spec.reader("zchannel_idle")(_run([], events)) == pytest.approx(100 * 25 / 60)


def test_nothing_to_read_from_a_program_without_the_z_channel_spans():
    linear = _fit({"denoise": 0.001, "dense": 0.002, "iteration": 0.03},
                  {"denoise": 0.001, "dense": 0.002, "iteration": 0.03})
    trace = [_ev("user_annotation", "vampomi.iteration", 0, 100),
             _ev("user_annotation", "vampomi.iteration", 200, 100),
             _ev("user_annotation", "vampomi.solve", 210, 50), _ev("kernel", "k", 0, 300)]
    old = SimpleNamespace(result=SimpleNamespace(iter_seconds=[0.5, 0.03]))
    for run_ in (_run([linear], trace), _run([old]), _run([], [])):
        assert spec.reader("zchannel_ms")(run_) is None
        assert spec.reader("zchannel_idle")(run_) is None
    # a z-channel span in the first iteration alone is left out
    first = trace + [_ev("user_annotation", "vampomi.zdenoise", 10, 20)]
    assert spec.reader("zchannel_idle")(_run([], first)) is None


def test_the_new_metrics_read_the_probit_cell_alone():
    with open(spec.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    got = {m["name"]: m for m in bench["per_layer"]}
    for name in ("zchannel_ms", "zchannel_idle"):
        assert got[name]["workloads"] == [CELL] and got[name]["moves"] == "fit_s"
    assert got["zchannel_ms"]["source"] == "program_span"
    assert got["zchannel_idle"]["source"] == "device_trace"
    work = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert work["chips"] == 1 and work["traffic"] == "eigen_fits"
    assert spec.cell(CELL).config["model"] == "probit"
