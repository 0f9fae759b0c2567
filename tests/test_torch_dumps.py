"""The per-iteration artifacts a fit writes (engine/linear.py dump_iteration,
src/vamp.cpp:234-252) and the spans of their pipeline: the .bin files of
the first iterations of an int8 eigen fit against the benchmark's plain
reference (benchmark/reference/gvamp.py, through
benchmark/models/linear_dumps.py), the last x1 file against the returned
estimate bit for bit, and each iteration's output spans and counters,
which the IO thread's writes reach in their own iteration's record and
which a fit that writes nothing records none of."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from benchmark.models import linear as bm
from benchmark.models import linear_dumps as bd
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.engine import probit as tprob
from vampomi_tpu_torch.ops.operator import build_design, design_from_codes
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)

CONFIG = {"run_config": {"h2": 0.8, "stop_criteria_thr": 0.0}}
ITERS = 6
HEAD = 3
# the relative L2 distance of a file to the reference's float64 vector:
# the float32 engine reads ~3e-6 here, the reference in TF32 (one step
# below float32) ~1e-3; the x1 tolerance of the linear engine's tests
F32_TOL = 1e-4
DUMP_SPANS = ("dump.stage", "dump.copy", "dump.write", "csv")
DUMP_COUNTERS = ("dump_bytes", "dump_waited")


@pytest.fixture(scope="module")
def int8_fit(tmp_path_factory):
    """An int8 eigen fit of M = 4,096 x N = 256 with its outputs written,
    and the reference's first iterations of it."""
    d = str(tmp_path_factory.mktemp("dumps"))
    codes = torch.randint(-127, 128, (4096, 256), dtype=torch.int8,
                          generator=torch.Generator().manual_seed(5))
    ph = bm.phenotype(codes, False, 256, 2**33 + 5, 0, CONFIG, {"markers_per_causal": 64})
    cfg = RunConfig(iterations=ITERS, lmmse_solver="eigen", device="cpu", seed=7,
                    probs=ph.probs, vars=ph.vars, out_dir=d, out_name="t",
                    **CONFIG["run_config"])
    res = tlin.infere_linear(design_from_codes(codes), ph.y, cfg, true_signal=ph.beta)
    want = bd.Reference(codes, False).dumps(bm.inputs(ph, 7, {"lmmse_solver": "eigen"}),
                                            CONFIG, HEAD)
    return d, res, want


def _file(d, k, kind=""):
    return bd._read(os.path.join(d, f"t_{kind}it_{k}.bin"))


def test_first_dumps_follow_the_reference(int8_fit):
    """The x1 file of iteration j against the reference's x1/sqrt(N) after
    j iterations, the r1 file against its r1/sqrt(N) after j - 1."""
    d, _, want = int8_fit
    for j, (x1, r1) in enumerate(want, start=1):
        assert bd._distance(_file(d, j), x1) < F32_TOL, j
        assert bd._distance(_file(d, j, "r1_"), r1) < F32_TOL, j
    assert float(torch.linalg.vector_norm(want[-1][0])) > 0  # a non-zero x1 compared


def test_last_x1_file_is_the_returned_estimate(int8_fit):
    d, res, _ = int8_fit
    assert np.array_equal(_file(d, ITERS).numpy(), res.x1_hat_scaled)


@pytest.fixture(scope="module")
def fx():
    return simulate_iid(n=200, m=400, lam=0.1, h2=0.8, seed=5)


@pytest.fixture(scope="module")
def dm(fx):
    return build_design(fx.X.T, compute_dtype=torch.int8, device="cpu")


def _cfg(tmp, **kw):
    d = dict(out_dir=str(tmp), out_name="t", iterations=ITERS, h2=0.8, gam1=1e-6,
             probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], stop_criteria_thr=0.0,
             seed=7, lmmse_solver="eigen", device="cpu")
    d.update(kw)
    return RunConfig(**d)


def _fit(model, dm, fx, cfg, **kw):
    if model == "linear":
        return tlin.infere_linear(dm, fx.y, cfg, true_signal=fx.beta, **kw)
    return tprob.infere_bin_class(dm, (fx.y > 0).astype(float), cfg, true_signal=fx.beta, **kw)


@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_every_iteration_records_its_dump(dm, fx, tmp_path, model):
    """Both engines: the staging, the IO thread's copy and write, the CSV
    rows and 16 Mt bytes an iteration, and the flush after the loop."""
    kw = dict(rho=0.3, gam1=1e-2) if model == "bin_class" else {}
    res = _fit(model, dm, fx, _cfg(tmp_path, **kw))
    assert len(res.iter_phases) == ITERS
    for p in res.iter_phases:
        assert set(DUMP_SPANS) <= set(p), sorted(p)
        assert p["dump_bytes"] == 16 * int(dm.mt)
        assert p["dump_waited"] == int("dump.wait" in p)
        assert p["dump.stage"] <= p["report"] <= p["iteration"]
    assert res.setup["dump.flush"] >= 0


@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_no_outputs_no_dump_spans(dm, fx, tmp_path, model):
    kw = dict(rho=0.3, gam1=1e-2) if model == "bin_class" else {}
    res = _fit(model, dm, fx, _cfg(tmp_path, **kw), write_outputs=False)
    for p in res.iter_phases:
        assert not set(p) & {*DUMP_SPANS, "dump.wait", *DUMP_COUNTERS}, sorted(p)
    assert "dump.flush" not in res.setup
    assert os.listdir(tmp_path) == []


def test_slow_writes_land_in_their_own_iteration(dm, fx, tmp_path, monkeypatch):
    """Each write of iteration k sleeps 0.1 k s on the IO thread, while the
    loop runs on: iteration k's `dump.write` holds its own two writes and
    no other's, and the submits past the writer's backlog of 4 wait, each
    counted in `dump_waited` beside its `dump.wait`."""
    real = tlin.write_marker_file
    threads = set()

    def slow(path, vec, mt, divisor, start=0):
        threads.add(threading.get_ident())
        time.sleep(0.1 * int(path.rsplit("_", 1)[1].split(".")[0]))
        return real(path, vec, mt, divisor, start)

    monkeypatch.setattr(tlin, "write_marker_file", slow)
    res = tlin.infere_linear(dm, fx.y, _cfg(tmp_path), true_signal=fx.beta)
    assert threads and threading.get_ident() not in threads
    for k, p in enumerate(res.iter_phases, start=1):
        assert 0.2 * k <= p["dump.write"] < 0.2 * (k + 1), (k, p["dump.write"])
        assert p["dump_waited"] == int("dump.wait" in p)
        assert p["dump_bytes"] == 16 * int(dm.mt)
    waited = [p["dump_waited"] for p in res.iter_phases]
    assert waited[:4] == [0, 0, 0, 0] and sum(waited) >= 1
    # the loop ended long before the writes: the flush waited for the rest
    assert res.setup["dump.flush"] >= 0.1
    for k in range(1, ITERS + 1):
        assert os.path.getsize(os.path.join(tmp_path, f"t_it_{k}.bin")) == 8 * int(dm.mt)
