"""The exact linear iteration as one CUDA graph (vampomi_tpu_torch/engine/
graph.py) and the fit's numbers on the device (ops/operator.py Consts).

On the CPU: which fits take the graph (`linear._graphable`: none here, and
by the rule's own terms none under spectral, CG, a shard, --verbosity 1 or
EM's convergence test); `graph_replays` 0 on every iteration of every CPU
fit, both models; a fit's Consts give the phases the bits they had without
one, and make each number once; after the first steady iteration no Python
number is made a tensor.  On a card (marked `cuda`, skipped here): int8
and packed int4 fits of 32,768 x 4,096 under eigen, graphed against eager,
byte for byte, with their counts and files; and an eager iteration that
synchronises nothing once its numbers exist."""

import hashlib
import os
import types

import numpy as np
import pytest
import torch

from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.engine import probit as tprob
from vampomi_tpu_torch.ops import operator
from vampomi_tpu_torch.ops.eigen import EigenFactor
from vampomi_tpu_torch.ops.operator import (
    Consts, build_design, design_from_codes, design_from_packed, f64,
)
from vampomi_tpu_torch.ops.spectral import build_spectral
from vampomi_tpu_torch.prior.mixture import init_prior
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)

ITERS = 4


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


def _fit(model, dm, fx, cfg):
    if model == "linear":
        return tlin.infere_linear(dm, fx.y, cfg, true_signal=fx.beta, write_outputs=False)
    return tprob.infere_bin_class(dm, (fx.y > 0).astype(float), cfg, true_signal=fx.beta,
                                  write_outputs=False)


def _card_like(dm, shard=None):
    """`dm` as the rule sees a card's design: only its device and shard."""
    return types.SimpleNamespace(device=torch.device("cuda"), shard=shard)


@pytest.mark.parametrize("case,takes", [
    ("eigen", True), ("spectral", False), ("cg", False), ("shard", False),
    ("verbosity 1", False), ("EM steps 2", False), ("cpu", False),
])
def test_the_rule_takes_the_graph_for_eigen_alone(dm, tmp_path, case, takes):
    fac = build_spectral(dm)
    eig = EigenFactor(U=torch.eye(int(dm.n)), lam=torch.ones(int(dm.n), dtype=torch.float64))
    kw = {"verbosity 1": dict(verbosity=1), "EM steps 2": dict(EM_max_iter=2)}.get(case, {})
    cfg = _cfg(tmp_path, "eigen", **kw)
    factor = {"spectral": fac, "cg": None}.get(case, eig)
    design = dm if case == "cpu" else _card_like(dm, object() if case == "shard" else None)
    assert tlin._graphable(design, factor, cfg) is takes


@pytest.mark.parametrize("delay,iterations,first", [
    (1, 50, 2), (0, 50, 2), (10, 50, 11), (50, 50, 2), (60, 50, 2), (49, 50, 50),
])
def test_the_first_steady_iteration(tmp_path, delay, iterations, first):
    """From it on, each iteration is damped and runs the EM update if any
    iteration of the run does."""
    cfg = _cfg(tmp_path, "eigen", learn_prior_delay=delay, iterations=iterations)
    assert tlin._first_steady(cfg) == first
    shape = [(it > 1, it > delay) for it in range(first, iterations + 1)]
    assert len(set(shape)) == 1 and shape[0][0]


@pytest.mark.parametrize("model", ["linear", "bin_class"])
@pytest.mark.parametrize("solver", ["eigen", "spectral", "cg"])
def test_no_replays_on_the_cpu(dm, fx, tmp_path, model, solver):
    kw = dict(rho=0.3, gam1=1e-2) if model == "bin_class" else {}
    res = _fit(model, dm, fx, _cfg(tmp_path, solver, **kw))
    assert [p["graph_replays"] for p in res.iter_phases] == [0] * ITERS
    assert not any("graph_capture" in p for p in res.iter_phases)


def test_consts_make_each_number_once_with_the_bits_of_f64():
    k = Consts("cpu")
    for x, dtype in ((0.5, torch.float32), (1.0 - 0.3, torch.float32), (2 * np.pi, torch.float32),
                     (10240, torch.float64), (1e-7, torch.float64), (-0.0, torch.float64)):
        t = k(x, dtype)
        assert t is k(x, dtype) and t.dtype == dtype
        assert torch.equal(t, f64(x, "cpu").to(dtype))
        assert t.numpy().tobytes() == f64(x, "cpu").to(dtype).numpy().tobytes()
    assert k(-0.0) is not k(0.0) and str(float(k(-0.0))) == "-0.0"
    g = torch.tensor(0.7, dtype=torch.float64)
    assert torch.equal(k(g, torch.float32), g.to(torch.float32))
    assert k(0.5) is not k(0.5, torch.float32)


def _digest(res) -> str:
    """SHA-256 of every field of an engine's result but the timings."""
    h = hashlib.sha256()
    for name in res._fields:
        v = getattr(res, name)
        if name not in ("iter_seconds", "iter_phases", "setup", "solver") and v is not None:
            h.update(name.encode() + np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("model", ["linear", "bin_class"])
@pytest.mark.parametrize("solver", ["eigen", "cg"])
def test_a_fits_consts_change_no_bit(dm, fx, tmp_path, monkeypatch, model, solver):
    """A fit that makes its numbers anew at every use, as the phases did
    before they took the fit's Consts, gives the same bytes."""
    kw = dict(rho=0.3, gam1=1e-2) if model == "bin_class" else {}
    want = _digest(_fit(model, dm, fx, _cfg(tmp_path, solver, **kw)))

    class Fresh(Consts):
        def __call__(self, x, dtype=torch.float64):
            return f64(x, self.device).to(dtype)

    for mod in (tlin, tprob):
        monkeypatch.setattr(mod, "Consts", Fresh)
    assert _digest(_fit(model, dm, fx, _cfg(tmp_path, solver, **kw))) == want


@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_no_number_is_made_a_tensor_after_the_first_iteration(dm, fx, tmp_path, monkeypatch,
                                                              model):
    """On a card each would be a copy from the host that synchronises the
    stream, and that a CUDA graph cannot capture."""
    made, starts = [], []
    for name in ("as_tensor", "tensor"):
        real = getattr(torch, name)

        def counted(data, *a, _real=real, **kw):
            if isinstance(data, (int, float, bool)):
                made.append(data)
            return _real(data, *a, **kw)
        monkeypatch.setattr(torch, name, counted)
    start = tlin.Tracer.start
    monkeypatch.setattr(tlin.Tracer, "start", lambda self: (starts.append(len(made)),
                                                            start(self))[1])
    kw = dict(rho=0.3, gam1=1e-2) if model == "bin_class" else {}
    res = _fit(model, dm, fx, _cfg(tmp_path, "eigen", **kw))
    assert res.iterations_run == ITERS and len(starts) == ITERS
    # iteration 1 makes its numbers, 2, the first steady one, those of the
    # damping and of EM; the graph captures 3
    assert starts[1] > 0 and made[starts[2]:] == []


def test_the_phases_take_a_fits_consts(dm, fx):
    """The exact phase and EM with one Consts for the fit equal their
    outputs without one, bit for bit."""
    fac = build_spectral(dm)
    prior = init_prior([0.9, 0.07, 0.03], [0.0, 1e-3, 1e-2], int(dm.n))
    rng = np.random.default_rng(3)
    r1 = torch.as_tensor(rng.normal(size=dm.m_pad), dtype=dm.wd)
    x1 = torch.as_tensor(rng.normal(size=dm.m_pad), dtype=dm.wd)
    y = torch.as_tensor(fx.y, dtype=dm.wd)
    ts = torch.as_tensor(fx.beta, dtype=dm.wd)
    aty = operator.atx(dm, y)
    k = Consts("cpu")
    for _ in range(2):  # made at the first use, kept for the second
        for consts in (None, k):
            got = tlin._em_phase(dm, r1, 0.7, prior, 1, 1e-2, True, 0.5, 20.0, consts=consts)
            want = tlin._em_phase(dm, r1, 0.7, prior, 1, 1e-2, True, 0.5, 20.0)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            got = tlin._iteration_phase_exact(dm, fac, aty, y, r1, 0.7, prior, x1, True, 0.5,
                                              3.0, ts, consts)
            want = tlin._iteration_phase_exact(dm, fac, aty, y, r1, 0.7, prior, x1, True, 0.5,
                                               3.0, ts)
            for name, v in want.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(got[name], v), name


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

CARD_M, CARD_N, CARD_ITERS = 32_768, 4_096, 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_problem(kind: str, dev):
    """A design of CARD_M x CARD_N codes on the card and a phenotype planted
    on 32 of its markers (unit variance, h2 0.8)."""
    g = torch.Generator().manual_seed(21)
    if kind == "int8":
        codes = torch.randint(-127, 128, (CARD_M, CARD_N), dtype=torch.int8, generator=g)
        dm = design_from_codes(codes.to(dev))
        rows = codes.double()
    else:
        packed = torch.randint(0, 256, (CARD_M, CARD_N // 2), dtype=torch.uint8, generator=g)
        dm = design_from_packed(packed.to(dev))
        rows = operator.unpack_rows(packed, torch.float64)
    rng = np.random.default_rng(22)
    idx = np.sort(rng.choice(CARD_M, 32, replace=False))
    beta = np.zeros(CARD_M)
    beta[idx] = rng.normal(0.0, np.sqrt(0.8 / 32), 32)
    c = rows[torch.as_tensor(idx)]
    z = (c - c.mean(dim=1, keepdim=True)) / c.std(dim=1, keepdim=True)
    y = (torch.as_tensor(beta[idx])[:, None] * z).sum(dim=0).numpy()
    y = y + rng.normal(0.0, np.sqrt(0.2), CARD_N)
    return dm, (y - y.mean()) / y.std(ddof=1), beta


def _card_fit(dm, y, beta, tmp, write_outputs, eager, monkeypatch):
    with monkeypatch.context() as mp:
        if eager:
            mp.setattr(tlin, "_graphable", lambda *a: False)
        cfg = _cfg(tmp, "eigen", iterations=CARD_ITERS, device="cuda", trace=0)
        before = operator.pass_counts()
        res = tlin.infere_linear(dm, y, cfg, true_signal=beta, write_outputs=write_outputs)
        counts = [a - b for a, b in zip(operator.pass_counts(), before)]
    return res, counts


def _fields(res) -> dict:
    """Every field of the result but the timings."""
    out = {name: getattr(res, name) for name in res._fields
           if name not in ("iter_seconds", "iter_phases", "setup")}
    out["setup"] = {k: v for k, v in res.setup.items() if k in ("eigen_resid", "eigen_lam_sum")}
    out["passes"] = [p["passes"] for p in res.iter_phases]
    return out


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return type(a) is type(b) and (a == b or (a != a and b != b))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("write_outputs", [False, True])
def test_graphed_fit_is_the_eager_fit(cuda_device, tmp_path, monkeypatch, kind, write_outputs):
    dm, y, beta = _card_problem(kind, cuda_device)
    runs = {}
    for eager in (True, False):
        d = tmp_path / ("eager" if eager else "graph")
        d.mkdir()
        runs[eager] = (_card_fit(dm, y, beta, d, write_outputs, eager, monkeypatch), d)
    (want, want_counts), want_dir = runs[True]
    (got, got_counts), got_dir = runs[False]
    assert got.iterations_run == CARD_ITERS and got.solver == "eigen"
    assert _same(_fields(got), _fields(want))
    assert got_counts == want_counts  # passes over X and every kernel's launches
    assert [p["graph_replays"] for p in want.iter_phases] == [0] * CARD_ITERS
    # iteration 1 undamped, 2 warms the graph's stream, 3 captures, 3.. replay
    assert [p["graph_replays"] for p in got.iter_phases] == [0, 0] + [1] * (CARD_ITERS - 2)
    assert ["graph_capture" in p for p in got.iter_phases] == [False, False, True] + [
        False] * (CARD_ITERS - 3)
    if write_outputs:
        names = sorted(os.listdir(want_dir))
        assert names == sorted(os.listdir(got_dir)) and len(names) == 3 + 2 * CARD_ITERS
        for name in names:
            assert (want_dir / name).read_bytes() == (got_dir / name).read_bytes(), name


@pytest.mark.cuda
def test_an_eager_iteration_synchronises_nothing_once_its_numbers_exist(cuda_device):
    dm, y, beta = _card_problem("int8", cuda_device)
    lam, U = torch.linalg.eigh(build_spectral(dm).K.double())
    ef = EigenFactor(U=U.to(dm.wd), lam=lam)
    prior = init_prior([0.9, 0.07, 0.03], [0.0, 1e-3, 1e-2], CARD_N, device=cuda_device)
    yt = torch.as_tensor(y, dtype=dm.wd, device=cuda_device)
    ts = torch.as_tensor(beta, dtype=dm.wd, device=cuda_device)
    aty = operator.atx(dm, yt)
    r1 = aty * 3.0
    gam1 = f64(0.7, cuda_device)
    gamw = f64(3.0, cuda_device)
    k = Consts(cuda_device)

    def iteration():
        p = tlin._em_phase(dm, r1, gam1, prior, 1, 1e-2, True, 0.5, 0.0, consts=k)
        out = tlin._iteration_phase_exact(dm, ef, aty, yt, r1, gam1, p, r1, True, 0.5, gamw,
                                          ts, k)
        return tlin._outputs(gam1, out, p)

    iteration()  # makes the numbers
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        host = iteration()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(host).all())
