"""The port's linear engine against the JAX engine (vampomi_tpu/engine/linear.py)
and the numpy oracle (tests/reference_impl.py) on the CPU.

Phases are compared one by one in f64 on identical inputs (JAX state carried
over by convert.py, the same Rademacher probe for CG).  Whole trajectories:
eigen against the JAX engine (deterministic), CG against the oracle with the
probes injected — seeds cannot match across the two frameworks' RNGs."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.engine import linear as jlin
from vampomi_tpu.ops import eigen as jeig
from vampomi_tpu.ops import operator as jop
from vampomi_tpu.ops import spectral as jspec
from vampomi_tpu.prior import mixture as jmix
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.io.bin_io import read_bin_slab
from vampomi_tpu_torch.io.csv_writer import read_positional_csv
from vampomi_tpu_torch.ops.operator import build_design
from vampomi_tpu_torch.sim.data_sim import simulate_iid

from tests.reference_impl import NumpyVampOracle

torch.set_num_threads(2)

PROBS3 = [0.9, 0.07, 0.03]
VARS3 = [0.0, 1e-3, 1e-2]
PHASE_RTOL = 1e-9


def _arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def cfg_kw(tmp, **kw):
    d = dict(
        out_dir=str(tmp), out_name="t", iterations=3, rho=0.5, h2=0.8,
        gam1=1e-6, probs=list(PROBS3), vars=list(VARS3),
        CG_max_iter=500, CG_err_tol=1e-5, EM_max_iter=1, EM_err_thr=1e-2,
        learn_vars=1, learn_prior_delay=1, merge_vars_thr=0.5,
        stop_criteria_thr=1e-8, seed=7,
    )
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def fx():
    return simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42)


@pytest.fixture(scope="module")
def pair(fx):
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    return jdm, convert.design_from_arrays(_arrays(jdm))


@pytest.fixture(scope="module")
def state(fx, pair):
    """A mid-trajectory state shared by the phase comparisons."""
    jdm, tdm = pair
    rng = np.random.default_rng(11)
    m, n = tdm.m_pad, int(tdm.n)
    beta = fx.beta * np.sqrt(n)
    return dict(
        r1=beta + rng.normal(size=m) * 0.5,
        x1_prev=beta * 0.8 + rng.normal(size=m) * 0.1,
        mu_warm=beta * 0.5,
        bern=rng.choice([-1.0, 1.0], size=m) / np.sqrt(m),
        y=fx.y / np.std(fx.y),
        ts=fx.beta,
        gam1=0.7, gamw=3.0, rho=0.5,
    )


def _compare_outputs(got: dict, want: dict, rtol=PHASE_RTOL):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        if k == "cg_iters":
            assert int(g) == int(w), k
            continue
        atol = rtol * np.abs(w).max() if w.ndim else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("budget", [0.0, 20.0])
def test_em_phase_matches_jax(pair, state, budget):
    jdm, tdm = pair
    jp = jmix.init_prior(PROBS3 + [0.0], VARS3 + [1.05e-2], int(tdm.n))  # a near-duplicate slab
    tp = convert.prior_from_arrays(_arrays(jp))
    r1 = state["r1"] * 1.5
    want = jlin._em_phase(jdm, jnp.asarray(r1), jnp.asarray(0.7), jp, jnp.asarray(3),
                          jnp.asarray(1e-4), jnp.asarray(True), jnp.asarray(0.5),
                          jnp.asarray(budget))
    got = tlin._em_phase(tdm, torch.as_tensor(r1), torch.tensor(0.7, dtype=torch.float64),
                         tp, 3, 1e-4, True, 0.5, budget)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), rtol=1e-12)
    np.testing.assert_allclose(got.vars.numpy(), np.asarray(want.vars), rtol=1e-12)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))


@pytest.mark.parametrize("damp", [False, True])
def test_cg_iteration_phase_matches_jax(pair, state, damp):
    jdm, tdm = pair
    s = state
    jp = jmix.init_prior(PROBS3, VARS3, int(tdm.n))
    tp = convert.prior_from_arrays(_arrays(jp))
    aty_j = jop.atx(jdm, jnp.asarray(s["y"]))
    want = jlin._iteration_phase(
        jdm, aty_j, jnp.asarray(s["y"]), jnp.asarray(s["r1"]), jnp.asarray(s["gam1"]), jp,
        jnp.asarray(s["x1_prev"]), jnp.asarray(damp), jnp.asarray(s["rho"]),
        jnp.asarray(s["gamw"]), jnp.asarray(s["mu_warm"]), jnp.asarray(s["bern"]),
        jnp.asarray(s["ts"]), jnp.asarray(500), jnp.asarray(1e-7))
    t = {k: torch.as_tensor(s[k]) for k in ("r1", "x1_prev", "mu_warm", "bern", "y", "ts")}
    got = tlin._iteration_phase(
        tdm, torch.tensor(np.asarray(aty_j)), t["y"], t["r1"], s["gam1"], tp,
        t["x1_prev"], damp, s["rho"], s["gamw"], t["mu_warm"], t["bern"], t["ts"],
        500, 1e-7)
    _compare_outputs(got, want)


@pytest.fixture(scope="module")
def eig_pair(pair):
    jdm, _ = pair
    jef, _ = jeig.build_eigen(jspec.build_spectral(jdm), leaf=2048)
    return jef, convert.eigen_from_arrays(_arrays(jef))


@pytest.mark.parametrize("damp", [False, True])
def test_eigen_iteration_phase_matches_jax(pair, state, eig_pair, damp):
    jdm, tdm = pair
    jef, tef = eig_pair
    s = state
    jp = jmix.init_prior(PROBS3, VARS3, int(tdm.n))
    tp = convert.prior_from_arrays(_arrays(jp))
    aty_j = jop.atx(jdm, jnp.asarray(s["y"]))
    want = jlin._iteration_phase_eigen(
        jdm, jef, aty_j, jnp.asarray(s["y"]), jnp.asarray(s["r1"]), jnp.asarray(s["gam1"]),
        jp, jnp.asarray(s["x1_prev"]), jnp.asarray(damp), jnp.asarray(s["rho"]),
        jnp.asarray(s["gamw"]), jnp.asarray(s["ts"]))
    got = tlin._iteration_phase_eigen(
        tdm, tef, torch.tensor(np.asarray(aty_j)), torch.as_tensor(s["y"]),
        torch.as_tensor(s["r1"]), s["gam1"], tp, torch.as_tensor(s["x1_prev"]), damp,
        s["rho"], s["gamw"], torch.as_tensor(s["ts"]))
    _compare_outputs(got, want)


def _csv_rows(d, name):
    return np.asarray(read_positional_csv(os.path.join(d, name)))


@pytest.fixture(scope="module")
def eigen_runs(fx, tmp_path_factory):
    """The whole eigen trajectory, 4 iterations in f64, in both packages."""
    jdir = tmp_path_factory.mktemp("jax_eig")
    tdir = tmp_path_factory.mktemp("torch_eig")
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    jres = jlin.infere_linear(jdm, fx.y, JConfig(**cfg_kw(jdir, iterations=4, lmmse_solver="eigen")),
                              true_signal=fx.beta)
    tdm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    tres = tlin.infere_linear(tdm, fx.y, RunConfig(**cfg_kw(
        tdir, iterations=4, lmmse_solver="eigen", device="cpu")), true_signal=fx.beta)
    return jdir, jres, tdir, tres


def test_eigen_trajectory_matches_jax(eigen_runs, fx):
    """Per-iteration params and metrics to rtol 1e-6 (the eigenvectors come
    from two eigh implementations; U diag(d) U^T is invariant to their sign
    and order, so only rounding differs)."""
    jdir, jres, tdir, tres = eigen_runs
    assert tres.iterations_run == jres.iterations_run == 4
    for name in ("t_params.csv", "t_metrics.csv", "t_prior.csv"):
        got, want = _csv_rows(tdir, name), _csv_rows(jdir, name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tres.gamw, jres.gamw, rtol=1e-6)


@pytest.mark.parametrize("it", [1, 2, 3, 4])
def test_eigen_iteration_dumps_match_jax(eigen_runs, fx, it):
    jdir, _, tdir, _ = eigen_runs
    m = fx.X.shape[1]
    for kind in ("it", "r1_it"):
        got = read_bin_slab(os.path.join(tdir, f"t_{kind}_{it}.bin"), m)
        want = read_bin_slab(os.path.join(jdir, f"t_{kind}_{it}.bin"), m)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9 * max(scale, 1e-300))


@pytest.fixture(scope="module")
def cg_run(fx, tmp_path_factory):
    """The CG trajectory with the oracle's probes injected into the port's
    probe helper (the seeded draw itself cannot match across frameworks)."""
    tmp = tmp_path_factory.mktemp("torch_cg")
    m = fx.X.shape[1]
    rng = np.random.default_rng(123)
    probes = [rng.choice([-1.0, 1.0], size=m) / np.sqrt(m) for _ in range(4)]
    feed = iter(probes)
    mp = pytest.MonkeyPatch()
    mp.setattr(tlin, "_draw_probe", lambda gen, dm: torch.as_tensor(next(feed)))
    try:
        cfg = RunConfig(**cfg_kw(tmp, iterations=4, lmmse_solver="cg", device="cpu"))
        tdm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
        res = tlin.infere_linear(tdm, fx.y, cfg, true_signal=fx.beta)
    finally:
        mp.undo()
    oracle = NumpyVampOracle(
        fx.X, fx.y, PROBS3, VARS3, gam1=cfg.gam1, h2=cfg.h2, rho=cfg.rho,
        cg_max_iter=cfg.CG_max_iter, cg_err_tol=cfg.CG_err_tol,
        em_max_iter=cfg.EM_max_iter, em_err_thr=cfg.EM_err_thr,
        learn_vars=cfg.learn_vars, learn_prior_delay=cfg.learn_prior_delay,
        merge_vars_thr=cfg.merge_vars_thr, stop_criteria_thr=cfg.stop_criteria_thr,
    )
    return tmp, res, oracle.run(cfg.iterations, probes)


def test_cg_trajectory_matches_oracle(cg_run):
    """Tolerances of tests/test_engine_linear.py:68-79: CG stops at
    rel-residual 1e-5, so CG-derived quantities agree to ~1e-4."""
    tmp, res, hist = cg_run
    params = read_positional_csv(os.path.join(tmp, "t_params.csv"))
    assert len(params) == len(hist) == 4
    for row, h in zip(params, hist):
        it, alpha1, gam1_pre, alpha2, gam2, gamw = row
        assert int(it) == h["it"]
        np.testing.assert_allclose(alpha1, h["alpha1"], rtol=1e-6)
        np.testing.assert_allclose(gam1_pre, h["gam1_pre"], rtol=1e-6)
        np.testing.assert_allclose(alpha2, h["alpha2"], rtol=1e-4)
        np.testing.assert_allclose(gam2, h["gam2"], rtol=1e-5)
        np.testing.assert_allclose(gamw, h["gamw"], rtol=1e-4)


def test_cg_artifacts_and_prior_match_oracle(cg_run, fx):
    tmp, res, hist = cg_run
    n, m = fx.X.shape
    for h in hist:
        x1 = read_bin_slab(os.path.join(tmp, f"t_it_{h['it']}.bin"), m)
        np.testing.assert_allclose(x1, h["x1_hat"] / np.sqrt(n), rtol=1e-4, atol=1e-12)
    r1_2 = read_bin_slab(os.path.join(tmp, "t_r1_it_2.bin"), m)
    np.testing.assert_allclose(r1_2, hist[0]["r1"] / np.sqrt(n), rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(np.sort(res.probs), np.sort(hist[-1]["probs"]), rtol=1e-5)
    np.testing.assert_allclose(np.sort(res.vars), np.sort(hist[-1]["vars"]), rtol=1e-4)


def _jax_engine_probes(seed, n_iter, m, dtype):
    """The JAX engine's seeded probes (engine/linear.py:885-906), replayed."""
    import jax

    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_iter):
        key, sub = jax.random.split(key)
        b = jax.random.rademacher(sub, (m,), dtype=dtype) * jnp.asarray(
            1.0 / np.sqrt(float(m)), dtype=dtype)
        out.append(torch.as_tensor(np.array(b)))
    return out


@pytest.mark.parametrize("solver", ["eigen", "cg"])
def test_int8_design_end_to_end_matches_jax_int8(fx, tmp_path, monkeypatch, solver):
    """The int8 design against the JAX int8 run (CG with the JAX engine's
    own probes replayed into the port).  Looser tolerance: on the CPU the
    JAX int8 products round w and y to bf16 (~4e-3 relative per entry,
    operator.py:186-197) where the port's stay f32, and the two trajectories
    drift apart by up to ~1e-2 relative over 4 iterations."""
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.int8)
    kw = cfg_kw(tmp_path, iterations=4, lmmse_solver=solver)
    jres = jlin.infere_linear(jdm, fx.y, JConfig(**kw), true_signal=fx.beta,
                              write_outputs=False)
    feed = iter(_jax_engine_probes(kw["seed"], 4, fx.X.shape[1], jnp.float32))
    monkeypatch.setattr(tlin, "_draw_probe", lambda gen, dm: next(feed))
    tdm = build_design(fx.X.T, compute_dtype=torch.int8, device="cpu")
    tres = tlin.infere_linear(tdm, fx.y, RunConfig(**kw, device="cpu"),
                              true_signal=fx.beta, write_outputs=False)
    got = np.asarray(tres.metrics_history)
    want = np.asarray(jres.metrics_history)
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(tres.gamw, jres.gamw, rtol=2e-2)
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled,
                               atol=2e-2 * np.abs(jres.x1_hat_scaled).max())
    c_t = np.corrcoef(tres.x1_hat_scaled, fx.beta)[0, 1]
    c_j = np.corrcoef(jres.x1_hat_scaled, fx.beta)[0, 1]
    assert abs(c_t - c_j) < 1e-2 and c_t > 0.75


def test_choose_lmmse_solver_keeps_the_jax_rule(tmp_path):
    for solver in ("auto", "cg", "eigen", "spectral"):
        for mt, n in ((500, 300), (40000, 4096), (40000, 20000), (8000, 2048), (8191, 2048)):
            kw = cfg_kw(tmp_path, lmmse_solver=solver)
            assert tlin.choose_lmmse_solver(RunConfig(**kw), mt, n) == \
                jlin.choose_lmmse_solver(JConfig(**kw), mt, n), (solver, mt, n)


def test_auto_solver_resolving_to_spectral_raises(tmp_path):
    """N >= 2048 and Mt >= 4N: auto resolves to spectral, which the port
    lacks; it raises and names the solvers that run, never swaps one in."""
    dm = build_design(np.random.default_rng(0).normal(size=(8192, 2048)).astype(np.float32),
                      compute_dtype=torch.float32, device="cpu")
    cfg = RunConfig(**cfg_kw(tmp_path, lmmse_solver="auto", device="cpu"))
    with pytest.raises(NotImplementedError, match="--lmmse-solver eigen"):
        tlin.infere_linear(dm, np.ones(2048), cfg, write_outputs=False)


def test_warn_em_stability_matches_jax(tmp_path, capsys):
    for learn_vars, mt, n in ((1, 1600, 100), (1, 1500, 100), (0, 1600, 100)):
        kw = cfg_kw(tmp_path, learn_vars=learn_vars)
        assert tlin.warn_em_stability(RunConfig(**kw), mt, n) == \
            jlin.warn_em_stability(JConfig(**kw), mt, n)
    assert "M/N = 16" in capsys.readouterr().err


def test_probe_is_seeded_rademacher(pair):
    _, tdm = pair
    draws = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(5)
        draws.append(tlin._draw_probe(g, tdm))
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    vals = np.unique(np.abs(draws[0].numpy()))
    np.testing.assert_allclose(vals, [1.0 / math.sqrt(tdm.mt)], rtol=1e-15)
    assert abs(draws[0].numpy().sum()) < 4 * math.sqrt(tdm.mt) / math.sqrt(tdm.mt)


@pytest.mark.parametrize("field,value", [("resume_file", "x.npz"), ("checkpoint_file", "x.npz"),
                                         ("eigen_cache", "e.npz"), ("C", 2)])
def test_unported_engine_options_raise(pair, tmp_path, field, value):
    _, tdm = pair
    cfg = RunConfig(**cfg_kw(tmp_path, device="cpu", **{field: value}))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlin.infere_linear(tdm, np.ones(int(tdm.n)), cfg, write_outputs=False)
