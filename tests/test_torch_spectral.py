"""The port's spectral LMMSE solver (vampomi_tpu_torch/ops/spectral.py and the
spectral phase of engine/linear.py) against the JAX package's on the CPU.

The dense pieces are compared in f64 on identical inputs (JAX state carried
over by convert.py), including the JAX package's blocked factor (nb = 4 at
N = 600); whole spectral trajectories in f64 against
vampomi_tpu.engine.linear.infere_linear(lmmse_solver="spectral") to rtol 1e-6,
as the eigen trajectory is held; the int8 design as the eigen int8 test holds
it.  The solver choice: auto at N >= 2048 and Mt >= 4N runs spectral, and
both eigen fallbacks run it instead of raising."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.engine import linear as jlin
from vampomi_tpu.ops import operator as jop
from vampomi_tpu.ops import spectral as jspec
from vampomi_tpu.prior import mixture as jmix
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.io.bin_io import read_bin_slab
from vampomi_tpu_torch.io.csv_writer import read_positional_csv
from vampomi_tpu_torch.ops import spectral as tspec
from vampomi_tpu_torch.ops.operator import build_design
from vampomi_tpu_torch.sim.data_sim import simulate_iid

from tests.test_torch_engine_linear import PHASE_RTOL, _arrays, _compare_outputs, cfg_kw

torch.set_num_threads(2)

PROBS3 = [0.9, 0.07, 0.03]
VARS3 = [0.0, 1e-3, 1e-2]
SHIFTS = [(2.5, 0.7), (17.3, 1e-3), (0.3, 40.0)]


@pytest.fixture(scope="module")
def fx():
    return simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42)


@pytest.fixture(scope="module")
def pair(fx):
    """The f64 design and its Gram factor in both packages."""
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    jfac = jspec.build_spectral(jdm, block=128)
    return jdm, jfac, convert.design_from_arrays(_arrays(jdm)), convert.gram_from_arrays(
        _arrays(jfac))


@pytest.fixture(scope="module")
def wide_fac():
    """An N = 600 Gram factor, where JAX's shift_inverse runs its blocked
    path at nb = 4 (600 / 4 = 150-row blocks)."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((600, 1500)) / np.sqrt(1500)
    K = A @ A.T
    return jspec.GramFactor(K=jnp.asarray(K)), tspec.GramFactor(K=torch.as_tensor(K))


@pytest.mark.parametrize("tau,gam2", SHIFTS)
@pytest.mark.parametrize("nb", [1, 4])
def test_shift_inverse_matches_jax(pair, wide_fac, tau, gam2, nb):
    """W = L^{-1} and T = ||W||_F^2 equal JAX's fused blocked pass in f64,
    at N = 300 (nb blocks of the direct leaf) and N = 600."""
    _, jfac, _, tfac = pair
    for jf, tf in ((jfac, tfac), wide_fac):
        want = jspec.shift_inverse(jf, tau, gam2, nb=nb)
        got = tspec.shift_inverse(tf, tau, gam2)
        W = np.asarray(want.W)
        np.testing.assert_allclose(got.W.numpy(), W, rtol=1e-9, atol=1e-11 * np.abs(W).max())
        np.testing.assert_allclose(float(got.T), float(want.T), rtol=1e-12)
        assert got.T.dtype == torch.float64
        b = np.random.default_rng(3).normal(size=tf.n)
        np.testing.assert_allclose(got.solve(torch.as_tensor(b)).numpy(),
                                   np.asarray(want.solve(jnp.asarray(b))), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("tau,gam2", SHIFTS)
def test_shift_cholesky_matches_jax(pair, tau, gam2):
    _, jfac, _, tfac = pair
    want = np.asarray(jspec.shift_cholesky(jfac, tau, gam2))
    got = tspec.shift_cholesky(tfac, tau, gam2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("route", ["winv", "L", "none"])
@pytest.mark.parametrize("tau,gam2", SHIFTS)
def test_spectral_solve_matches_jax(pair, route, tau, gam2):
    """mu and q = A mu through the inverse factor, a shift Cholesky, or one
    factored inside; A v given or not."""
    jdm, jfac, tdm, tfac = pair
    v = np.random.default_rng(0).normal(size=tdm.m_pad)
    jkw = {"winv": jspec.shift_inverse(jfac, tau, gam2)} if route == "winv" else (
        {"L": jspec.shift_cholesky(jfac, tau, gam2)} if route == "L" else {})
    tkw = {"winv": tspec.shift_inverse(tfac, tau, gam2)} if route == "winv" else (
        {"L": tspec.shift_cholesky(tfac, tau, gam2)} if route == "L" else {})
    jmu, jq = jspec.spectral_solve(jdm, jfac, jnp.asarray(v), tau, gam2, **jkw)
    tmu, tq = tspec.spectral_solve(tdm, tfac, torch.as_tensor(v), tau, gam2, **tkw)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("route", ["winv", "L", "none"])
@pytest.mark.parametrize("tau,gam2", SHIFTS)
def test_spectral_traces_match_jax(pair, route, tau, gam2):
    """Both closed forms from the inverse factor's T or from ||L^{-1}||_F^2,
    against JAX's (whose L route is its blocked forward substitution)."""
    jdm, jfac, _, tfac = pair
    jkw = {"winv": jspec.shift_inverse(jfac, tau, gam2)} if route == "winv" else (
        {"L": jspec.shift_cholesky(jfac, tau, gam2)} if route == "L" else {})
    tkw = {"winv": tspec.shift_inverse(tfac, tau, gam2)} if route == "winv" else (
        {"L": tspec.shift_cholesky(tfac, tau, gam2)} if route == "L" else {})
    want = jspec.spectral_traces(jfac, jdm.mt, tau, gam2, **jkw)
    got = tspec.spectral_traces(tfac, jdm.mt, tau, gam2, **tkw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(float(g), float(w), rtol=1e-11)


def test_shift_inverse_from_jax_state(pair):
    """convert.shift_inverse_from_arrays carries JAX's W and T as they are."""
    _, jfac, _, tfac = pair
    jw = jspec.shift_inverse(jfac, 2.5, 0.7)
    tw = convert.shift_inverse_from_arrays(_arrays(jw))
    np.testing.assert_array_equal(tw.W.numpy(), np.asarray(jw.W))
    assert float(tw.T) == float(jw.T) and tw.T.dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_failed_cholesky_raises_never_nan(pair, dtype):
    """S = gam2 I + tau K with tau < 0 is not positive definite: the factor
    raises, naming the shift; it returns no NaNs and swaps in no solver."""
    *_, tfac = pair
    fac = tspec.GramFactor(K=tfac.K.to(dtype))
    for fn in (tspec.shift_cholesky, tspec.shift_inverse):
        with pytest.raises(RuntimeError, match="not positive definite"):
            fn(fac, -2.5, 0.7)
    with pytest.raises(RuntimeError, match="leading minor"):
        tspec.spectral_traces(fac, 500, -2.5, 0.7)


@pytest.fixture(scope="module")
def state(fx, pair):
    rng = np.random.default_rng(11)
    *_, tdm, _ = pair
    m, n = tdm.m_pad, int(tdm.n)
    beta = fx.beta * np.sqrt(n)
    return dict(r1=beta + rng.normal(size=m) * 0.5, x1_prev=beta * 0.8 + rng.normal(size=m) * 0.1,
                y=fx.y / np.std(fx.y), ts=fx.beta, gam1=0.7, gamw=3.0, rho=0.5)


@pytest.mark.parametrize("damp", [False, True])
def test_spectral_iteration_phase_matches_jax(pair, state, damp):
    jdm, jfac, tdm, tfac = pair
    s = state
    jp = jmix.init_prior(PROBS3, VARS3, int(tdm.n))
    tp = convert.prior_from_arrays(_arrays(jp))
    aty_j = jop.atx(jdm, jnp.asarray(s["y"]))
    want = jlin._iteration_phase_spectral(
        jdm, jfac, aty_j, jnp.asarray(s["y"]), jnp.asarray(s["r1"]), jnp.asarray(s["gam1"]),
        jp, jnp.asarray(s["x1_prev"]), jnp.asarray(damp), jnp.asarray(s["rho"]),
        jnp.asarray(s["gamw"]), jnp.asarray(s["ts"]))
    got = tlin._iteration_phase_spectral(
        tdm, tfac, torch.tensor(np.asarray(aty_j)), torch.as_tensor(s["y"]),
        torch.as_tensor(s["r1"]), s["gam1"], tp, torch.as_tensor(s["x1_prev"]), damp,
        s["rho"], s["gamw"], torch.as_tensor(s["ts"]))
    _compare_outputs(got, want, rtol=PHASE_RTOL)


def _csv_rows(d, name):
    return np.asarray(read_positional_csv(os.path.join(d, name)))


@pytest.fixture(scope="module")
def spectral_runs(fx, tmp_path_factory):
    """The whole spectral trajectory, 4 iterations in f64, in both packages."""
    jdir = tmp_path_factory.mktemp("jax_spec")
    tdir = tmp_path_factory.mktemp("torch_spec")
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    jres = jlin.infere_linear(jdm, fx.y, JConfig(**cfg_kw(jdir, iterations=4,
                                                          lmmse_solver="spectral")),
                              true_signal=fx.beta)
    tdm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    tres = tlin.infere_linear(tdm, fx.y, RunConfig(**cfg_kw(
        tdir, iterations=4, lmmse_solver="spectral", device="cpu")), true_signal=fx.beta)
    return jdir, jres, tdir, tres


def test_spectral_trajectory_matches_jax(spectral_runs):
    """Per-iteration params, metrics and prior to rtol 1e-6 in f64."""
    jdir, jres, tdir, tres = spectral_runs
    assert tres.iterations_run == jres.iterations_run == 4
    assert tres.solver == "spectral"
    for name in ("t_params.csv", "t_metrics.csv", "t_prior.csv"):
        got, want = _csv_rows(tdir, name), _csv_rows(jdir, name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tres.r1_scaled, jres.r1_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tres.gamw, jres.gamw, rtol=1e-6)
    assert set(tres.setup) == {"aty", "gram"}


@pytest.mark.parametrize("it", [1, 2, 3, 4])
def test_spectral_iteration_dumps_match_jax(spectral_runs, fx, it):
    jdir, _, tdir, _ = spectral_runs
    m = fx.X.shape[1]
    for kind in ("it", "r1_it"):
        got = read_bin_slab(os.path.join(tdir, f"t_{kind}_{it}.bin"), m)
        want = read_bin_slab(os.path.join(jdir, f"t_{kind}_{it}.bin"), m)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9 * np.abs(want).max())


def test_spectral_trace_names_the_solver(spectral_runs):
    """The trace records the solver that ran, with two X passes an
    iteration."""
    import json

    _, _, tdir, _ = spectral_runs
    recs = [json.loads(line) for line in open(os.path.join(tdir, "t_trace.jsonl"))]
    assert len(recs) == 4 and all(r["matrix_passes"] == 2 for r in recs)


def test_int8_spectral_end_to_end_matches_jax_int8(fx, tmp_path):
    """The int8 design against the JAX int8 spectral run, with the
    tolerance of the eigen int8 test (the JAX CPU products round w and y to
    bf16 where the port's stay f32)."""
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.int8)
    kw = cfg_kw(tmp_path, iterations=4, lmmse_solver="spectral")
    jres = jlin.infere_linear(jdm, fx.y, JConfig(**kw), true_signal=fx.beta,
                              write_outputs=False)
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


def _run(dm, y, tmp, **kw):
    cfg = RunConfig(**cfg_kw(tmp, device="cpu", **kw))
    return tlin.infere_linear(dm, y, cfg, write_outputs=False)


def _same_trajectory(a, b):
    np.testing.assert_array_equal(np.asarray(a.metrics_history), np.asarray(b.metrics_history))
    np.testing.assert_array_equal(a.x1_hat_scaled, b.x1_hat_scaled)
    assert a.gamw == b.gamw


def test_auto_solver_at_the_users_shape_runs_spectral(tmp_path):
    """N = 2048, Mt = 8192 (N >= 2048 and Mt >= 4N): auto resolves to
    spectral, as the JAX rule does, and runs its trajectory."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8192, 2048)).astype(np.float32)
    y = rng.normal(size=2048)
    dm = build_design(X, compute_dtype=torch.float32, device="cpu")
    assert jlin.choose_lmmse_solver(JConfig(lmmse_solver="auto"), 8192, 2048) == "spectral"
    auto = _run(dm, y, tmp_path, lmmse_solver="auto", iterations=2)
    assert auto.solver == "spectral"
    assert np.all(np.isfinite(np.asarray(auto.metrics_history)))
    _same_trajectory(auto, _run(dm, y, tmp_path, lmmse_solver="spectral", iterations=2))


@pytest.mark.parametrize("cause", ["residual", "budget"])
def test_eigen_fallbacks_run_the_spectral_trajectory(fx, tmp_path, monkeypatch, capsys, cause):
    """An eigen residual above tolerance, or an eigen build over its
    budget, falls back to the per-iteration spectral solver with the JAX
    engine's log lines, and gives the spectral trajectory."""
    dm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    kw = dict(iterations=3)
    if cause == "residual":
        monkeypatch.setattr(tlin, "EIGEN_RESID_TOL", -1.0)
        line = "eigen residual above tolerance — falling back to the per-iteration factor path"
    else:
        kw["eigen_build_budget"] = 1e-9
        line = ("eigen build exceeded --eigen-build-budget 0s — falling back to the "
                "per-iteration spectral factor path")
    res = _run(dm, fx.y, tmp_path, lmmse_solver="eigen", **kw)
    assert line in capsys.readouterr().out
    assert res.solver == "spectral"
    _same_trajectory(res, _run(dm, fx.y, tmp_path, lmmse_solver="spectral", **kw))


def test_eigen_within_tolerance_and_budget_stays_eigen(fx, tmp_path):
    dm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    res = _run(dm, fx.y, tmp_path, lmmse_solver="eigen", iterations=2, eigen_build_budget=1e6)
    assert res.solver == "eigen" and res.setup["eigen_resid"] < tlin.EIGEN_RESID_TOL
