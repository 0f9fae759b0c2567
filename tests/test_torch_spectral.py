"""The port's spectral LMMSE solver (vampomi_tpu_torch/ops/spectral.py and the
spectral phase of engine/linear.py) against the JAX package's on the CPU.

The dense pieces are compared in f64 on identical inputs (JAX state carried
over by convert.py): the blocked factor and its recursion run the JAX
package's algorithm at the same block counts, and the Gram factor's one
method, `GramFactor.solve`, is held to each of JAX's solve routes; whole
spectral trajectories in f64 against
vampomi_tpu.engine.linear.infere_linear(lmmse_solver="spectral") to rtol 1e-6,
as the eigen trajectory is held; the int8 design as the eigen int8 test holds
it.  The solver choice: auto at N >= 2048 and Mt >= 4N runs spectral, and
both eigen fallbacks run it instead of raising."""

import json
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
from vampomi_tpu_torch.ops.operator import atx, ax, build_design
from vampomi_tpu_torch.sim.data_sim import simulate_iid
from vampomi_tpu_torch.tools import dense_step_probe

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


# the leaf size of _factor_diag: JAX's (the same algorithm as JAX's at the
# same block count) and the port's own
BASES = [jspec._FACTOR_BASE, tspec._FACTOR_BASE]


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("tau,gam2", SHIFTS)
@pytest.mark.parametrize("nb", [1, 4])
def test_shift_inverse_matches_jax(pair, wide_fac, tau, gam2, nb, base, monkeypatch):
    """W = L^{-1} and T = ||W||_F^2 equal JAX's fused blocked pass in f64 at
    the same block count, at N = 300 and N = 600, with JAX's leaf size and
    the port's."""
    monkeypatch.setattr(tspec, "_FACTOR_BASE", base)
    _, jfac, _, tfac = pair
    for jf, tf in ((jfac, tfac), wide_fac):
        want = jspec.shift_inverse(jf, tau, gam2, nb=nb)
        got = tspec.shift_inverse(tf, tau, gam2, nb=nb)
        W = np.asarray(want.W)
        np.testing.assert_allclose(got.W.numpy(), W, rtol=1e-9, atol=1e-11 * np.abs(W).max())
        np.testing.assert_allclose(float(got.T), float(want.T), rtol=1e-12)
        assert got.T.dtype == torch.float64
        b = np.random.default_rng(3).normal(size=tf.n)
        np.testing.assert_allclose(got.solve(torch.as_tensor(b)).numpy(),
                                   np.asarray(want.solve(jnp.asarray(b))), rtol=1e-9, atol=1e-12)


def _spd(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, 2 * n)) / np.sqrt(2 * n)
    return 2.5 * (A @ A.T) + 0.7 * np.eye(n)


# the leaves' offsets by leaf size and block: at JAX's 256 one leaf at 256,
# a split 128 + 129 at 257, and at 700 two levels (384 = 256 + 128, then
# 316 = 256 + 60); at the port's 512 one leaf up to 512, and 384 + 316 at 700
LEAVES = {256: {256: [0], 257: [0, 128], 700: [0, 256, 384, 640]},
          512: {256: [0], 257: [0], 700: [0, 384]}}


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("b", [256, 257, 700])
def test_factor_diag_matches_jax(b, base, monkeypatch):
    """The 2x2 recursion's L and W against JAX's _factor_diag in f64, with
    JAX's leaf size (the same recursion) and the port's."""
    monkeypatch.setattr(tspec, "_FACTOR_BASE", base)
    S = _spd(b, b)
    jL, jW = (np.asarray(x) for x in jspec._factor_diag(jnp.asarray(S)))
    A, W, infos = torch.as_tensor(S).clone(), torch.zeros(b, b, dtype=torch.float64), []
    tspec._factor_diag(A, W, infos)
    assert [off for off, _ in infos] == LEAVES[base][b]
    assert all(int(i) == 0 for _, i in infos)
    for got, want in ((torch.tril(A).numpy(), jL), (W.numpy(), jW)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("tau,gam2", SHIFTS)
def test_shift_inverse_ragged_blocks_match_jax(tau, gam2):
    """N = 601 over 4 blocks (150, 150, 150, 151 rows, each one leaf at
    either leaf size): W, T and a solve against JAX's in f64."""
    K = _spd(601, 2)
    want = jspec.shift_inverse(jspec.GramFactor(K=jnp.asarray(K)), tau, gam2, nb=4)
    got = tspec.shift_inverse(tspec.GramFactor(K=torch.as_tensor(K)), tau, gam2, nb=4)
    W = np.asarray(want.W)
    np.testing.assert_allclose(got.W.numpy(), W, rtol=1e-9, atol=1e-11 * np.abs(W).max())
    np.testing.assert_allclose(float(got.T), float(want.T), rtol=1e-12)
    b = np.random.default_rng(4).normal(size=601)
    np.testing.assert_allclose(got.solve(torch.as_tensor(b)).numpy(),
                               np.asarray(want.solve(jnp.asarray(b))), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n,port,jax", [(1, 1, 1), (255, 1, 1), (2047, 1, 1), (2048, 4, 8),
                                        (4095, 4, 8), (4096, 4, 16), (8191, 4, 16),
                                        (8192, 8, 16), (10240, 8, 16), (16384, 8, 16)])
def test_default_nb_against_jax(n, port, jax):
    """The port's block counts, tuned on an H100, against the JAX package's:
    the same single block below N = 2048, fewer blocks from there."""
    assert (tspec.default_nb(n), jspec.default_nb(n)) == (port, jax)


def _jax_route(jfac, route, tau, gam2):
    """JAX's spectral_solve / spectral_traces keywords for `route`: its
    inverse factor, its shift Cholesky, or neither (factored inside)."""
    if route == "winv":
        return {"winv": jspec.shift_inverse(jfac, tau, gam2)}
    return {"L": jspec.shift_cholesky(jfac, tau, gam2)} if route == "L" else {}


@pytest.mark.parametrize("route", ["winv", "L", "none"])
@pytest.mark.parametrize("tau,gam2", SHIFTS)
def test_spectral_solve_matches_jax(pair, route, tau, gam2):
    """q = S^{-1} A v of GramFactor.solve, and mu = (v - tau A^T q) / gam2
    as the engines form it, against JAX's spectral_solve through its
    inverse factor, its shift Cholesky or one factored inside."""
    jdm, jfac, tdm, tfac = pair
    v = np.random.default_rng(0).normal(size=tdm.m_pad)
    jmu, jq = jspec.spectral_solve(jdm, jfac, jnp.asarray(v), tau, gam2,
                                   **_jax_route(jfac, route, tau, gam2))
    tv = torch.as_tensor(v)
    tq, *_ = tfac.solve(ax(tdm, tv), tau, gam2, tdm.mt)
    tmu = (tv - tau * atx(tdm, tq)) / gam2
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("route", ["winv", "L", "none"])
@pytest.mark.parametrize("tau,gam2", SHIFTS)
def test_spectral_traces_match_jax(pair, route, tau, gam2):
    """Both closed forms of GramFactor.solve, from the inverse factor's T,
    against JAX's from its inverse factor's T or from ||L^{-1}||_F^2 (its
    blocked forward substitution)."""
    jdm, jfac, tdm, tfac = pair
    want = jspec.spectral_traces(jfac, jdm.mt, tau, gam2, **_jax_route(jfac, route, tau, gam2))
    b = torch.as_tensor(np.random.default_rng(0).normal(size=tfac.n))
    _, *got = tfac.solve(b, tau, gam2, jdm.mt)
    assert len(got) == 2
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
    with pytest.raises(RuntimeError, match="not positive definite"):
        tspec.shift_inverse(fac, -2.5, 0.7)
    with pytest.raises(RuntimeError, match="leading minor .*not positive definite"):
        fac.solve(torch.ones(fac.n, dtype=dtype), -2.5, 0.7, 500)


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_factor_failing_in_the_third_block_names_its_minor(dtype, base, monkeypatch):
    """S = L0 D L0^T with L0 unit lower triangular and D = I but -1 at row
    350: every leading minor through order 350 is positive, order 351 is
    not.  Over 4 blocks of 150 rows the first two factor and the third
    fails; the raise names global minor 351 (the block's offset 300 plus
    its leaf's info 51), as it does over the single block's recursion (at
    leaf size 256 the leaf at offset 256 reports 95, at 512 the leaf at 0
    reports 351), and through the factor's solve; nothing returns."""
    monkeypatch.setattr(tspec, "_FACTOR_BASE", base)
    n, p = 600, 350
    rng = np.random.default_rng(8)
    L0 = np.eye(n) + np.tril(rng.standard_normal((n, n)), -1) * 0.3 / np.sqrt(n)
    d = np.ones(n)
    d[p] = -1.0
    S = (L0 * d) @ L0.T
    fac = tspec.GramFactor(K=torch.as_tensor(S - 0.5 * np.eye(n), dtype=dtype))
    calls = [lambda: tspec.shift_inverse(fac, 1.0, 0.5, nb=4),
             lambda: tspec.shift_inverse(fac, 1.0, 0.5),
             lambda: fac.solve(torch.ones(n, dtype=dtype), 1.0, 0.5, 2 * n),
             lambda: fac.solve(torch.zeros(n, dtype=dtype), 1.0, 0.5, n)]
    for call in calls:
        with pytest.raises(RuntimeError, match=f"leading minor {p + 1} of {n} .*not positive"):
            call()
    infos = []
    A = fac.K.clone()
    A.diagonal().add_(0.5)
    tspec._shift_inverse_body(A, 4, infos)
    assert [int(i) for _, i in infos[:3]] == [0, 0, p + 1 - 300]


@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_engines_take_the_blocked_route(fx, tmp_path, monkeypatch, model):
    """Both engines' spectral iterations run shift_inverse's blocked body at
    default_nb(N) blocks, once an iteration."""
    from vampomi_tpu_torch.engine import probit as tprob

    calls, body = [], tspec._shift_inverse_body

    def spy(S, nb, infos):
        calls.append((S.shape[0], nb))
        return body(S, nb, infos)

    monkeypatch.setattr(tspec, "_shift_inverse_body", spy)
    dm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    cfg = RunConfig(**cfg_kw(tmp_path, iterations=2, lmmse_solver="spectral", device="cpu",
                             model=model))
    if model == "linear":
        res = tlin.infere_linear(dm, fx.y, cfg, write_outputs=False)
    else:
        res = tprob.infere_bin_class(dm, (fx.y > 0).astype(np.float64), cfg,
                                     write_outputs=False)
    assert res.solver == "spectral" and np.all(np.isfinite(res.x1_hat_scaled))
    assert calls == [(300, tspec.default_nb(300))] * 2


def _fit(model, dm, fx, cfg):
    from vampomi_tpu_torch.engine import probit as tprob

    if model == "linear":
        return tlin.infere_linear(dm, fx.y, cfg, write_outputs=False)
    return tprob.infere_bin_class(dm, (fx.y > 0).astype(np.float64), cfg, write_outputs=False)


@pytest.mark.parametrize("solver", ["spectral", "eigen"])
@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_exact_iterations_take_the_factors_solve(fx, tmp_path, monkeypatch, model, solver):
    """Both engines' exact iterations take their N x N step through the
    factor's one method, once an iteration, with A v of the N samples and
    the Mt markers; nothing else of the factor's solves runs."""
    from vampomi_tpu_torch.ops import eigen as teig

    factor = {"spectral": tspec.GramFactor, "eigen": teig.EigenFactor}[solver]
    calls, real = [], factor.solve

    def spy(self, av, tau, gam2, mt):
        calls.append((type(self), tuple(av.shape), mt))
        return real(self, av, tau, gam2, mt)

    monkeypatch.setattr(factor, "solve", spy)
    dm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    cfg = RunConfig(**cfg_kw(tmp_path, iterations=3, lmmse_solver=solver, device="cpu",
                             model=model, stop_criteria_thr=0.0))
    res = _fit(model, dm, fx, cfg)
    assert res.solver == solver and res.iterations_run == 3
    assert calls == [(factor, (300,), dm.mt)] * 3


@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_an_unknown_solver_raises_before_any_pass(fx, tmp_path, model):
    """An unknown --lmmse-solver raises from choose_lmmse_solver before the
    engine reads X once."""
    from vampomi_tpu_torch.ops import operator as top

    dm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    cfg = RunConfig(**cfg_kw(tmp_path, iterations=2, lmmse_solver="cholesky", device="cpu",
                             model=model))
    passes = top.x_passes()
    with pytest.raises(ValueError, match="unknown LMMSE solver 'cholesky'"):
        _fit(model, dm, fx, cfg)
    assert top.x_passes() == passes
    with pytest.raises(ValueError, match="unknown LMMSE solver 'cholesky'"):
        tlin.choose_lmmse_solver(cfg, dm.mt, int(dm.n))


def test_dense_step_probe_small_on_cpu(capsys):
    """The dense-step probe at --small on the CPU checks every (blocks, leaf
    size) pair against potrf + trsm and times nothing."""
    assert dense_step_probe.main(["--small", "--device", "cpu", "--seed", "3"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["tool"] == "dense_step_probe" and summary["device"]["platform"] == "cpu"
    assert summary["checks_pass"] and set(summary["checks"]) == {"300", "700"}
    for c in summary["checks"].values():
        assert len(c) == len(dense_step_probe.GRID)
        assert all(v < dense_step_probe.CHECK_TOL for d in c.values() for v in d.values())
    assert set(summary["results"].values()) == {"not measured"}
    assert summary["profile"] == "not measured"


def test_dense_step_probe_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dense_step_probe.main(["--small"])


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
    got = tlin._iteration_phase_exact(
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
    # no eigh; the outputs' flush after the loop (engine/linear.py flush_timed)
    assert set(tres.setup) == {"aty", "gram", "dump.flush"}


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
