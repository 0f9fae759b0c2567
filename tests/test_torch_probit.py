"""The port's probit GLM-VAMP (vampomi_tpu_torch/glm/probit.py,
engine/probit.py, utils/mathx.py) and its covariate fit in both engines,
against the JAX package on the CPU.

The denoisers and the Newton solver are compared on identical inputs made
with numpy; the phase per solver in f64 from one state (JAX's Gram factor or
eigenbasis carried over by convert.py, the same Rademacher probe); whole
trajectories in f64 on the JAX probit test's fixture
(tests/test_engine_probit.py:16-33), with JAX's own initial p1 (and, for CG,
its probes) replayed into the port's draw helpers — the two frameworks'
RNGs cannot give the same draws."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.engine import linear as jlin
from vampomi_tpu.engine import metrics as jmet
from vampomi_tpu.engine import probit as jprob
from vampomi_tpu.glm import probit as jglm
from vampomi_tpu.ops import eigen as jeig
from vampomi_tpu.ops import operator as jop
from vampomi_tpu.ops import spectral as jspec
from vampomi_tpu.prior import mixture as jmix
from vampomi_tpu.utils import mathx as jmath
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.engine import metrics as tmet
from vampomi_tpu_torch.engine import probit as tprob
from vampomi_tpu_torch.glm import probit as tglm
from vampomi_tpu_torch.io.bin_io import read_bin_slab
from vampomi_tpu_torch.io.csv_writer import read_positional_csv
from vampomi_tpu_torch.ops.operator import build_design
from vampomi_tpu_torch.sim.data_sim import simulate_iid
from vampomi_tpu_torch.utils import mathx as tmath

from tests.test_torch_engine_linear import PHASE_RTOL, _arrays, _compare_outputs

torch.set_num_threads(2)

SOLVERS = ["cg", "spectral", "eigen"]
ITERS = 6


# ---------------------------------------------------------------------------
# mathx, the z-denoisers, the Newton solver, the confusion counts


def test_erfcx_and_normal_cdf_match_jax():
    """Both over |x| up to 40, through the asymptotic branch (x > 10) and
    the reference's clamp to inf (x < -10); rtol 1e-12 (erfc and ndtr of two
    libraries), atol at the f64 underflow of Phi."""
    x = np.concatenate([np.linspace(-40.0, 40.0, 801), [-10.0, -9.99, 10.0, 10.01, 26.5, 0.0]])
    got, want = tmath.erfcx(torch.as_tensor(x)).numpy(), np.asarray(jmath.erfcx(jnp.asarray(x)))
    assert np.isinf(got[x < -10.0]).all() and np.isfinite(got[x >= -10.0]).all()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    got, want = tmath.normal_cdf(torch.as_tensor(x)).numpy(), np.asarray(jmath.normal_cdf(x))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)
    assert tmath.normal_cdf(1).dtype == torch.float64


def test_host_helpers_are_the_jax_copies():
    rng = np.random.default_rng(0)
    v = rng.normal(size=50)
    assert tmath.calc_stdev(v) == jmath.calc_stdev(v)
    assert tmath.noise_prec_calc(2.0, [0, 1e-3], [0.9, 0.1], 100, 50) == \
        jmath.noise_prec_calc(2.0, [0, 1e-3], [0.9, 0.1], 100, 50)
    np.testing.assert_array_equal(tmath.simulate_mixture(100, [0.0, 1.0], [0.5, 0.5], seed=3),
                                  jmath.simulate_mixture(100, [0.0, 1.0], [0.5, 0.5], seed=3))
    z = rng.normal(size=40)
    np.testing.assert_array_equal(tglm.predict_probit(z, 0.4), jglm.predict_probit(z, 0.4))


def _zden_inputs(n=4000, seed=1):
    """p, y, m_cov with x = sign·c spread over [-40, 40] at tau1 = 0.7,
    probit_var 1.3; returns x too."""
    rng = np.random.default_rng(seed)
    s = np.sqrt(1.3 + 1.0 / 0.7)
    x = rng.uniform(-40.0, 40.0, size=n)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    m_cov = rng.normal(size=n)
    p = x * s * (2.0 * y - 1.0) - m_cov
    return p, y, m_cov, x


def zden_rtol(x, dtype, derivative: bool):
    """Per-element tolerance of the z-denoisers, from their conditioning.
    The Mills ratio is exp(A), A = -x²/2 - log √(2π) - log Φ(x), a
    difference of terms of size x²/2, so it carries a relative rounding
    error ~ x²/2·eps; g1d then cancels sign·c + ratio ~ 1/|x| in the lower
    tail, which multiplies that by ~x².  Below x = -20 the JAX package's f64
    log_ndtr takes an asymptotic series that is off by up to 2e-11 of
    log Φ (against mpmath; torch's is within 2e-16 there), about 1e-8 of A."""
    eps = np.finfo(dtype).eps
    k = x * x / 2.0
    tol = 16.0 * eps * (1.0 + (k * x * x if derivative else k))
    if dtype == np.float64:
        tol = tol + np.where(x < -20.0, 1e-8 * (x * x if derivative else 1.0), 0.0)
    return tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_cov", [False, True])
def test_z_denoisers_match_jax(dtype, with_cov):
    """g1_bin_class and g1d_bin_class with |sign·c| up to 40 (the Mills
    ratio far into both tails), with and without covariate offsets: to
    1e-12 of the size of their terms in f64 wherever |sign·c| <= 10, and
    within zden_rtol everywhere."""
    p, y, m_cov, x = _zden_inputs()
    if not with_cov:
        p, m_cov = p + m_cov, np.zeros_like(m_cov)
    tau1, pv = dtype(0.7), dtype(1.3)
    pj, yj, mj = (jnp.asarray(a.astype(dtype)) for a in (p, y, m_cov))
    pt, yt, mt = (torch.as_tensor(a.astype(dtype)) for a in (p, y, m_cov))
    tau_t, pv_t = torch.tensor(tau1), torch.tensor(pv)
    for deriv, jf, tf in ((False, jglm.g1_bin_class, tglm.g1_bin_class),
                          (True, jglm.g1d_bin_class, tglm.g1d_bin_class)):
        want = np.asarray(jf(pj, jnp.asarray(tau1), yj, mj, jnp.asarray(pv))).astype(np.float64)
        got = tf(pt, tau_t, yt, mt, pv_t)
        assert got.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        got = got.numpy().astype(np.float64)
        assert np.all(np.isfinite(got))
        # relative to the size of the terms summed: g1 = p + sign·ratio/(τs)
        # crosses 0 near sign·c ~ -2; g1d = 1 - (a term of at most ~1)
        scale = np.maximum(np.abs(want), 1.0 if deriv else np.abs(p) + 1.0)
        err = np.abs(got - want) / scale
        assert np.all(err <= zden_rtol(x, dtype, deriv)), (jf.__name__, err.max())
        if dtype == np.float64:
            near = np.abs(x) <= 10.0
            assert err[near].max() < 1e-12, jf.__name__


def test_z_denoiser_tail_against_mpmath():
    """In the far lower tail, where the JAX package's f64 log_ndtr series
    drifts, the port's g1_bin_class holds to a 50-digit reference within
    its rounding (zden_rtol without the JAX term)."""
    import mpmath

    mpmath.mp.dps = 50
    x = np.array([-39.5, -33.0, -27.25, -22.0, -20.5, -15.0, -3.0, 2.0])
    tau1, pv = 0.7, 1.3
    s = np.sqrt(pv + 1.0 / tau1)
    y = np.zeros_like(x)  # sign = -1
    p = -x * s
    got = tglm.g1_bin_class(torch.as_tensor(p), tau1, torch.as_tensor(y), 0.0, pv).numpy()
    ms = mpmath.sqrt(mpmath.mpf(pv) + 1 / mpmath.mpf(tau1))
    want = []
    for pi in p:
        xm = -mpmath.mpf(pi) / ms
        ratio = mpmath.npdf(xm) / mpmath.ncdf(xm)
        want.append(float(mpmath.mpf(pi) - ratio / (mpmath.mpf(tau1) * ms)))
    err = np.abs(got - np.array(want)) / np.abs(np.array(want))
    assert np.all(err <= 16.0 * np.finfo(np.float64).eps * (1.0 + x * x / 2.0)), err


@pytest.fixture(scope="module")
def probit_problem():
    """tests/test_engine_probit.py:16-33."""
    fx = simulate_iid(n=400, m=300, lam=0.15, h2=0.9, seed=9)
    g = fx.X @ fx.beta
    rng = np.random.default_rng(10)
    ybin = (g + rng.normal(0, np.sqrt(0.1), len(g)) > 0).astype(float)
    return fx, ybin


@pytest.fixture(scope="module")
def cov_problem(probit_problem):
    """tests/test_engine_probit.py:58-75: two covariates with known effects."""
    fx, _ = probit_problem
    n = fx.X.shape[0]
    rng = np.random.default_rng(4)
    Z = rng.normal(size=(n, 2))
    g = fx.X @ fx.beta
    ybin = (g + Z @ np.array([1.0, -0.7]) + rng.normal(0, np.sqrt(0.1), n) > 0).astype(float)
    return Z, ybin


@pytest.mark.parametrize("probit_var", [1.0, 0.5])
def test_newton_method_cov_matches_jax(cov_problem, probit_var):
    Z, ybin = cov_problem
    n = len(ybin)
    got = tglm.newton_method_cov(ybin, np.zeros(n), Z, np.zeros(2), probit_var=probit_var)
    want = jglm.newton_method_cov(ybin, np.zeros(n), Z, np.zeros(2), probit_var=probit_var)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert got[0] > 0.3 and got[1] < -0.2


def test_newton_method_cov_verbosity_prints(cov_problem, capsys):
    Z, ybin = cov_problem
    tglm.newton_method_cov(ybin, np.zeros(len(ybin)), Z, np.zeros(2), verbosity=1)
    assert "[Newton_cov] it = 0, relative err" in capsys.readouterr().out


def test_confusion_counts_match_jax():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 2, size=1001).astype(np.float64)
    yhat = rng.integers(0, 2, size=1001).astype(np.float64)
    got = [int(v) for v in tmet.confusion_counts(torch.as_tensor(y), torch.as_tensor(yhat))]
    want = [int(v) for v in jmet.confusion_counts(jnp.asarray(y), jnp.asarray(yhat))]
    assert got == want and sum(got) == 1001


# ---------------------------------------------------------------------------
# the phase


@pytest.fixture(scope="module")
def pair(probit_problem):
    fx, _ = probit_problem
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    return jdm, convert.design_from_arrays(_arrays(jdm))


@pytest.fixture(scope="module")
def factors(pair):
    """JAX's Gram factor and eigenbasis, and the port's copies of them."""
    jdm, _ = pair
    jfac = jspec.build_spectral(jdm)
    jef, _ = jeig.build_eigen(jfac, leaf=2048)
    return {"spectral": (jfac, convert.gram_from_arrays(_arrays(jfac))),
            "eigen": (jef, convert.eigen_from_arrays(_arrays(jef))),
            "cg": (None, None)}


@pytest.fixture(scope="module")
def state(probit_problem, pair):
    """A mid-trajectory state shared by the phase comparisons."""
    fx, ybin = probit_problem
    _, tdm = pair
    rng = np.random.default_rng(11)
    m, n = tdm.m_pad, int(tdm.n)
    beta = fx.beta * np.sqrt(n)
    g = fx.X @ fx.beta
    return dict(
        y=ybin, m_cov=0.3 * rng.normal(size=n),
        r1=beta + rng.normal(size=m) * 0.5, r2=beta + rng.normal(size=m),
        p1=g * np.sqrt(n) * 0.5 + rng.normal(size=n), p2=rng.normal(size=n),
        x1_prev=beta * 0.8 + rng.normal(size=m) * 0.1,
        bern=rng.choice([-1.0, 1.0], size=m) / np.sqrt(m),
        ts=beta,
        gam1=0.7, tau1=1.9, alpha1=0.35, rho=0.3, probit_var=1.0,
    )


@pytest.mark.parametrize("damp", [False, True])
@pytest.mark.parametrize("solver", SOLVERS)
def test_probit_phase_matches_jax(pair, factors, state, solver, damp):
    jdm, tdm = pair
    jfac, tfac = factors[solver]
    s = state
    jp = jmix.init_prior([0.85, 0.1, 0.05], [0.0, 1e-3, 1e-2], int(tdm.n))
    tp = convert.prior_from_arrays(_arrays(jp))
    vecs = ("y", "m_cov", "r1", "r2", "p1", "p2")
    want = jprob._probit_phase(
        jdm, *(jnp.asarray(s[k]) for k in vecs),
        jnp.asarray(s["gam1"]), jnp.asarray(s["tau1"]), jnp.asarray(0.0),
        jnp.asarray(s["alpha1"]), jp, jnp.asarray(s["x1_prev"]), jnp.asarray(damp),
        jnp.asarray(s["rho"]), jnp.asarray(s["probit_var"]), jnp.asarray(s["bern"]),
        jnp.asarray(s["ts"]), jnp.asarray(500), jnp.asarray(1e-7), fac=jfac, solver=solver)
    got = tprob._probit_phase(
        tdm, *(torch.as_tensor(s[k]) for k in vecs), s["gam1"], s["tau1"], s["alpha1"],
        tp, torch.as_tensor(s["x1_prev"]), damp, s["rho"], s["probit_var"],
        torch.as_tensor(s["bern"]) if tfac is None else None, torch.as_tensor(s["ts"]),
        500, 1e-7, fac=tfac)
    _compare_outputs(got, want, rtol=PHASE_RTOL)
    assert 0 < float(got["metrics"][4]) <= 1 and 0 < float(got["metrics"][10]) <= 1


def test_probit_phase_beta1_clamp(pair, state):
    """beta1 = Σ g1d_bin_class >= N is clamped to N - 1 before the division
    by N (JAX engine/probit.py:128): where every label is predicted with
    certainty (sign·c ~ 80), the Mills ratio underflows and every g1d is 1."""
    _, tdm = pair
    s = state
    tp = convert.prior_from_arrays(_arrays(jmix.init_prior([0.9, 0.1], [0.0, 1e-2], int(tdm.n))))
    p1 = torch.as_tensor((2.0 * s["y"] - 1.0) * 100.0)
    out = tprob._probit_phase(
        tdm, *(torch.as_tensor(s[k]) for k in ("y", "m_cov", "r1", "r2")),
        p1, torch.as_tensor(s["p2"]), s["gam1"], s["tau1"], s["alpha1"], tp, torch.as_tensor(s["x1_prev"]), False, 0.3, 1.0,
        torch.as_tensor(s["bern"]), torch.as_tensor(s["ts"]), 500, 1e-7)
    n = tdm.n
    assert float(out["params"][1]) == (n - 1.0) / n


# ---------------------------------------------------------------------------
# whole trajectories


def _jax_draws(seed, n, m, iters, dtype):
    """The JAX engine's initial p1 and its per-iteration probes
    (engine/probit.py:338-340, 491-498), replayed."""
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    p1 = np.array(jax.random.normal(sub, (n,), dtype=dtype))
    probes = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        b = jax.random.rademacher(sub, (m,), dtype=dtype) * jnp.asarray(
            1.0 / np.sqrt(float(m)), dtype=dtype)
        probes.append(np.array(b))
    return p1, probes


def replay_draws(mp, seed, n, m, iters, dtype, probes: bool):
    """Feed JAX's p1 (and probes) into the port's draw helpers."""
    p1, bern = _jax_draws(seed, n, m, iters, dtype)
    mp.setattr(tprob, "_draw_p1", lambda gen, n_, wd, dev: torch.as_tensor(p1).to(dev, wd))
    if probes:
        feed = iter(bern)
        mp.setattr(tprob, "_draw_probe",
                   lambda gen, dm: torch.as_tensor(next(feed)).to(dm.device, dm.wd))


def probit_kw(tmp, **kw):
    """tests/test_engine_probit.py:26-33."""
    d = dict(out_dir=str(tmp), out_name="pb", model="bin_class", iterations=ITERS,
             rho=0.3, gam1=1e-2, probs=[0.85, 0.1, 0.05], vars=[0.0, 1e-3, 1e-2],
             stop_criteria_thr=1e-8, seed=3)
    d.update(kw)
    return d


def run_both(fx, ybin, tmp_factory, solver, compute_dtype, covariates=None, **kw):
    """The JAX engine and the port on the same fixture and draws; returns
    (jax dir, jax result, port dir, port result)."""
    jdir, tdir = tmp_factory.mktemp("jax_pb"), tmp_factory.mktemp("torch_pb")
    jdt = {"float64": jnp.float64, "int8": jnp.int8}[compute_dtype]
    tdt = {"float64": torch.float64, "int8": torch.int8}[compute_dtype]
    jres = jprob.infere_bin_class(
        jop.build_design(fx.X.T, mesh=None, compute_dtype=jdt), ybin,
        JConfig(**probit_kw(jdir, lmmse_solver=solver, **kw)),
        true_signal=fx.beta, covariates=covariates)
    wd = jnp.float64 if compute_dtype == "float64" else jnp.float32
    mp = pytest.MonkeyPatch()
    try:
        replay_draws(mp, 3, len(ybin), fx.X.shape[1], ITERS, wd, probes=solver == "cg")
        tres = tprob.infere_bin_class(
            build_design(fx.X.T, compute_dtype=tdt, device="cpu"), ybin,
            RunConfig(**probit_kw(tdir, lmmse_solver=solver, device="cpu", **kw)),
            true_signal=fx.beta, covariates=covariates)
    finally:
        mp.undo()
    return jdir, jres, tdir, tres


@pytest.fixture(scope="module", params=SOLVERS)
def f64_runs(request, probit_problem, tmp_path_factory):
    fx, ybin = probit_problem
    return request.param, run_both(fx, ybin, tmp_path_factory, request.param, "float64")


def _csv(d, name):
    return np.asarray(read_positional_csv(os.path.join(d, name)))


def test_probit_trajectory_csvs_match_jax(f64_runs):
    """Params (8 values under the 6-name header), metrics (12) and prior
    rows (the ×N variances) to rtol 1e-6 (f64; the eigen route compares two
    eigh implementations, CG two summation orders stopped at 1e-5)."""
    solver, (jdir, jres, tdir, tres) = f64_runs
    assert tres.iterations_run == jres.iterations_run == ITERS
    assert tres.solver == solver
    for name, width in (("pb_params.csv", 9), ("pb_metrics.csv", 13), ("pb_prior.csv", 8)):
        got, want = _csv(tdir, name), _csv(jdir, name)
        assert got.shape == want.shape == (ITERS, width), name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=name)
    assert open(os.path.join(tdir, "pb_params.csv"), "rb").read().split(b"\n")[0] == \
        open(os.path.join(jdir, "pb_params.csv"), "rb").read().split(b"\n")[0]
    np.testing.assert_allclose(np.asarray(tres.metrics_history),
                               np.asarray(jres.metrics_history), rtol=1e-6, atol=1e-12)


def test_probit_trajectory_dumps_and_result_match_jax(f64_runs, probit_problem):
    solver, (jdir, jres, tdir, tres) = f64_runs
    fx, _ = probit_problem
    m = fx.X.shape[1]
    for it in range(1, ITERS + 1):
        for kind in ("it", "r1_it"):
            got = read_bin_slab(os.path.join(tdir, f"pb_{kind}_{it}.bin"), m)
            want = read_bin_slab(os.path.join(jdir, f"pb_{kind}_{it}.bin"), m)
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-9 * max(np.abs(want).max(), 1e-300))
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled, rtol=1e-6,
                               atol=1e-9 * np.abs(jres.x1_hat_scaled).max())
    np.testing.assert_allclose(tres.r1_scaled, jres.r1_scaled, rtol=1e-6,
                               atol=1e-9 * np.abs(jres.r1_scaled).max())
    np.testing.assert_allclose(tres.probs, jres.probs, rtol=1e-6)
    np.testing.assert_allclose(tres.vars, jres.vars, rtol=1e-6)
    np.testing.assert_allclose([tres.gam1, tres.tau1], [jres.gam1, jres.tau1], rtol=1e-6)
    assert tres.cov_eff is None and jres.cov_eff is None
    assert tres.metrics_history[-1][5] > 0.7  # x1 corr (tests/test_engine_probit.py:45)


@pytest.mark.parametrize("solver", ["eigen", "cg"])
def test_probit_int8_design_matches_jax_int8(probit_problem, tmp_path_factory, solver):
    """The int8 design against the JAX int8 run (its p1, and for CG its
    probes, replayed), at the linear int8 test's 2e-2: on the CPU the JAX
    int8 products round w and y to bf16 where the port's stay f32."""
    fx, ybin = probit_problem
    _, jres, _, tres = run_both(fx, ybin, tmp_path_factory, solver, "int8")
    got, want = np.asarray(tres.metrics_history), np.asarray(jres.metrics_history)
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    n = len(ybin)
    np.testing.assert_allclose(got[:, [4, 5, 10, 11]], want[:, [4, 5, 10, 11]],
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[:, [0, 1, 2, 3, 6, 7, 8, 9]] / n,
                               want[:, [0, 1, 2, 3, 6, 7, 8, 9]] / n, atol=2e-2)
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled,
                               atol=2e-2 * np.abs(jres.x1_hat_scaled).max())
    assert got[-1, 4] > 0.7 and got[-1, 5] > 0.6  # tests/test_engine_probit.py:102-103


@pytest.mark.parametrize("solver", ["spectral", "cg"])
def test_probit_covariates_match_jax(probit_problem, cov_problem, tmp_path_factory, solver):
    """C = 2: cov_eff to 1e-12 (the same host Newton), the trajectory with
    the covariate offsets to rtol 1e-6."""
    fx, _ = probit_problem
    Z, ybin = cov_problem
    jdir, jres, tdir, tres = run_both(fx, ybin, tmp_path_factory, solver, "float64",
                                      covariates=Z, C=2)
    np.testing.assert_allclose(tres.cov_eff, jres.cov_eff, rtol=1e-12)
    assert tres.cov_eff[0] > 0.3 and tres.cov_eff[1] < -0.2
    for name in ("pb_params.csv", "pb_metrics.csv", "pb_prior.csv"):
        np.testing.assert_allclose(_csv(tdir, name), _csv(jdir, name), rtol=1e-6, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled, rtol=1e-6,
                               atol=1e-9 * np.abs(jres.x1_hat_scaled).max())


@pytest.mark.parametrize("solver", ["eigen", "cg"])
def test_linear_covariates_match_jax(tmp_path, solver, monkeypatch):
    """The linear engine with C = 2 covariates against the JAX engine: the
    Newton fit once, y - Z cov_eff in the constant A^T y, the raw y in gamw
    and the metrics (CG with the JAX engine's probes replayed)."""
    from tests.test_torch_engine_linear import _jax_engine_probes, cfg_kw

    fx = simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42)
    rng = np.random.default_rng(6)
    Z = rng.normal(size=(300, 2))
    y = fx.y + Z @ np.array([0.8, -0.5])
    kw = cfg_kw(tmp_path, iterations=4, lmmse_solver=solver, C=2)
    jres = jlin.infere_linear(jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64),
                              y, JConfig(**kw), true_signal=fx.beta, covariates=Z,
                              write_outputs=False)
    feed = iter(_jax_engine_probes(kw["seed"], 4, fx.X.shape[1], jnp.float64))
    monkeypatch.setattr(tlin, "_draw_probe", lambda gen, dm: next(feed))
    tres = tlin.infere_linear(build_design(fx.X.T, compute_dtype=torch.float64, device="cpu"),
                              y, RunConfig(**kw, device="cpu"), true_signal=fx.beta,
                              covariates=Z, write_outputs=False)
    rtol = 1e-6 if solver == "eigen" else 1e-4
    np.testing.assert_allclose(np.asarray(tres.metrics_history),
                               np.asarray(jres.metrics_history), rtol=rtol, atol=1e-10)
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled, rtol=rtol,
                               atol=rtol * np.abs(jres.x1_hat_scaled).max())
    np.testing.assert_allclose(tres.gamw, jres.gamw, rtol=rtol)
    assert "cov" in tres.setup
    # the covariates are really taken out: without them the run differs
    feed = iter(_jax_engine_probes(kw["seed"], 4, fx.X.shape[1], jnp.float64))
    plain = tlin.infere_linear(build_design(fx.X.T, compute_dtype=torch.float64, device="cpu"),
                               y, RunConfig(**dict(kw, C=0), device="cpu"),
                               true_signal=fx.beta, write_outputs=False)
    assert np.abs(plain.x1_hat_scaled - tres.x1_hat_scaled).max() > 1e-3


# ---------------------------------------------------------------------------
# the engine's own behaviour


def test_probit_draws_are_seeded_and_ordered(pair):
    """p1 first, then one probe an iteration whether or not the solver uses
    it: one seed gives the same sequence, and skipping a probe consumes what
    drawing it does."""
    _, tdm = pair
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(9)
    g2.manual_seed(9)
    a = tprob._draw_p1(g1, 400, torch.float32, torch.device("cpu"))
    b = tprob._draw_p1(g2, 400, torch.float32, torch.device("cpu"))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    tlin._skip_probe(g1, tdm)
    tlin._draw_probe(g2, tdm)
    assert torch.equal(tlin._draw_probe(g1, tdm), tlin._draw_probe(g2, tdm))


@pytest.mark.parametrize("field,value", [("resume_file", "x.npz"), ("checkpoint_file", "x.npz"),
                                         ("eigen_cache", "e.npz")])
def test_probit_unported_engine_options_raise(pair, probit_problem, tmp_path, field, value):
    """The options the probit engine refused before the port ran them now
    run (tests/test_torch_checkpoint.py holds a resumed run bitwise)."""
    _, tdm = pair
    _, ybin = probit_problem
    path = str(tmp_path / value)
    if field == "resume_file":
        tprob.infere_bin_class(tdm, ybin, RunConfig(**probit_kw(
            tmp_path, device="cpu", iterations=2, checkpoint_file=path)), write_outputs=False)
    solver = "eigen" if field == "eigen_cache" else "cg"
    cfg = RunConfig(**probit_kw(tmp_path, device="cpu", lmmse_solver=solver, **{field: path}))
    res = tprob.infere_bin_class(tdm, ybin, cfg, write_outputs=False)
    assert os.path.exists(path) and np.all(np.isfinite(res.x1_hat_scaled))
    assert res.iterations_run == ITERS  # the last iteration; a resume ran 3..ITERS
    assert len(res.iter_seconds) == ITERS - (2 if field == "resume_file" else 0)


def test_probit_eigen_build_budget_falls_back(probit_problem, tmp_path):
    """An eigen build over --eigen-build-budget runs the spectral solver
    (tests/test_engine_probit.py:153-171)."""
    fx, ybin = probit_problem
    dm = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    res = tprob.infere_bin_class(dm, ybin, RunConfig(**probit_kw(
        tmp_path, iterations=2, lmmse_solver="eigen", eigen_build_budget=1e-9, device="cpu")),
        write_outputs=False)
    assert res.solver == "spectral" and res.iterations_run == 2
    assert np.all(np.isfinite(res.x1_hat_scaled))
