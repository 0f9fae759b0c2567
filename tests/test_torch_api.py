"""The port's array API (vampomi_tpu_torch/api.py) against vampomi_tpu.api on
the CPU: the same fit through both packages' engines (f64, the exact
solvers, which draw no random probes), the same out-of-sample scores,
p-values, heritability and phenotype scaling; the port's fit equals its own
engine run on the CLI's wiring; the probit fit and prediction, and
covariates on both paths, against JAX; a missing card raises."""

import numpy as np
import pytest
import torch

import vampomi_tpu.api as ja
import vampomi_tpu_torch.api as ta
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine.linear import infere_linear
from vampomi_tpu_torch.ops.operator import build_design
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)

HYPER = dict(iterations=5, h2=0.8, probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2],
             stop_criteria_thr=1e-8, seed=7)


@pytest.fixture(scope="module")
def fx():
    return simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42)


@pytest.fixture(scope="module", params=["spectral", "eigen"])
def fits(request, fx):
    kw = dict(HYPER, lmmse_solver=request.param)
    return (ja.fit_linear(fx.X, fx.y, mesh=None, quiet=True, **kw),
            ta.fit_linear(fx.X, fx.y, device="cpu", quiet=True, **kw))


def test_fit_linear_matches_jax(fits):
    """Estimates, r1, gamma_w and the metrics history to rtol 1e-6 (f64; the
    eigen route compares two eigh implementations)."""
    want, got = fits
    assert got.iterations_run == want.iterations_run == 5
    np.testing.assert_allclose(got.x1_hat_scaled, want.x1_hat_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.r1_scaled, want.r1_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.gamw, want.gamw, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got.metrics_history),
                               np.asarray(want.metrics_history), rtol=1e-6, atol=1e-12)


def test_h2_and_association_pvals_match_jax(fits, fx):
    want, got = fits
    np.testing.assert_allclose(ta.h2_estimate(got), ja.h2_estimate(want), rtol=1e-6)
    assert 0.0 < ta.h2_estimate(got) < 1.0
    n = fx.X.shape[0]
    np.testing.assert_allclose(ta.association_pvals(got, n), ja.association_pvals(want, n),
                               rtol=1e-4, atol=1e-12)
    with pytest.raises(ValueError, match="method='se'"):
        ta.association_pvals(got, n, method="loo")


def test_fit_linear_is_the_engine_on_the_cli_wiring(fx):
    """fit_linear == read_phen-standardized y through infere_linear with the
    same RunConfig, bit for bit."""
    kw = dict(HYPER, lmmse_solver="spectral")
    fit = ta.fit_linear(fx.X, fx.y, device="cpu", quiet=True, **kw)
    y_std, _ = ta.standardize_phenotype(fx.y)
    cfg = RunConfig(**kw, device="cpu")
    cfg.N, cfg.Mt, cfg.meth_file = fx.y.size, fx.X.shape[1], "<in-memory>"
    dm = build_design(np.ascontiguousarray(fx.X.T), compute_dtype=torch.float64, device="cpu")
    ref = infere_linear(dm, y_std, cfg, write_outputs=False)
    np.testing.assert_array_equal(fit.x1_hat_scaled, ref.x1_hat_scaled)
    np.testing.assert_array_equal(fit.r1_scaled, ref.r1_scaled)
    assert fit.gam1 == ref.gam1 and fit.gamw == ref.gamw and fit.solver == "spectral"


def test_fit_linear_marker_major_and_unscaled_y(fx):
    kw = dict(HYPER, lmmse_solver="spectral", iterations=2)
    a = ta.fit_linear(fx.X, fx.y, device="cpu", quiet=True, **kw)
    # the (M, N) view's marker statistics sum in another memory order
    b = ta.fit_linear(fx.X.T, fx.y, marker_major=True, device="cpu", quiet=True, **kw)
    np.testing.assert_allclose(a.x1_hat_scaled, b.x1_hat_scaled, rtol=1e-10, atol=1e-14)
    y_std, _ = ta.standardize_phenotype(fx.y)
    c = ta.fit_linear(fx.X, y_std, standardize_y=False, device="cpu", quiet=True, **kw)
    np.testing.assert_array_equal(a.x1_hat_scaled, c.x1_hat_scaled)


@pytest.mark.parametrize("compute_dtype,rtol", [("float64", 1e-12), ("int8", 2e-2)])
def test_predict_linear_matches_jax(fx, compute_dtype, rtol):
    """A_new (beta sqrt(N_new)) on a new design standardized with its own
    statistics; int8 within the JAX CPU path's bf16 rounding of w."""
    rng = np.random.default_rng(4)
    X_new = rng.binomial(2, 0.3, size=(120, fx.X.shape[1])).astype(float)
    got = ta.predict_linear(fx.beta, X_new, device="cpu", compute_dtype=compute_dtype)
    want = ja.predict_linear(fx.beta, X_new, mesh=None, compute_dtype=compute_dtype)
    assert got.shape == (120,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_predict_linear_takes_a_fit_and_checks_the_width(fits, fx):
    _, got = fits
    z = ta.predict_linear(got, fx.X, device="cpu")
    np.testing.assert_allclose(z, ta.predict_linear(got.x1_hat_scaled, fx.X, device="cpu"))
    with pytest.raises(ValueError, match="markers"):
        ta.predict_linear(got, fx.X[:, :10], device="cpu")


def test_standardize_phenotype_matches_jax(fx):
    got, want = ta.standardize_phenotype(fx.y), ja.standardize_phenotype(fx.y)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    with pytest.raises(ValueError, match="constant"):
        ta.standardize_phenotype(np.ones(5))


def test_unknown_config_field_and_shape_mismatch_raise(fx):
    with pytest.raises(TypeError, match="unknown configuration field"):
        ta.fit_linear(fx.X, fx.y, device="cpu", no_such_field=1)
    with pytest.raises(ValueError, match="samples"):
        ta.fit_linear(fx.X, fx.y[:-1], device="cpu")


@pytest.fixture(scope="module")
def probit_fits(fx):
    """fit_probit through both packages (eigen, f64) on 0/1 labels with two
    covariates, the port replaying JAX's initial p1."""
    from tests.test_torch_probit import replay_draws

    rng = np.random.default_rng(3)
    Z = rng.normal(size=(fx.X.shape[0], 2))
    y01 = (fx.y + Z @ [0.8, -0.5] > np.median(fx.y)).astype(float)
    kw = dict(HYPER, lmmse_solver="eigen", rho=0.3, gam1=1e-2, C=2)
    want = ja.fit_probit(fx.X, y01, mesh=None, quiet=True, covariates=Z, **kw)
    mp = pytest.MonkeyPatch()
    try:
        replay_draws(mp, HYPER["seed"], fx.X.shape[0], fx.X.shape[1], 5, np.float64,
                     probes=False)
        got = ta.fit_probit(fx.X, y01, device="cpu", quiet=True, covariates=Z, **kw)
    finally:
        mp.undo()
    return want, got, Z, y01


def test_fit_probit_matches_jax(probit_fits):
    want, got, _, _ = probit_fits
    assert isinstance(got, ta.ProbitResult)
    assert got.iterations_run == want.iterations_run == 5
    np.testing.assert_allclose(got.cov_eff, want.cov_eff, rtol=1e-12)
    np.testing.assert_allclose(got.x1_hat_scaled, want.x1_hat_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.metrics_history),
                               np.asarray(want.metrics_history), rtol=1e-6, atol=1e-12)
    assert got.metrics_history[-1][4] > 0.7  # denoiser accuracy


@pytest.mark.parametrize("return_proba", [False, True])
@pytest.mark.parametrize("with_cov", [False, True])
def test_predict_probit_matches_jax(probit_fits, fx, return_proba, with_cov):
    """Labels Phi(z) >= 0.5 (int64) or Phi(z + Z cov_eff), on new samples,
    each package from its own fit."""
    want_fit, got_fit, Z, _ = probit_fits
    rng = np.random.default_rng(12)
    X_new = rng.binomial(2, 0.3, size=(150, fx.X.shape[1])).astype(float)
    Z_new = rng.normal(size=(150, 2)) if with_cov else None
    got = ta.predict_probit(got_fit, X_new, device="cpu", covariates=Z_new,
                            return_proba=return_proba)
    want = ja.predict_probit(want_fit, X_new, mesh=None, covariates=Z_new,
                             return_proba=return_proba)
    assert got.shape == (150,) and got.dtype == want.dtype
    if return_proba:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
        assert np.all((got >= 0) & (got <= 1))
    else:
        assert set(np.unique(got)) <= {0, 1}
        np.testing.assert_array_equal(got, want)
    z = ta.predict_linear(got_fit, X_new, device="cpu")
    if with_cov:
        z = z + Z_new @ got_fit.cov_eff
    if not return_proba:
        np.testing.assert_array_equal(got, (z >= 0).astype(np.int64))


def test_fit_probit_checks_its_labels(fx):
    with pytest.raises(ValueError, match="0/1"):
        ta.fit_probit(fx.X, fx.y, device="cpu", quiet=True, **HYPER)
    with pytest.raises(ValueError, match="samples"):
        ta.fit_probit(fx.X, np.ones(3), device="cpu", quiet=True, **HYPER)


def test_fit_linear_with_covariates_matches_jax(fx):
    """covariates (C = 2) on the linear path: the Newton fit once, y - Z
    cov_eff in the constant A^T y (src/vamp.cpp:153-169), spectral, f64."""
    Z = np.random.default_rng(7).normal(size=(fx.X.shape[0], 2))
    y = fx.y + Z @ [0.7, -0.3]
    kw = dict(HYPER, lmmse_solver="spectral", C=2)
    want = ja.fit_linear(fx.X, y, mesh=None, quiet=True, covariates=Z, **kw)
    got = ta.fit_linear(fx.X, y, device="cpu", quiet=True, covariates=Z, **kw)
    np.testing.assert_allclose(got.x1_hat_scaled, want.x1_hat_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got.gamw, want.gamw, rtol=1e-6)
    assert "cov" in got.setup


def test_default_device_is_the_card(fx, monkeypatch):
    """device="cuda" (the default) without a card raises; it never runs on
    the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ta.fit_linear(fx.X, fx.y, quiet=True, **HYPER)
    with pytest.raises(RuntimeError, match="is_available"):
        ta.predict_linear(fx.beta, fx.X)
    with pytest.raises(RuntimeError, match="is_available"):
        ta.fit_probit(fx.X, (fx.y > 0).astype(float), quiet=True, **HYPER)
