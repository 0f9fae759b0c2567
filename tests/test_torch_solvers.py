"""The port's LMMSE solvers — multi-RHS CG, the Gram build and the eigen
factor's solve — and the engine metrics against the JAX package on the CPU in f64.
JAX state (DesignMatrix, EigenFactor) is carried over by convert.py so both
compute on identical inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.engine import metrics as jmet
from vampomi_tpu.ops import cg as jcg
from vampomi_tpu.ops import eigen as jeig
from vampomi_tpu.ops import operator as jop
from vampomi_tpu.ops import spectral as jspec
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.engine import metrics as tmet
from vampomi_tpu_torch.ops import cg as tcg
from vampomi_tpu_torch.ops import eigen as teig
from vampomi_tpu_torch.ops import spectral as tspec
from vampomi_tpu_torch.ops.operator import atx, ax
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)


def _arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def pair():
    fx = simulate_iid(n=200, m=480, lam=0.1, h2=0.8, seed=9)
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    return jdm, convert.design_from_arrays(_arrays(jdm)), fx


@pytest.mark.parametrize("tau,gam2", [(2.0, 0.5), (50.0, 1e-3)])
def test_cg_solve_matches_jax(pair, tau, gam2):
    """Same (V, MU0, onsager_cols): the same iteration count, and mu to
    rtol 1e-8 (f64 sums in another order through up to ~100 CG steps)."""
    jdm, tdm, _ = pair
    rng = np.random.default_rng(1)
    m = tdm.m_pad
    V = np.stack([rng.normal(size=m), rng.choice([-1.0, 1.0], size=m) / np.sqrt(m)], 1)
    MU0 = np.stack([rng.normal(size=m) * 0.1, np.zeros(m)], 1)
    ons = np.array([False, True])
    want = jcg.cg_solve(jdm, jnp.asarray(V), jnp.asarray(MU0), tau, gam2,
                        max_iter=500, tol=1e-7, onsager_cols=jnp.asarray(ons))
    got = tcg.cg_solve(tdm, torch.as_tensor(V), torch.as_tensor(MU0), tau, gam2,
                       max_iter=500, tol=1e-7, onsager_cols=torch.as_tensor(ons))
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-8,
                               atol=1e-10 * np.abs(np.asarray(want.mu)).max())
    # ||r|| / ||v|| near 1e-7 is a difference of nearly equal vectors:
    # its absolute f64 noise is ~1e-11 of ||v||
    np.testing.assert_allclose(got.rel_err.numpy(), np.asarray(want.rel_err),
                               rtol=1e-6, atol=1e-9)


def test_cg_solve_max_iter_cap(pair):
    jdm, tdm, _ = pair
    v = np.random.default_rng(2).normal(size=tdm.m_pad)
    want = jcg.cg_solve(jdm, jnp.asarray(v), jnp.zeros(tdm.m_pad), 3.0, 0.1,
                        max_iter=3, tol=1e-12)
    got = tcg.cg_solve(tdm, torch.as_tensor(v), torch.zeros(tdm.m_pad, dtype=torch.float64),
                       3.0, 0.1, max_iter=3, tol=1e-12)
    assert got.iters == int(want.iters) == 3
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-10)


@pytest.mark.parametrize("block", [16384, 128, 100])
def test_gram_matches_jax(pair, block):
    """K = A A^T, blocked over markers (whole, even and ragged blocks)."""
    jdm, tdm, _ = pair
    want = np.asarray(jspec.gram(jdm, block=block))
    got = tspec.gram(tdm, block=block).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(got, got.T)


@pytest.fixture(scope="module")
def eig_pair(pair):
    jdm, tdm, _ = pair
    fac = jspec.build_spectral(jdm)
    jef, _ = jeig.build_eigen(fac, leaf=2048)
    return jef, convert.eigen_from_arrays(_arrays(jef))


@pytest.mark.parametrize("tau,gam2", [(2.0, 0.5), (40.0, 1e-3)])
def test_eigen_weights_and_traces_match_jax(pair, eig_pair, tau, gam2):
    """The weights, T and both closed forms of EigenFactor.solve against
    JAX's eigen_weights and eigen_traces."""
    jdm, tdm, _ = pair
    jef, tef = eig_pair
    d_j, T_j = jeig.eigen_weights(jef, tau, gam2)
    d_t, T_t = teig.eigen_weights(tef, tau, gam2)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-14)
    np.testing.assert_allclose(T_t.item(), float(T_j), rtol=1e-14)
    _, *got = tef.solve(torch.ones(tef.n, dtype=torch.float64), tau, gam2, tdm.mt)
    assert len(got) == 2
    for a, b in zip(got, jeig.eigen_traces(jef, jdm.mt, tau, gam2)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-12)


@pytest.mark.parametrize("tau,gam2", [(4.0, 0.3), (40.0, 1e-3), (0.3, 40.0)])
def test_eigen_solve_matches_jax(pair, eig_pair, tau, gam2):
    """q = S^{-1} A v of EigenFactor.solve, and mu = (v - tau A^T q) / gam2
    as the engines form it, against JAX's eigen_solve."""
    jdm, tdm, _ = pair
    jef, tef = eig_pair
    v = np.random.default_rng(3).normal(size=tdm.m_pad)
    mu_j, q_j = jeig.eigen_solve(jdm, jef, jnp.asarray(v), tau, gam2)
    tv = torch.as_tensor(v)
    q_t, *_ = tef.solve(ax(tdm, tv), tau, gam2, tdm.mt)
    mu_t = (tv - tau * atx(tdm, q_t)) / gam2
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-9, atol=1e-12)


def test_build_eigen_diagonalizes_the_jax_gram(pair, eig_pair):
    """The port's eigh build on the JAX K: same spectrum, and U diag(lam) U^T
    reproduces K (eigenvector sign and order do not matter)."""
    jdm, _, _ = pair
    K = np.asarray(jspec.gram(jdm))
    ef, diag = teig.build_eigen(convert.gram_from_arrays({"K": K}))
    assert diag["resid"] < 1e-12 and diag["ortho"] < 1e-12
    np.testing.assert_allclose(np.sort(ef.lam.numpy()), np.sort(np.asarray(eig_pair[0].lam)),
                               rtol=1e-9, atol=1e-9 * np.abs(K).max())
    U = ef.U.numpy()
    np.testing.assert_allclose(U @ np.diag(ef.lam.numpy()) @ U.T, K, atol=1e-10 * np.abs(K).max())


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=300), rng.normal(size=300) + 0.5
    for want, got in zip(jmet.signal_metrics(jnp.asarray(a), jnp.asarray(b), 200),
                         tmet.signal_metrics(torch.as_tensor(a), torch.as_tensor(b), 200)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-13)
    for want, got in zip(jmet.prediction_metrics(jnp.asarray(a), jnp.asarray(b)),
                         tmet.prediction_metrics(torch.as_tensor(a), torch.as_tensor(b))):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-13)
