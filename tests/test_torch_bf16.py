"""The bf16 design in the port (ops/operator.py build_design, ops/bf16.py and
its three kernels' plain versions, the engines, LOO and the Gibbs sampler)
against the JAX package's bf16 design on the CPU.

Tolerances, with their reasons:
  * the stored bf16 bits and the f32 standardization vectors: bitwise (the
    same f64 statistics of the raw values, the same f64 → f32 → bf16
    rounding);
  * the plain versions against the f64 product of the stored values: 1e-6
    of sum |x||v| (f32 sums in another order; a bf16 value widens exactly);
  * against JAX's operator: JAX rounds the f32 vector to bf16 first
    (vampomi_tpu/ops/operator.py:186-197), an error of at most 2^-8 of
    each entry, so |port - JAX| <= 2^-8 sum |x||v| (+ f32 rounding);
  * whole trajectories, LOO p-values and a Gibbs sweep: the int8 design's
    tolerances of test_torch_engine_linear.py and test_torch_modes.py, for
    the same reason (JAX's bf16-rounded vectors against the port's f32)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.dataset import load_dataset as jload
from vampomi_tpu.engine import linear as jlin
from vampomi_tpu.engine import probit as jprob
from vampomi_tpu.gibbs import sampler as jgibbs
from vampomi_tpu.modes import association as jassoc
from vampomi_tpu.ops import operator as jop
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.dataset import load_dataset as tload
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.engine import probit as tprob
from vampomi_tpu_torch.gibbs import sampler as tsampler
from vampomi_tpu_torch.modes import association as tassoc
from vampomi_tpu_torch.ops import bf16 as tbf16
from vampomi_tpu_torch.ops import operator as top
from vampomi_tpu_torch.ops import spectral as tspec
from vampomi_tpu_torch.sim.data_sim import simulate_iid, write_fixture

from tests.test_torch_engine_linear import _jax_engine_probes, cfg_kw
from tests.test_torch_gibbs import JaxDraws, _jax_state_after
from tests.test_torch_probit import probit_kw, replay_draws

torch.set_num_threads(2)

BF16_REL = 2.0 ** -8  # the relative rounding of a vector entry to bf16


@pytest.fixture(scope="module")
def fx():
    return simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42)


def _bits(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        return X.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(X).view(np.uint16)


def _raw_with_ties(fx):
    """The fixture's marker rows with values that round differently f64 →
    bf16 directly and through f32 (just off a bf16 midpoint by less than
    f32's half unit), and a bf16 midpoint itself."""
    X = np.array(fx.X.T, dtype=np.float64)
    X[0, :4] = [1.0 + 2.0 ** -8 + 2.0 ** -30, 1.0 + 2.0 ** -8 - 2.0 ** -30,
                -(3.0 + 2.0 ** -7 + 2.0 ** -29), 1.0 + 2.0 ** -8]
    return X


def test_stored_bf16_bits_and_vectors_equal_jax(fx):
    X = _raw_with_ties(fx)
    jdm = jop.build_design(X, mesh=None, compute_dtype=jnp.bfloat16)
    tdm = top.build_design(X, compute_dtype=torch.bfloat16, device="cpu")
    assert tdm.X.dtype == torch.bfloat16 and tdm.wd == torch.float32
    np.testing.assert_array_equal(_bits(tdm.X), _bits(jdm.X))
    # the trap: rounding f64 straight to bf16 would differ on the ties
    direct = (X[0, :2].view(np.uint64) + (1 << 47)) >> 48  # round half up, one rounding
    assert not np.array_equal(direct.astype(np.uint16), _bits(tdm.X)[0, :2])
    for k in ("mave", "msig", "mmask", "inv_sqrt_n"):
        got, want = getattr(tdm, k).numpy(), np.asarray(getattr(jdm, k))
        assert got.dtype == want.dtype == np.float32, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    # the statistics are those of the raw values, not of the rounded ones
    raw_mean = X.mean(axis=1)
    np.testing.assert_allclose(tdm.mave.numpy(), raw_mean, rtol=1e-6)
    assert not np.allclose(tdm.mave.numpy(), tdm.X.double().mean(dim=1).numpy(), rtol=1e-7,
                           atol=0)


def test_design_from_raw_rows_equals_build_design(fx):
    """design_from_raw_rows, the card's chunked construction (here on the
    CPU, 3 rows a chunk), stores the same bits and statistics as
    build_design."""
    X = _raw_with_ties(fx)
    want = top.build_design(X, compute_dtype=torch.bfloat16, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(top, "PLAIN_CHUNK_BYTES", 3 * 8 * X.shape[1])
    try:
        got = top.design_from_raw_rows(X.shape[0], X.shape[1],
                                       lambda lo, hi: torch.as_tensor(X[lo:hi]), "cpu")
    finally:
        mp.undo()
    assert torch.equal(got.X.view(torch.int16), want.X.view(torch.int16))
    for k in ("mave", "msig", "mmask", "inv_sqrt_n"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def _operands(m, n, k, seed):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(m, n)), dtype=torch.float32).to(torch.bfloat16)
    return (X, torch.as_tensor(rng.normal(size=(n, k)), dtype=torch.float32),
            torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.float32))


@pytest.mark.parametrize("m,n,k", [(300, 257, 1), (1000, 1001, 2), (77, 16, 8), (3, 8, 3)])
def test_plain_versions_match_the_f64_product(m, n, k):
    X, Ys, W = _operands(m, n, k, seed=m + k)
    A = X.double()

    def close(got, want, scale):
        assert float(((got.double() - want).abs() / scale).max()) < 1e-6

    close(tbf16.atx_batch_bf16(X, Ys), A @ Ys.double(), A.abs() @ Ys.double().abs())
    close(tbf16.ax_batch_bf16(X, W), A.T @ W.double(), A.abs().T @ W.double().abs())
    y = Ys[:, 0].contiguous()
    close(tbf16.atx_bf16(X, y)[:, None], (A @ y.double())[:, None],
          (A.abs() @ y.double().abs())[:, None])
    # the CPU runs the plain versions and counts no launch
    assert tbf16.atx_bf16.launches == tbf16.ax_batch_bf16.launches == 0


def test_plain_versions_chunk_without_changing_the_result(monkeypatch):
    X, Ys, W = _operands(1000, 64, 2, seed=1)
    whole = (tbf16.atx_batch_bf16_plain(X, Ys), tbf16.ax_batch_bf16_plain(X, W))
    monkeypatch.setattr("vampomi_tpu_torch.ops.atx_int8.PLAIN_CHUNK_BYTES", 4 * 64 * 37)
    torch.testing.assert_close(tbf16.atx_batch_bf16_plain(X, Ys), whole[0], rtol=0, atol=0)
    # the marker sum meets its chunks in another order: 1e-6 of sum |x||w|
    scale = X.double().abs().T @ W.double().abs()
    assert float(((tbf16.ax_batch_bf16_plain(X, W) - whole[1]).double().abs() / scale).max()) < 1e-6


def test_wrappers_refuse_what_the_kernels_do_not_take():
    X, Ys, W = _operands(10, 8, 2, seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        tbf16.atx_bf16(X.float(), Ys[:, 0].contiguous())
    with pytest.raises(TypeError, match="float32"):
        tbf16.atx_bf16(X, Ys[:, 0].double())
    with pytest.raises(ValueError, match="K = 9"):
        tbf16.ax_batch_bf16(X, torch.zeros(10, 9))
    with pytest.raises(ValueError, match="contiguous"):
        tbf16.atx_batch_bf16(X, Ys.T.contiguous().T)


def test_bf16_operator_matches_jax_within_its_vector_rounding(fx):
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.bfloat16)
    tdm = top.build_design(fx.X.T, compute_dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(3)
    m, n = tdm.m_pad, int(tdm.n)
    Xa = tdm.X.double().abs().numpy()
    cases = [
        (top.ax, jop.ax, rng.normal(size=m), lambda v: (Xa.T @ np.abs(v * tdm.msig.numpy()))),
        (top.atx, jop.atx, rng.normal(size=n), lambda v: tdm.msig.numpy() * (Xa @ np.abs(v))),
        (top.ax_batch, jop.ax_batch, rng.normal(size=(m, 2)),
         lambda v: Xa.T @ np.abs(v * tdm.msig.numpy()[:, None])),
        (top.atx_batch, jop.atx_batch, rng.normal(size=(n, 2)),
         lambda v: tdm.msig.numpy()[:, None] * (Xa @ np.abs(v))),
    ]
    for op, jop_fn, v, bound in cases:
        v = v.astype(np.float32)
        got = op(tdm, torch.as_tensor(v)).numpy()
        want = np.asarray(jop_fn(jdm, jnp.asarray(v)))
        assert got.dtype == np.float32 and got.shape == want.shape
        tol = (BF16_REL + 1e-5) * bound(v) / np.sqrt(n) + 1e-6 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), op.__name__
        # the port is the f64 product of the stored values, JAX is not
        exact = op(tdm._replace(X=tdm.X.double(), mave=tdm.mave.double(),
                                msig=tdm.msig.double(), mmask=tdm.mmask.double(),
                                inv_sqrt_n=tdm.inv_sqrt_n.double()),
                   torch.as_tensor(v, dtype=torch.float64)).numpy()
        assert np.abs(got - exact).max() < np.abs(want - exact).max(), op.__name__


def test_bf16_gram_matches_jax(fx):
    """K of a bf16 design: the port upcasts each block to f32; JAX rounds
    w·x to bf16 (vampomi_tpu/ops/spectral.py:111-133), a zero-mean ~2^-9
    perturbation per term that averages over M markers: 1e-3 of K's
    largest entry."""
    from vampomi_tpu.ops import spectral as jspec

    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.bfloat16)
    tdm = top.build_design(fx.X.T, compute_dtype=torch.bfloat16, device="cpu")
    got = tspec.gram(tdm).numpy()
    want = np.asarray(jspec.build_spectral(jdm).K)
    exact = tspec.gram(convert.design_from_arrays(
        {**{k: np.asarray(v) for k, v in jdm._asdict().items()},
         "X": tdm.X.double().numpy()})).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5 * np.abs(exact).max())


@pytest.mark.parametrize("solver", ["eigen", "spectral", "cg"])
def test_bf16_linear_trajectory_matches_jax(fx, tmp_path, monkeypatch, solver):
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.bfloat16)
    kw = cfg_kw(tmp_path, iterations=4, lmmse_solver=solver)
    jres = jlin.infere_linear(jdm, fx.y, JConfig(**kw), true_signal=fx.beta,
                              write_outputs=False)
    feed = iter(_jax_engine_probes(kw["seed"], 4, fx.X.shape[1], jnp.float32))
    monkeypatch.setattr(tlin, "_draw_probe", lambda gen, dm: next(feed))
    tdm = top.build_design(fx.X.T, compute_dtype=torch.bfloat16, device="cpu")
    tres = tlin.infere_linear(tdm, fx.y, RunConfig(**kw, device="cpu"), true_signal=fx.beta,
                              write_outputs=False)
    got, want = np.asarray(tres.metrics_history), np.asarray(jres.metrics_history)
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(tres.gamw, jres.gamw, rtol=2e-2)
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled,
                               atol=2e-2 * np.abs(jres.x1_hat_scaled).max())
    assert np.corrcoef(tres.x1_hat_scaled, fx.beta)[0, 1] > 0.75


@pytest.mark.parametrize("solver", ["eigen", "cg"])
def test_bf16_probit_trajectory_matches_jax(tmp_path, solver):
    from tests.test_torch_probit import ITERS

    fx = simulate_iid(n=400, m=300, lam=0.15, h2=0.9, seed=9)
    rng = np.random.default_rng(10)
    ybin = (fx.X @ fx.beta + rng.normal(0, np.sqrt(0.1), 400) > 0).astype(float)
    jres = jprob.infere_bin_class(
        jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.bfloat16), ybin,
        JConfig(**probit_kw(tmp_path, lmmse_solver=solver)), true_signal=fx.beta,
        write_outputs=False)
    mp = pytest.MonkeyPatch()
    try:
        replay_draws(mp, 3, len(ybin), fx.X.shape[1], ITERS, jnp.float32, probes=solver == "cg")
        tres = tprob.infere_bin_class(
            top.build_design(fx.X.T, compute_dtype=torch.bfloat16, device="cpu"), ybin,
            RunConfig(**probit_kw(tmp_path, lmmse_solver=solver, device="cpu")),
            true_signal=fx.beta, write_outputs=False)
    finally:
        mp.undo()
    got, want = np.asarray(tres.metrics_history), np.asarray(jres.metrics_history)
    assert np.all(np.isfinite(got)) and got.shape == want.shape
    # confusion counts within 3 samples of 400, accuracy and correlations to 1e-2
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=3.0)
    np.testing.assert_allclose(tres.x1_hat_scaled, jres.x1_hat_scaled,
                               atol=3e-2 * np.abs(jres.x1_hat_scaled).max())


@pytest.mark.parametrize("method", ["loo", "loo_std"])
def test_bf16_loo_pvals_match_jax(tmp_path, method):
    """LOO on a bf16 design: the port's f64 moments of the stored values
    and atx_bf16's f32 X y_mod, against JAX's bf16-rounded y_mod; log10 p
    to 2e-2, as for the quantized designs (test_torch_modes.py)."""
    n, m = 300, 512
    sim = simulate_iid(n=n, m=m, lam=0.1, h2=0.8, seed=5)
    paths = write_fixture(sim, str(tmp_path), "ex")
    est = str(tmp_path / "w_it_3.bin")
    (sim.beta * 0.9).astype("<f8").tofile(est)
    jds = jload(paths["bin"], paths["phen"], n, m, "linear", None, jnp.bfloat16)
    tds = tload(paths["bin"], paths["phen"], n, m, "linear", torch.bfloat16, "cpu")
    base = dict(out_dir=str(tmp_path), meth_file="x", N=n, Mt=m, pval_method=method,
                estimate_file=est)
    got = tassoc.run_association_test(tds, RunConfig(out_name="pt", **base))
    want = jassoc.run_association_test(jds, JConfig(out_name="jx", **base))
    lg, lw = np.log10(got + 1e-300), np.log10(want + 1e-300)
    np.testing.assert_allclose(lg, lw, rtol=2e-2, atol=2e-2)
    assert (got[sim.beta != 0] < 0.05 / m).sum() > 0


def test_bf16_gibbs_grams_and_a_sweep_match_jax():
    """Block Grams: both packages multiply the f32-upcast standardized rows
    at full f32 precision (rtol 2e-5, the f32 Gram tolerance of
    test_torch_gibbs.py).  One sweep from JAX's state with JAX's draws
    replayed: the block passes differ by JAX's bf16 rounding of the
    vectors, so a draw near a boundary may flip: at most 4 of 512
    components differ, x to 1e-2 of its largest value where they agree."""
    rng = np.random.default_rng(7)
    m, n = 512, 128
    X = rng.normal(size=(m, n))
    beta = np.zeros(m)
    beta[rng.choice(m, 10, replace=False)] = rng.normal(0, 0.5, 10)
    y = X.T @ beta + rng.normal(0, 1.0, n)
    y = (y - y.mean()) / y.std(ddof=1)
    jdm = jop.build_design(X, mesh=None, compute_dtype=jnp.bfloat16)
    tdm = top.build_design(X, compute_dtype=torch.bfloat16, device="cpu")
    want = np.asarray(jgibbs.build_block_grams(jdm, block=64))
    tgrams = tsampler.build_block_grams(tdm, block=64)
    np.testing.assert_allclose(tgrams.numpy(), want, rtol=2e-5, atol=2e-6)

    grams, jstate, cvars, key = _jax_state_after(jdm, y, 2)
    jarrays = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    tstate = convert.gibbs_state_from_arrays(jarrays)
    draws = JaxDraws(0)
    draws.key = key
    key, ks = jax.random.split(key)
    jnew = jgibbs.gibbs_sweep(jdm, grams, jstate, cvars, ks, block=64)
    tnew, _ = tsampler.gibbs_sweep(tdm, tgrams, tstate, torch.as_tensor(np.array(cvars)),
                                   draws, torch.as_tensor(y, dtype=torch.float32), block=64)
    same = tnew.comp.numpy() == np.asarray(jnew.comp)
    assert (~same).sum() <= 4
    jx = np.asarray(jnew.x)
    np.testing.assert_allclose(tnew.x.numpy()[same], jx[same], rtol=0,
                               atol=1e-2 * np.abs(jx).max())
    assert os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
