"""The port's eigen cache (vampomi_tpu_torch/ops/eigen.py build_eigen_cached)
and auto's warm-cache upgrade, the counterparts of tests/test_eigen.py:262-316.

A loaded factor is bitwise the factor that was saved; every stale, foreign
(the JAX package's), corrupt or truncated cache is a miss that rebuilds and
overwrites.  The port's fingerprint probe is numpy's, not JAX's, so its
caches carry the probe's name."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.engine import linear as jlin
from vampomi_tpu.ops import eigen as jeig
from vampomi_tpu.ops.spectral import GramFactor as JGram
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.ops import eigen as teig
from vampomi_tpu_torch.ops.operator import build_design
from vampomi_tpu_torch.ops.spectral import GramFactor
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)


def _gram_np(n, m, seed):
    """tests/test_eigen.py:22-32."""
    A = np.random.default_rng(seed).standard_normal((m, n))
    K = (A.T @ A) / m
    return 0.5 * (K + K.T)


def _gram(n, m, seed, dtype=torch.float64):
    return GramFactor(K=torch.as_tensor(_gram_np(n, m, seed)).to(dtype))


def test_eigen_cache_round_trip_and_rebuilds(tmp_path):
    """Build and persist, then load the identical factor; another dataset,
    another seed and a corrupt file each rebuild and overwrite."""
    path = str(tmp_path / "eig.npz")
    fac = _gram(192, 768, seed=6)
    ef1, d1 = teig.build_eigen_cached(fac, path)
    assert d1["loaded"] is False and os.path.exists(path)
    ef2, d2 = teig.build_eigen_cached(fac, path)
    assert d2["loaded"] and d2["resid"] == d1["resid"] and d2["ortho"] == d1["ortho"]
    assert torch.equal(ef2.U, ef1.U) and torch.equal(ef2.lam, ef1.lam)
    assert os.listdir(tmp_path) == ["eig.npz"]  # no tmp file left

    other = _gram(192, 768, seed=7)
    ef3, d3 = teig.build_eigen_cached(other, path)
    assert not d3["loaded"]
    lam_np = np.linalg.eigvalsh(other.K.numpy())
    assert np.max(np.abs(np.sort(ef3.lam.numpy()) - lam_np)) / np.abs(lam_np).max() < 1e-9
    assert teig.build_eigen_cached(other, path)[1]["loaded"]
    assert not teig.build_eigen_cached(other, path, seed=3)[1]["loaded"]
    assert teig.build_eigen_cached(other, path, seed=3)[1]["loaded"]

    with open(path, "wb") as f:
        f.write(b"not an npz")
    assert not teig.build_eigen_cached(other, path, seed=3)[1]["loaded"]
    assert teig.build_eigen_cached(other, path, seed=3)[1]["loaded"]
    with open(path, "r+b") as f:  # truncated
        f.truncate(os.path.getsize(path) // 2)
    assert not teig.build_eigen_cached(other, path, seed=3)[1]["loaded"]


def test_eigen_cache_keeps_the_work_dtype(tmp_path):
    path = str(tmp_path / "eig32.npz")
    fac = _gram(96, 400, seed=2, dtype=torch.float32)
    ef1, _ = teig.build_eigen_cached(fac, path)
    ef2, d2 = teig.build_eigen_cached(fac, path)
    assert d2["loaded"] and ef2.U.dtype == torch.float32 and ef2.lam.dtype == torch.float64
    assert torch.equal(ef2.U, ef1.U)


def test_eigen_cache_rejects_another_dataset_at_production_ratio(tmp_path):
    """M/N = 256: the trace of any two standardized same-shape Grams is ~N,
    so trace and sketch are compared apart (tests/test_eigen.py:300-314)."""
    path = str(tmp_path / "eig.npz")
    n, m = 64, 16384
    teig.build_eigen_cached(_gram(n, m, seed=1), path)
    assert not teig.build_eigen_cached(_gram(n, m, seed=2), path)[1]["loaded"]


def test_a_jax_written_cache_is_a_miss(tmp_path, capsys):
    """The JAX package's cache of the same K: its probe is JAX's, so the
    port logs one line, rebuilds and overwrites, and never trusts it; and
    it does not make auto pick eigen."""
    path = str(tmp_path / "jax.npz")
    K = _gram_np(128, 600, seed=4)
    jeig.build_eigen_cached(JGram(K=jnp.asarray(K)), path, leaf=64)
    assert not teig.cache_plausible(path, 128)
    ef, d = teig.build_eigen_cached(GramFactor(K=torch.as_tensor(K)), path)
    assert not d["loaded"]
    err = capsys.readouterr().err
    assert err.count("rebuilding") == 1 and "not this package's" in err
    assert teig.cache_plausible(path, 128) and not teig.cache_plausible(path, 129)
    assert teig.build_eigen_cached(GramFactor(K=torch.as_tensor(K)), path)[1]["loaded"]


def test_fingerprint_is_seeded_and_discriminates():
    a, b = _gram(64, 512, seed=1), _gram(64, 512, seed=2)
    fa = teig.fingerprint(a.K)
    np.testing.assert_array_equal(fa, teig.fingerprint(a.K))
    z = np.random.default_rng(teig.FINGERPRINT_SEED).standard_normal(64)
    np.testing.assert_allclose(fa[1:], (a.K.numpy() @ z)[:8], rtol=1e-12)
    assert np.linalg.norm(teig.fingerprint(b.K)[1:] - fa[1:]) > 1e-3 * np.linalg.norm(fa[1:])


@pytest.mark.parametrize("cache", [False, True])
def test_choose_lmmse_solver_agrees_with_jax_on_one_device(tmp_path, cache):
    """auto, with a warm cache of this N or none, on a grid of (N, Mt)."""
    for n in (1024, 2048, 4096, 16384, 20000):
        path = str(tmp_path / f"c{n}.npz")
        if cache:
            np.savez(path, n=np.asarray(n), probe=np.asarray(teig.FINGERPRINT_PROBE))
        for mt in (4 * n - 1, 4 * n, 40 * n):
            for solver in ("auto", "cg", "spectral", "eigen"):
                kw = dict(lmmse_solver=solver, eigen_cache=path)
                got = tlin.choose_lmmse_solver(RunConfig(**kw), mt, n)
                assert got == jlin.choose_lmmse_solver(JConfig(**kw), mt, n, n_devices=1), \
                    (n, mt, solver, cache)
                assert not (solver == "auto" and cache and got == "spectral"), \
                    "a warm cache must upgrade auto's spectral"


def test_cache_upgrade_picks_eigen_and_loads_in_the_engine(tmp_path, capsys):
    """At N = 2048 and Mt = 4N, auto picks spectral cold and eigen warm; the
    warm run loads the factor and repeats the eigen run's estimates
    bitwise."""
    fx = simulate_iid(n=2048, m=8192, lam=0.02, h2=0.8, seed=1)
    dm = build_design(fx.X.T, compute_dtype=torch.float32, device="cpu")
    path = str(tmp_path / "eig.npz")
    common = dict(out_dir=str(tmp_path), out_name="w", iterations=2, h2=0.8, trace=0,
                  probs=[0.98, 0.02], vars=[0.0, 1e-3], device="cpu", eigen_cache=path)
    cold = tlin.infere_linear(dm, fx.y, RunConfig(**common), write_outputs=False)
    assert cold.solver == "spectral" and not os.path.exists(path)
    built = tlin.infere_linear(dm, fx.y, RunConfig(**common, lmmse_solver="eigen"),
                               write_outputs=False)
    assert built.solver == "eigen" and os.path.exists(path)
    capsys.readouterr()
    warm = tlin.infere_linear(dm, fx.y, RunConfig(**common), write_outputs=False)
    assert warm.solver == "eigen" and "eigenbasis of K loaded" in capsys.readouterr().out
    np.testing.assert_array_equal(warm.x1_hat_scaled, built.x1_hat_scaled)
