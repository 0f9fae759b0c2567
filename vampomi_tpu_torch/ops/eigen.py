"""Eigen-LMMSE: once-per-dataset eigendecomposition of the Gram matrix
(port of vampomi_tpu/ops/eigen.py:84-107, 935-980).

K = A A^T is fixed for the whole run; only the shift pair (tau, gam2) of the
dual matrix S = gam2 I + tau K moves between iterations.  Diagonalizing K
once,

    K = U diag(lam) U^T,

makes every per-iteration dense quantity O(N^2) or closed-form:

    S^{-1} b   = U ((gam2 + tau*lam)^{-1} ∘ (U^T b))      [2 matvecs]
    tr(S^{-1}) = sum_i 1/(gam2 + tau*lam_i)               [exact, f64]

`EigenFactor.solve` gives an iteration both, with the two trace closed
forms, under the contract of the spectral solver's `GramFactor.solve`.

The build is `torch.linalg.eigh` of K in f64, as the JAX package's own
small-N host leaf does (eigen.py:565-572).  The JAX package's sign-function
divide-and-conquer eigensolver (eigen.py:121-797) exists because XLA's TPU eigh
is unusable; on the card cuSOLVER's eigh serves, so it is not ported.

`build_eigen_cached` keeps the factor in an `.npz` across runs (the JAX
package's `--eigen-cache`, eigen.py:818-932), validated against the live K
by a fingerprint of this package's own (see `fingerprint`).

Sharded over markers, K is the same on every rank, but the factor is made
once: rank 0 alone builds it (or loads, or builds and writes the cache) and
broadcasts the verdict, U and lam, so every rank holds the same factor by
construction (vampomi_tpu/ops/eigen.py:875-932).  The JAX package also
shards U's columns over its mesh (eigen.py:795-815); here every rank holds
all of U (ROADMAP.md queue 1 says why the split waits).
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..sharding import Shard, broadcast_, broadcast_from0
from ..utils.telemetry import span
from .operator import f64
from .spectral import GramFactor, _trace_closed_forms


class EigenFactor(NamedTuple):
    """The reusable eigen-LMMSE state.

    U   : (N, N) orthonormal eigenvectors of K (columns, ascending lam), in
          the work dtype.
    lam : (N,) f64 Rayleigh eigenvalues diag(U^T K U) of the U actually
          used, so the per-iteration traces are exact closed forms.
    """

    U: torch.Tensor
    lam: torch.Tensor

    @property
    def n(self) -> int:
        return self.U.shape[0]

    def solve(self, av: torch.Tensor, tau, gam2, mt):
        """The N x N step of an exact iteration, S = gam2 I + tau K:
        (q = S^{-1} av, tr Q^{-1}, tr A^T A Q^{-1}), the traces f64 over the
        mt markers (`GramFactor.solve`'s contract).  q = U (d ∘ (U^T av))
        in U's dtype, d = 1/(gam2 + tau lam) from eigen_weights: the one
        place that applies S^{-1}."""
        d, T = eigen_weights(self, tau, gam2)
        U = self.U
        q = U @ (d.to(U.dtype) * (U.T @ av.to(U.dtype)))
        return (q, *_trace_closed_forms(T, self.n, mt, tau, gam2))


def build_eigen(fac: GramFactor, shard: Shard | None = None) -> tuple[EigenFactor, dict]:
    """Diagonalize K = fac.K.  Returns (EigenFactor, diagnostics) with
    diagnostics = {"resid": ||K U - U lam||_F / ||K||_F,
    "ortho": max |U^T U - I|}, both measured on U in the work dtype
    against K in f64.  With a shard, rank 0's factor on every rank."""
    return _from_rank0(fac, shard, lambda: _build_eigen(fac))


def _from_rank0(fac: GramFactor, shard: Shard | None, make) -> tuple[EigenFactor, dict]:
    """make() → (EigenFactor, diagnostics) on rank 0 alone, its factor and
    its verdicts (residual, orthogonality, cache hit) broadcast to the other
    ranks, whose diagnostics carry "load_s", the wait, on a hit.  Without
    a shard, make() itself."""
    if shard is None:
        return make()
    t0 = time.perf_counter()
    if shard.rank == 0:
        ef, diag = make()
        # U goes out in rank 0's own layout (eigh's is column-major), so that
        # its products round alike on every rank and as without a shard
        colmajor = not ef.U.is_contiguous() and ef.U.T.is_contiguous()
        buf, lam = (ef.U.T if colmajor else ef.U).contiguous(), ef.lam.contiguous()
        head = [diag["resid"], diag["ortho"], diag.get("loaded", False), "loaded" in diag,
                colmajor]
    else:
        buf = torch.empty_like(fac.K, memory_format=torch.contiguous_format)
        lam = torch.empty(fac.n, dtype=torch.float64, device=fac.K.device)
        head = [0.0] * 5
    resid, ortho, loaded, cached, colmajor = broadcast_from0(head, shard)
    broadcast_(buf, shard)
    broadcast_(lam, shard)
    ef = EigenFactor(U=buf.T if colmajor else buf, lam=lam)
    if shard.rank != 0:
        diag = {"resid": resid, "ortho": ortho}
        if cached:
            diag["loaded"] = bool(loaded)
            if loaded:
                diag["load_s"] = time.perf_counter() - t0
    return ef, diag


def _build_eigen(fac: GramFactor) -> tuple[EigenFactor, dict]:
    """build_eigen on this process; diagnostics["solve_s"] is the wall of
    the eigh alone."""
    wd = fac.K.dtype
    K64 = fac.K.to(torch.float64)
    K64 = 0.5 * (K64 + K64.T)
    with span("eigh.solve") as solve:
        _, V = torch.linalg.eigh(K64)
        if V.is_cuda:  # eigh reads its info on the host anyway
            torch.cuda.synchronize(V.device)
    U = V.to(wd)
    U64 = U.to(torch.float64)
    KU = K64 @ U64
    lam = (U64 * KU).sum(dim=0)  # Rayleigh values diag(U^T K U)
    resid = torch.linalg.norm(KU - U64 * lam[None, :]) / torch.linalg.norm(K64)
    G = U64.T @ U64
    ortho = (G - torch.eye(fac.n, dtype=torch.float64, device=G.device)).abs().max()
    return EigenFactor(U=U, lam=lam), {"resid": float(resid), "ortho": float(ortho),
                                       "solve_s": solve.seconds}


# The fingerprint's probe: a standard normal N-vector from numpy's PCG64 at
# this seed, drawn in f64.  The JAX package draws its probe from
# jax.random.PRNGKey(987654321) (vampomi_tpu/ops/eigen.py:176-186), which
# this package cannot reproduce without jax, so its caches carry the name
# of their probe and a cache of the other package is a miss.
FINGERPRINT_SEED = 987654321
FINGERPRINT_PROBE = "numpy-pcg64-987654321-f64"
_CACHE_KEYS = {"U", "lam", "resid", "ortho", "n", "seed", "fp", "probe"}


def fingerprint(K: torch.Tensor) -> np.ndarray:
    """Dataset fingerprint of the eigen cache, f64 on the host: trace(K)
    and the first 8 entries of K z for the fixed probe z (cast to K's
    dtype).  The trace alone does not tell datasets apart (any two
    standardized same-shape Grams have trace ~N); the sketch differs at
    O(1) relative scale between datasets."""
    n = K.shape[0]
    z = np.random.default_rng(FINGERPRINT_SEED).standard_normal(n)
    s = K @ torch.as_tensor(z).to(device=K.device, dtype=K.dtype)
    return torch.cat([torch.trace(K)[None], s[:8]]).cpu().numpy().astype(np.float64)


def cache_plausible(path: str, n: int, shard: Shard | None = None) -> bool:
    """Cheap check that `path` is a readable eigen cache of this package for
    this N: enough for "auto" to pick eigen (the fingerprint is validated in
    build_eigen_cached).  A corrupt or foreign file must not flip the
    choice, which counts on the eigh being a file load.  With a shard, rank
    0's verdict on every rank."""
    if shard is not None:
        return bool(broadcast_from0([shard.rank == 0 and cache_plausible(path, n)], shard)[0])
    if not os.path.exists(path):
        return False
    try:
        with np.load(path) as z:
            return ("n" in z.files and int(z["n"]) == n and "probe" in z.files
                    and str(z["probe"]) == FINGERPRINT_PROBE)
    except Exception:
        return False


def _load_cache(path: str, n: int, seed: int, fp_live: np.ndarray):
    """(U, lam, resid, ortho) of the cache at `path` when it is readable,
    whole and made for this K (N, the seed, the trace and the sketch each
    within a relative 1e-3, compared apart); else None with the reason.
    Never raises."""
    try:
        with np.load(path) as z:
            if "probe" not in z.files and _CACHE_KEYS - {"probe"} <= set(z.files):
                return None, ("the JAX package's cache: its fingerprint probe is not "
                              "this package's")
            if not _CACHE_KEYS <= set(z.files):
                return None, "not an eigen cache"
            if str(z["probe"]) != FINGERPRINT_PROBE:
                return None, f"fingerprint probe {str(z['probe'])!r}, not this package's"
            fp_old = np.asarray(z["fp"], dtype=np.float64)
            if int(z["n"]) != n or int(z["seed"]) != seed or fp_old.shape != fp_live.shape:
                return None, "made for another N or seed"
            tr_ok = abs(fp_old[0] - fp_live[0]) <= 1e-3 * max(abs(fp_live[0]), 1e-30)
            sk_ok = (np.linalg.norm(fp_old[1:] - fp_live[1:])
                     <= 1e-3 * max(np.linalg.norm(fp_live[1:]), 1e-30))
            if not (tr_ok and sk_ok):
                return None, "made for another dataset"
            return (np.asarray(z["U"]), np.asarray(z["lam"]),
                    float(z["resid"]), float(z["ortho"])), ""
    except Exception as e:  # an unreadable or truncated file is a miss
        return None, f"unreadable ({type(e).__name__})"


def build_eigen_cached(fac: GramFactor, cache_path: str, seed: int = 0,
                       shard: Shard | None = None) -> tuple[EigenFactor, dict]:
    """build_eigen with the factor kept on disk (vampomi_tpu/ops/eigen.py:
    818-932, one process): the eigenbasis is a function of the dataset (K),
    so a rerun, a resumed run or another run mode over the same data loads
    it instead of running the eigh.  The Gram is still built: the
    fingerprint reads K.

    The .npz stores (U, lam, resid, ortho, n, seed, fp, probe), written
    atomically (per-pid tmp, fsync, rename).  A missing, unreadable,
    truncated, foreign (the JAX package's) or stale cache is a miss, logged
    in one line when the file exists: the factor is rebuilt and the file
    overwritten.  diagnostics["loaded"] says which happened, and
    "load_s" or "write_s" the wall seconds of the file's part.  With a
    shard, rank 0 alone reads and writes the file (_from_rank0)."""
    return _from_rank0(fac, shard, lambda: _build_eigen_cached(fac, cache_path, seed))


def _build_eigen_cached(fac: GramFactor, cache_path: str, seed: int) -> tuple[EigenFactor, dict]:
    """build_eigen_cached on this process."""
    from ..engine.checkpoint import atomic_savez

    n = fac.n
    fp_live = fingerprint(fac.K)
    if os.path.exists(cache_path):
        t0 = time.perf_counter()
        hit, why = _load_cache(cache_path, n, seed, fp_live)
        if hit is not None:
            u_np, lam_np, resid, ortho = hit
            U = torch.as_tensor(u_np).to(device=fac.K.device, dtype=fac.K.dtype)
            lam = torch.as_tensor(np.asarray(lam_np, dtype=np.float64)).to(fac.K.device)
            return EigenFactor(U=U, lam=lam), {"resid": resid, "ortho": ortho, "loaded": True,
                                               "load_s": time.perf_counter() - t0}
        print(f"eigen cache {cache_path}: {why} — rebuilding", file=sys.stderr, flush=True)
    ef, diag = _build_eigen(fac)
    t0 = time.perf_counter()
    atomic_savez(cache_path, U=ef.U.cpu().numpy(), lam=ef.lam.cpu().numpy(),
                 resid=diag["resid"], ortho=diag["ortho"], n=n, seed=seed, fp=fp_live,
                 probe=FINGERPRINT_PROBE)
    return ef, {**diag, "loaded": False, "write_s": time.perf_counter() - t0}


def eigen_weights(ef: EigenFactor, tau, gam2):
    """d_i = 1/(gam2 + tau lam_i) in f64, plus T = sum d (= tr S^{-1})."""
    tau64 = f64(tau, ef.lam.device)
    gam264 = f64(gam2, ef.lam.device)
    d = 1.0 / (gam264 + tau64 * ef.lam)
    return d, d.sum()
