"""Carry the JAX package's state into the port's objects.

Each function takes a dict of numpy arrays — the fields of a JAX
`DesignMatrix`, `MixturePrior`, `GramFactor`, `ShiftInverse` or
`EigenFactor` or `GibbsState`, already fetched with np.asarray by the caller — and builds the
port's counterpart on a given device.  Parity tests go through these so that
both packages compute on identical inputs.  `checkpoint_from_jax` carries a
JAX-written checkpoint file into a run of the port.  Nothing here imports
jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .gibbs.sampler import GibbsState
from .ops.eigen import EigenFactor
from .ops.operator import DesignMatrix
from .ops.spectral import GramFactor, ShiftInverse
from .prior.mixture import MixturePrior
from .sharding import Shard, local_rows

# X dtypes torch takes from numpy as they are (uint8: packed int4, two
# nibbles a byte)
_NP_DTYPES = {np.dtype(t) for t in (np.int8, np.uint8, np.float32, np.float64)}
# the marker-length arrays of the engines' checkpoints (the rest are N- or
# C-length, or O(1))
_M_ARRAYS = ("x1_hat", "r1", "r2", "mu_warm")


def design_from_arrays(d: dict, device: str | torch.device = "cpu",
                       shard: Shard | None = None) -> DesignMatrix:
    """DesignMatrix from `X, mave, msig, mmask, inv_sqrt_n, n, mt`.  X keeps
    its dtype (f64, f32, bf16, int8 or packed-int4 uint8); the vectors go to
    the work dtype.  With a `shard`, the rank's rows [lo, hi) of the Mt real
    markers: the padding rows a JAX mesh adds past Mt (mmask 0) are
    dropped, since the port's slabs have none."""
    mt = int(np.asarray(d["mt"]))

    def rows(a):
        return np.asarray(a) if shard is None else local_rows(np.asarray(a)[:mt], shard)

    X = rows(d["X"])
    if X.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: the bits as they are
        Xt = torch.from_numpy(np.ascontiguousarray(X).view(np.int16).copy()).view(torch.bfloat16)
    elif X.dtype in _NP_DTYPES:
        Xt = torch.tensor(X)  # a copy: JAX hands out read-only buffers
    else:
        raise NotImplementedError(f"X dtype {X.dtype} is not ported")
    wd = Xt.dtype if Xt.dtype in (torch.float32, torch.float64) else torch.float32

    def vec(a):
        return torch.tensor(np.asarray(a, dtype=np.float64)).to(device=device, dtype=wd)

    return DesignMatrix(
        X=Xt.to(device),
        mave=vec(rows(d["mave"])),
        msig=vec(rows(d["msig"])),
        mmask=vec(rows(d["mmask"])),
        inv_sqrt_n=vec(d["inv_sqrt_n"]).reshape(()),
        n=float(np.asarray(d["n"])),
        mt=float(mt),
        shard=shard,
    )


def prior_from_arrays(d: dict, device: str | torch.device = "cpu") -> MixturePrior:
    """MixturePrior from `probs, vars, active`."""
    return MixturePrior(
        probs=torch.tensor(np.asarray(d["probs"], dtype=np.float64)).to(device),
        vars=torch.tensor(np.asarray(d["vars"], dtype=np.float64)).to(device),
        active=torch.tensor(np.asarray(d["active"], dtype=bool)).to(device),
    )


def gram_from_arrays(d: dict, device: str | torch.device = "cpu",
                     dtype: torch.dtype | None = None) -> GramFactor:
    """GramFactor from `K` (dtype kept unless given)."""
    K = torch.tensor(np.asarray(d["K"]))
    return GramFactor(K=K.to(device=device, dtype=dtype or K.dtype))


def shift_inverse_from_arrays(d: dict, device: str | torch.device = "cpu",
                              dtype: torch.dtype | None = None) -> ShiftInverse:
    """ShiftInverse from `W, T`; T is f64, W keeps its dtype unless given."""
    W = torch.tensor(np.asarray(d["W"]))
    return ShiftInverse(
        W=W.to(device=device, dtype=dtype or W.dtype),
        T=torch.tensor(np.asarray(d["T"], dtype=np.float64)).to(device),
    )


def eigen_from_arrays(d: dict, device: str | torch.device = "cpu",
                      dtype: torch.dtype | None = None) -> EigenFactor:
    """EigenFactor from `U, lam`; lam is f64, U keeps its dtype unless given."""
    U = torch.tensor(np.asarray(d["U"]))
    return EigenFactor(
        U=U.to(device=device, dtype=dtype or U.dtype),
        lam=torch.tensor(np.asarray(d["lam"], dtype=np.float64)).to(device),
    )


def gibbs_state_from_arrays(d: dict, device: str | torch.device = "cpu") -> GibbsState:
    """GibbsState from `x, comp, y_resid, mu, sigma_g, sigma_e, pi`: x and
    y_resid keep their (work) dtype, comp becomes int32, the rest f64."""
    def f64(a):
        return torch.tensor(np.asarray(a, dtype=np.float64)).to(device)

    return GibbsState(
        x=torch.tensor(np.asarray(d["x"])).to(device),
        comp=torch.tensor(np.asarray(d["comp"], dtype=np.int32)).to(device),
        y_resid=torch.tensor(np.asarray(d["y_resid"])).to(device),
        mu=f64(d["mu"]).reshape(()),
        sigma_g=f64(d["sigma_g"]).reshape(()),
        sigma_e=f64(d["sigma_e"]).reshape(()),
        pi=f64(d["pi"]),
    )


def checkpoint_from_jax(ck: dict | str, model: str, solver: str) -> dict:
    """A JAX-written checkpoint (format 1, engine/checkpoint.py), as the
    port's engines resume it, for a run of `model` under the LMMSE `solver`
    that will run.  `ck` is a path or what `load_checkpoint` returned.

    The arrays, scalars and prior carry over as they are.  The JAX PRNG key
    does not: a torch.Generator cannot replay its stream, so the resumed run
    keeps its own seeded generator.  That is exact only where the rest of
    the run draws nothing that feeds a result: the eigen and spectral
    solvers (their traces are closed forms, the probe goes unused), for the
    linear model and, since the checkpoint holds p1, the probit one.  Under
    CG every iteration draws a Rademacher probe, so this raises.

    A run on a padded JAX mesh (meta m_pad > mt) saved its marker vectors
    with the padding rows; they are cut to the Mt real markers, and m_pad
    becomes mt, as in every checkpoint of the port."""
    from .engine.checkpoint import JAX_FORMAT_VERSION, load_checkpoint

    if isinstance(ck, str):
        ck = load_checkpoint(ck)
    if ck["version"] != JAX_FORMAT_VERSION or ck.get("rng_key") is None:
        raise ValueError(f"not a JAX-written checkpoint (format {ck['version']})")
    if solver not in ("eigen", "spectral"):
        raise ValueError(
            f"a JAX-written checkpoint cannot resume a {model} run under the {solver!r} "
            "LMMSE solver: it draws a Rademacher probe every iteration, and the JAX "
            "PRNG key the checkpoint holds cannot be replayed by the port's "
            "torch.Generator (use --lmmse-solver eigen or spectral, or resume it "
            "with the JAX package)")
    meta = ck.get("meta", {})
    if "mt" in meta and "m_pad" in meta and int(meta["m_pad"]) > int(meta["mt"]):
        mt = int(meta["mt"])
        arrays = {k: (np.asarray(v)[:mt] if k in _M_ARRAYS else v)
                  for k, v in ck["arrays"].items()}
        ck = dict(ck, arrays=arrays, meta=dict(meta, m_pad=np.asarray(mt)))
    return dict(ck, rng_state=None)
