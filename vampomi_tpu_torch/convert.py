"""Carry the JAX package's state into the port's objects.

Each function takes a dict of numpy arrays — the fields of a JAX
`DesignMatrix`, `MixturePrior`, `GramFactor` or `EigenFactor`, already
fetched with np.asarray by the caller — and builds the port's counterpart on
a given device.  Parity tests go through these so that both packages compute
on identical inputs.  Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.eigen import EigenFactor
from .ops.operator import DesignMatrix
from .ops.spectral import GramFactor
from .prior.mixture import MixturePrior

_NP_TO_TORCH = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def design_from_arrays(d: dict, device: str | torch.device = "cpu") -> DesignMatrix:
    """DesignMatrix from `X, mave, msig, mmask, inv_sqrt_n, n, mt`.  X keeps
    its dtype (f64, f32 or int8); the vectors go to the work dtype."""
    X = np.asarray(d["X"])
    xd = _NP_TO_TORCH.get(X.dtype)
    if xd is None:
        raise NotImplementedError(f"X dtype {X.dtype} is not ported yet")
    wd = torch.float32 if xd == torch.int8 else xd

    def vec(a):
        return torch.tensor(np.asarray(a, dtype=np.float64)).to(device=device, dtype=wd)

    return DesignMatrix(
        X=torch.tensor(X).to(device),  # a copy: JAX hands out read-only buffers
        mave=vec(d["mave"]),
        msig=vec(d["msig"]),
        mmask=vec(d["mmask"]),
        inv_sqrt_n=vec(d["inv_sqrt_n"]).reshape(()),
        n=float(np.asarray(d["n"])),
        mt=float(np.asarray(d["mt"])),
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


def eigen_from_arrays(d: dict, device: str | torch.device = "cpu",
                      dtype: torch.dtype | None = None) -> EigenFactor:
    """EigenFactor from `U, lam`; lam is f64, U keeps its dtype unless given."""
    U = torch.tensor(np.asarray(d["U"]))
    return EigenFactor(
        U=U.to(device=device, dtype=dtype or U.dtype),
        lam=torch.tensor(np.asarray(d["lam"], dtype=np.float64)).to(device),
    )
