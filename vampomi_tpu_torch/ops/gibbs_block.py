"""The Gibbs sampler's sequential block update: spike-and-slab draws over the
B markers of one block, exact given the block's Gram.

`gibbs_block_update` wraps the hand-written CUDA kernel `csrc/gibbs_block.cu`,
which replaces `block_update` (vampomi_tpu/gibbs/sampler.py:128-175), an XLA
`fori_loop` of B dependent marker steps (no Pallas kernel).  Run as PyTorch
operations from Python, those steps would be some twenty launches each: a
million dependent launches a sweep at the north star.  The kernel runs the
whole loop in one launch.

`gibbs_block_update_plain` is its plain PyTorch version, line for line the
JAX function: the CPU path, and the comparison the kernel is held to on the
card.  Both keep the JAX precisions: the conditional in f64, the local
correlations c in f32 from r0, and c updated as `c - G[j] * d` with the
product and the difference each rounded.

Arguments (as `block_update`'s): Gb (B, B) f32; r0 (B,) f32; xb0, mmask_b,
u, z (B,) in the work dtype (f32 or f64); pi, cvars (L,) f64; sigma_g,
sigma_e f64 scalars (0-d tensors on the block's device: the card reads them
there, so no value crosses to the host).  Returns (xb (B,) in the work
dtype, comp_b (B,) int32).

On a CUDA tensor the wrapper launches the kernel on the current stream (and
raises if it cannot); on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import numpy as np
import torch

from . import _build

WORK_DTYPES = (torch.float32, torch.float64)
# shared memory a block may use on Hopper (bytes)
SMEM_BYTES = 232_448


def needs_scratch(B: int, L: int) -> bool:
    """Whether c lives in a global scratch vector: the kernel's layout
    (csrc/gibbs_block.cu) takes 19,712 + 72 L bytes, 1,536 L more for its
    tables of v, a and sqrt(v) where they fit, and 4 B for c where that fits
    too."""
    base = 19_712 + 72 * L
    if base + 1_536 * L <= SMEM_BYTES:
        base += 1_536 * L
    return base + 4 * B > SMEM_BYTES


def gibbs_block_update_plain(Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e):
    """Plain PyTorch `block_update` (vampomi_tpu/gibbs/sampler.py:128-175):
    the L-way conditional of each marker in f64 Python floats, the f32
    vector c updated by PyTorch on the block's device."""
    B, L = xb0.shape[0], pi.shape[0]
    sg, se = float(sigma_g), float(sigma_e)
    psi = [cv * sg for cv in cvars.tolist()]          # psi[0] = 0
    log_pi = [math.log(max(p, 1e-300)) for p in pi.tolist()]
    safe_psi = [p if p > 0.0 else 1.0 for p in psi]
    diag = Gb.diagonal().tolist()
    uu, zz, live = u.tolist(), z.tolist(), mmask_b.tolist()
    x = xb0.tolist()
    c = r0.to(torch.float32).clone()
    comp = [0] * B
    for j in range(B):
        sjj = diag[j]
        rj = float(c[j]) + sjj * x[j]
        v = [1.0 / (sjj / se + 1.0 / sp) for sp in safe_psi]
        m = [vl * rj / se for vl in v]
        if live[j] > 0.0:
            logl = [log_pi[l] + 0.5 * (math.log(v[l]) - math.log(safe_psi[l]))
                    + 0.5 * m[l] * m[l] / v[l] if psi[l] > 0.0 else log_pi[l]
                    for l in range(L)]
        else:
            logl = [-math.inf if p > 0.0 else 0.0 for p in psi]
        mx = max(logl)
        cum = list(itertools.accumulate(math.exp(lw - mx) for lw in logl))
        k = sum(cv < uu[j] * cum[-1] for cv in cum)
        kk = min(k, L - 1)                            # JAX clamps the index
        xnew = (m[kk] + math.sqrt(v[kk]) * zz[j] if psi[kk] > 0.0 else 0.0) * live[j]
        d = float(np.float32(xnew - x[j]))            # f32, as c
        c = c - Gb[j] * d                             # product, then difference
        x[j] = xnew
        comp[j] = k
    return (torch.tensor(x, dtype=torch.float64).to(device=xb0.device, dtype=xb0.dtype),
            torch.tensor(comp, dtype=torch.int32, device=xb0.device))


def _check(Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e) -> None:
    what = "gibbs_block_update"
    dev = Gb.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    named = dict(Gb=Gb, r0=r0, xb0=xb0, mmask_b=mmask_b, u=u, z=z, pi=pi, cvars=cvars,
                 sigma_g=sigma_g, sigma_e=sigma_e)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"{what}: Gb on {dev} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if xb0.dim() != 1 or xb0.shape[0] < 1:
        raise ValueError(f"{what}: need a non-empty (B,) xb0, got {tuple(xb0.shape)}")
    B = xb0.shape[0]
    if tuple(Gb.shape) != (B, B):
        raise ValueError(f"{what}: Gb must be ({B}, {B}), got {tuple(Gb.shape)}")
    for name in ("r0", "mmask_b", "u", "z"):
        if tuple(named[name].shape) != (B,):
            raise ValueError(f"{what}: {name} must be ({B},), got {tuple(named[name].shape)}")
    if pi.dim() != 1 or pi.shape[0] < 1 or cvars.shape != pi.shape:
        raise ValueError(f"{what}: need pi and cvars of one shape (L,), got "
                         f"{tuple(pi.shape)} and {tuple(cvars.shape)}")
    for name in ("sigma_g", "sigma_e"):
        if named[name].dim() != 0:
            raise ValueError(f"{what}: {name} must be a 0-d tensor")
    for name in ("Gb", "r0"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {named[name].dtype}")
    if xb0.dtype not in WORK_DTYPES:
        raise TypeError(f"{what}: xb0 must be float32 or float64, got {xb0.dtype}")
    for name in ("mmask_b", "u", "z"):
        if named[name].dtype != xb0.dtype:
            raise TypeError(f"{what}: {name} must be {xb0.dtype} like xb0, got "
                            f"{named[name].dtype}")
    for name in ("pi", "cvars", "sigma_g", "sigma_e"):
        if named[name].dtype != torch.float64:
            raise TypeError(f"{what}: {name} must be float64, got {named[name].dtype}")


def gibbs_block_update(Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e):
    """(xb, comp_b) of one block's sequential draws.  On a CUDA tensor this
    launches the kernel on the current stream (and raises if it cannot); on
    a CPU tensor it runs `gibbs_block_update_plain`."""
    _check(Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e)
    if Gb.device.type == "cpu":
        return gibbs_block_update_plain(Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e)
    B, L = xb0.shape[0], pi.shape[0]
    xb = torch.empty_like(xb0)
    comp = torch.empty(B, dtype=torch.int32, device=Gb.device)
    scratch = (torch.empty(B, dtype=torch.float32, device=Gb.device)
               if needs_scratch(B, L) else None)
    lib = "gibbs_block_f64_launch" if xb0.dtype == torch.float64 else "gibbs_block_f32_launch"
    fn = _build.function("gibbs_block", lib, [ctypes.c_void_p] * 10
                         + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 4)
    with torch.cuda.device(Gb.device):
        err = fn(Gb.data_ptr(), r0.data_ptr(), xb0.data_ptr(), mmask_b.data_ptr(),
                 u.data_ptr(), z.data_ptr(), pi.data_ptr(), cvars.data_ptr(),
                 sigma_g.data_ptr(), sigma_e.data_ptr(), B, L, xb.data_ptr(), comp.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"gibbs_block_update at B={B}, L={L}")
    gibbs_block_update.launches += 1
    return xb, comp


# kernel launches since the last reset (plain runs are not counted)
gibbs_block_update.launches = 0
