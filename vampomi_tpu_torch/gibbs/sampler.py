"""The spike-and-slab Gibbs sampler (port of vampomi_tpu/gibbs/sampler.py).

Model (BayesR-type, the gVAMP prior family):

    y = mu + A x + e,   e ~ N(0, sigma_e I)
    x_j ~ pi_0 delta_0 + sum_k pi_k N(0, c_k sigma_g)       (internal scale)
    pi ~ Dirichlet(1),  sigma_g, sigma_e ~ scaled-inv-chi2

with A the standardized operator (ops/operator.py) and x internal-scale
(= beta * sqrt(N)), the engine's conventions.  Markers are walked in blocks
of B, as in the JAX package:

  1. r_b = A_b y_resid               `atx_block` on the block's rows of X
  2. the B sequential draws, correcting the local correlations through the
     precomputed block Gram G_b = A_b A_b^T (`gibbs_block_update`, a CUDA
     kernel on the card: one launch a block)
  3. y_resid -= A_b dx_b             `ax_block` on the block's rows of X

so a sweep reads X twice and stays an exact systematic-scan Gibbs chain.

What differs from the JAX package:

  * Draws come from a draw source (`TorchDraws`: one CPU torch.Generator
    seeded by the caller, so one seed gives the same chain on the CPU and on
    a card).  A sweep takes its (u, z) for all blocks in one draw and one
    copy; the hyperparameters' gamma and Dirichlet draws are made on the
    host from the sweep's single fetch of its statistics (counts, sums of
    squares, mu, the fitted variance), and their results go back to the
    device without a wait.  There is no host sync inside the block loop.
  * `gibbs_sweep` returns the new state and a `SweepStats` of host values
    (the CSV row's numbers), which the JAX runner fetched separately.
  * No padding: the block must divide Mt (the runner halves it until it
    does, as the JAX runner does with its padded M).

Precision as in JAX: the block Grams and the local correlations c are f32
for every design dtype (an f64 design matches the JAX package only to f32
inside a block); int8 and packed Grams are exact integer products folded
with the affine corrections in f32, in JAX's order.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.gibbs_block import gibbs_block_update
from ..ops.operator import PACKED4_DTYPE, QUANTIZED, DesignMatrix, atx_block, ax_block
from ..ops.packed4 import unpack_rows

F64 = torch.float64
# transient budget of a float design's Gram chunk (its standardized rows)
_CHUNK_BYTES = 256 << 20


class GibbsState(NamedTuple):
    x: torch.Tensor        # (M,) internal-scale effects, work dtype
    comp: torch.Tensor     # (M,) int32 component assignment, 0 = spike
    y_resid: torch.Tensor  # (N,) y - mu - A x, work dtype
    mu: torch.Tensor       # ()   intercept, f64
    sigma_g: torch.Tensor  # ()   slab scale (internal units), f64
    sigma_e: torch.Tensor  # ()   residual variance, f64
    pi: torch.Tensor       # (L,) mixture weights, f64


class SweepStats(NamedTuple):
    """A sweep's numbers on the host, from its one fetch."""
    mu: float
    sigma_g: float          # internal units
    sigma_e: float
    pi: np.ndarray
    m_incl: int             # markers in a slab (masked)
    vg: float               # ||A x||^2 / N
    h2: float               # vg / (vg + sigma_e)
    # host seconds until the block loop was enqueued (no synchronise): near
    # the sweep's wall, the host and not the card sets the pace
    enqueue_s: float


class TorchDraws:
    """The port's draw source: one CPU torch.Generator from `seed`.

    block_draws: a sweep's uniforms u and normals z, (nb, B) each in the
    work dtype, drawn in one tensor and copied once; normal: the intercept's
    standard normal; gamma: a standard gamma of a given shape; dirichlet: a
    Dirichlet draw of given concentrations.  The JAX package draws the same
    quantities from its key schedule (vampomi_tpu/gibbs/sampler.py:201-257);
    the two generators give other numbers from one seed."""

    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cpu")
        self.gen.manual_seed(int(seed))

    def block_draws(self, nb: int, block: int, dtype: torch.dtype, device):
        uz = torch.empty((2, nb, block), dtype=dtype)
        uz[0].uniform_(generator=self.gen)
        uz[1].normal_(generator=self.gen)
        uz = uz.to(device, non_blocking=True)
        return uz[0], uz[1]

    def normal(self) -> float:
        return float(torch.randn((), dtype=F64, generator=self.gen))

    def gamma(self, shape: float) -> float:
        return float(torch._standard_gamma(torch.tensor([shape], dtype=F64), generator=self.gen)[0])

    def dirichlet(self, alpha: np.ndarray) -> np.ndarray:
        return torch._sample_dirichlet(torch.as_tensor(alpha, dtype=F64),
                                       generator=self.gen).numpy()


def _block_dm(dm: DesignMatrix, b: int, block: int) -> DesignMatrix:
    """The design restricted to marker block b: row views of X and the
    vectors (contiguous, no copy), so the block passes reuse ops.operator's
    products as they are (ax_block / atx_block: a block is no pass over X,
    so they count none and open no span)."""
    sl = slice(b * block, (b + 1) * block)
    return dm._replace(X=dm.X[sl], mave=dm.mave[sl], msig=dm.msig[sl], mmask=dm.mmask[sl])


def _codes_product(Xq: torch.Tensor) -> torch.Tensor:
    """Xq Xq^T of (B, N) int8 codes, exact, as f32 (the int32 → f32 cast of
    the JAX package).  On the card torch._int_mm (int8 x int8 → int32), whose
    shapes must be multiples of 8 with more than 16 rows: the codes are
    padded with zero rows and columns, which adds nothing.  On the CPU an
    f64 product, exact since |sum| < 2^31 < 2^53."""
    if Xq.device.type != "cuda":
        q = Xq.to(F64)
        return (q @ q.T).to(torch.float32)
    b, n = Xq.shape
    bp, np_ = max(24, -(-b // 8) * 8), -(-n // 8) * 8
    if (bp, np_) != (b, n):
        padded = torch.zeros((bp, np_), dtype=torch.int8, device=Xq.device)
        padded[:b, :n] = Xq
        Xq = padded
    return torch._int_mm(Xq, Xq.T)[:b, :b].to(torch.float32)


def _quantized_gram(d: DesignMatrix, n: torch.Tensor) -> torch.Tensor:
    """A_b A_b^T of a quantized block, vampomi_tpu/gibbs/sampler.py:95-113:
    D (Xq Xq^T - q1 m^T - m q1^T + N m m^T) D / N in f32, in that order.
    n is N as an f32 tensor on the block's device: divided by a host
    scalar, the card multiplies by its reciprocal instead, which rounds
    differently from the CPU's division."""
    Xq = unpack_rows(d.X, torch.int8) if d.X.dtype == PACKED4_DTYPE else d.X
    S = _codes_product(Xq)
    q1 = Xq.sum(dim=1, dtype=torch.int32).to(torch.float32)
    m = d.mave
    S = S - torch.outer(q1, m) - torch.outer(m, q1) + n * torch.outer(m, m)
    return d.msig[:, None] * S * d.msig[None, :] / n


def build_block_grams(dm: DesignMatrix, block: int = 256) -> torch.Tensor:
    """(nb, B, B) f32 per-block Grams G_b = A_b A_b^T.

    int8 and packed X: exact code products (see _codes_product) plus the
    rank-1 affine corrections in f32; packed blocks are unpacked to int8
    codes first.  Float X: the standardized rows of a chunk of blocks
    multiplied in the work dtype (full f32, TF32 off; bf16 X upcast to f32,
    JAX's "other dtypes: direct f32"), then cast to f32."""
    nb = dm.m_pad // block
    n = int(dm.n)
    # int8 codes contract exactly in int32 only while |sum| <= 127^2 N stays
    # below 2^31 (vampomi_tpu/gibbs/sampler.py:83-91)
    if dm.X.dtype == torch.int8 and n * 127 * 127 >= 2**31:
        raise ValueError(
            f"int8 block-Gram would overflow its exact int32 accumulation at "
            f"N={n} (limit {2**31 // (127 * 127)}); use a float "
            f"design dtype for the Gibbs stage at this sample count")
    grams = torch.empty((nb, block, block), dtype=torch.float32, device=dm.device)
    if dm.X.dtype in QUANTIZED:
        n_dev = torch.tensor(float(n), dtype=torch.float32, device=dm.device)
        for b in range(nb):
            grams[b] = _quantized_gram(_block_dm(dm, b, block), n_dev)
        return grams
    wd = dm.wd
    per = max(1, _CHUNK_BYTES // (block * n * dm.X.element_size()))
    for b0 in range(0, nb, per):
        b1 = min(nb, b0 + per)
        rows = slice(b0 * block, b1 * block)
        A = ((dm.X[rows].to(wd) - dm.mave[rows, None]) * dm.msig[rows, None]
             * dm.inv_sqrt_n).reshape(b1 - b0, block, n)
        grams[b0:b1] = torch.bmm(A, A.transpose(1, 2)).to(torch.float32)
    return grams


def block_update(Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e):
    """Sequential spike-and-slab Gibbs over one block's markers, exact
    given the block Gram (vampomi_tpu/gibbs/sampler.py:128-175): the kernel
    `gibbs_block_update` on the card, its plain version on the CPU.
    Returns (xb_new, comp_b_new)."""
    return gibbs_block_update(Gb, r0.to(torch.float32), xb0, mmask_b, u, z, pi, cvars,
                              sigma_g, sigma_e)


def _fitted_var(state: GibbsState, y: torch.Tensor) -> torch.Tensor:
    """||A x||^2 / N = ||y - mu - y_resid||^2 / N, f64."""
    wd = state.y_resid.dtype
    g = y.to(wd) - state.mu.to(wd) - state.y_resid
    return torch.dot(g, g).to(F64) / g.shape[0]


def gibbs_sweep(
    dm: DesignMatrix,
    grams: torch.Tensor,
    state: GibbsState,
    cvars: torch.Tensor,       # (L,) f64 variance-ladder RATIOS, cvars[0] = 0
    draws,
    y: torch.Tensor,           # (N,) the phenotype on the device
    block: int = 256,
    nu0: float = 4.0,
    s0_g: float = 1.0,
    s0_e: float = 1.0,
) -> tuple[GibbsState, SweepStats]:
    """One full systematic-scan sweep + hyperparameter draws
    (vampomi_tpu/gibbs/sampler.py:178-262), and the new state's CSV numbers
    (with vg and h2 as vampomi_tpu sweep_stats gives them).  `state` is not
    modified."""
    t0 = time.perf_counter()
    nb = dm.m_pad // block
    n = state.y_resid.shape[0]
    wd = dm.wd
    dev = dm.device
    U, Z = draws.block_draws(nb, block, wd, dev)
    x, comp, y_resid = state.x.clone(), state.comp.clone(), state.y_resid.clone()
    for b in range(nb):
        d = _block_dm(dm, b, block)
        sl = slice(b * block, (b + 1) * block)
        r0 = atx_block(d, y_resid)                     # pass 1 over X_b
        xb0 = x[sl]
        xb, compb = block_update(grams[b], r0, xb0, d.mmask, U[b], Z[b], state.pi, cvars,
                                 state.sigma_g, state.sigma_e)
        y_resid -= ax_block(d, xb - xb0)               # pass 2 over X_b
        x[sl] = xb
        comp[sl] = compb
    enqueue_s = time.perf_counter() - t0

    # intercept: mu | rest ~ N(mean(y_resid + mu), sigma_e / N); vector math
    # in the work dtype, scalars f64 from the reduction on
    mu = (y_resid.mean().to(F64) + state.mu
          + torch.sqrt(state.sigma_e / n) * draws.normal())
    y_resid += (state.mu - mu).to(wd)

    # counts and sufficient statistics (masked M-length reductions)
    l_comp = cvars.shape[0]
    ci = comp.long()
    counts = torch.zeros(l_comp, dtype=F64, device=dev).index_add_(0, ci, dm.mmask.to(F64))
    safe_c = torch.where(cvars > 0.0, cvars, torch.ones_like(cvars)).to(wd)
    ssq_g = torch.where(comp > 0, x * x / safe_c[ci], torch.zeros_like(x)).sum().to(F64)
    rss = torch.dot(y_resid, y_resid).to(F64)
    new = GibbsState(x=x, comp=comp, y_resid=y_resid, mu=mu, sigma_g=state.sigma_g,
                     sigma_e=state.sigma_e, pi=state.pi)
    vg = _fitted_var(new, y)

    # the sweep's one fetch
    host = torch.cat([counts, torch.stack([ssq_g, rss, mu, vg])]).cpu().numpy()
    counts_h, (ssq_h, rss_h, mu_h, vg_h) = host[:l_comp], host[l_comp:]
    m_incl = float(counts_h[1:].sum())

    # sigma_g ~ scaled-inv-chi2(nu0 + m_incl, ...), sigma_e likewise, pi ~ Dir
    chi_g = 2.0 * draws.gamma((nu0 + m_incl) / 2.0)
    sigma_g = (ssq_h + nu0 * s0_g) / max(chi_g, 1e-12)
    chi_e = 2.0 * draws.gamma((nu0 + n) / 2.0)
    sigma_e = (rss_h + nu0 * s0_e) / max(chi_e, 1e-12)
    pi = np.asarray(draws.dirichlet(1.0 + counts_h), dtype=np.float64)
    hyper = torch.as_tensor(np.concatenate([[sigma_g, sigma_e], pi])).to(dev, non_blocking=True)
    new = new._replace(sigma_g=hyper[0], sigma_e=hyper[1], pi=hyper[2:])
    stats = SweepStats(mu=float(mu_h), sigma_g=float(sigma_g), sigma_e=float(sigma_e), pi=pi,
                       m_incl=int(round(m_incl)), vg=float(vg_h),
                       h2=float(vg_h / (vg_h + sigma_e)), enqueue_s=enqueue_s)
    return new, stats


def sweep_stats(dm: DesignMatrix, state: GibbsState, y: torch.Tensor):
    """(h2, m_incl, vg) on the device, vampomi_tpu/gibbs/sampler.py:265-274:
    vg = ||A x||^2 / N (A's columns are exactly mean-zero, so this is the
    variance of the fitted genetic term)."""
    vg = _fitted_var(state, y)
    h2 = vg / (vg + state.sigma_e)
    m_incl = ((state.comp > 0) & (dm.mmask > 0.0)).sum()
    return h2, m_incl, vg


def init_state(dm: DesignMatrix, y: np.ndarray, l_comp: int,
               h2_init: float = 0.5) -> GibbsState:
    """Cold start: x = 0, sigma_e = (1-h2) Var(y), sigma_g from h2."""
    dev = dm.device
    y64 = np.asarray(y, dtype=np.float64)
    vy = float(np.var(y64))
    mu0 = float(np.mean(y64))
    pi0 = np.full(l_comp, 0.01 / max(l_comp - 1, 1))
    pi0[0] = 0.99

    def f64(v):
        return torch.as_tensor(v, dtype=F64).to(dev)

    return GibbsState(
        x=torch.zeros(dm.m_pad, dtype=dm.wd, device=dev),
        comp=torch.zeros(dm.m_pad, dtype=torch.int32, device=dev),
        y_resid=torch.as_tensor(y64 - mu0).to(device=dev, dtype=dm.wd),
        mu=f64(mu0),
        sigma_g=f64(max(h2_init * vy, 1e-6)),
        sigma_e=f64(max((1.0 - h2_init) * vy, 1e-6)),
        pi=f64(pi0),
    )


def decade_cvars(l_comp: int) -> np.ndarray:
    """Variance-ladder ratios [0, 1e-{L-2}, ..., 1e-1, 1]: component k's
    prior variance is cvars[k] * sigma_g, mirroring conf_gibbs_init's decade
    ladder (scripts/conf_gibbs_init.py get_vars)."""
    out = np.zeros(l_comp)
    out[1:] = 10.0 ** -(np.arange(l_comp - 1, 0, -1) - 1.0)
    return out
