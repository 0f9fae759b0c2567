"""Plain PyTorch gVAMP for a linear model: the benchmark's reference.

It follows the reference algorithm (VAMPomi, src/vamp.cpp:110-438) in the
update order of the numpy oracle the port is tested against, with an exact
LMMSE step: the Gram K = A A^T of the standardized design is built here,
diagonalized once, and every solve and trace of an iteration is taken in
K's eigenbasis (Woodbury).  It imports nothing but torch, and takes from
the program nothing: the design's statistics, the Gram and the state are
worked out again from the codes and the phenotype the benchmark made.

Two precisions:

  * "f64": every product over the design and every vector in float64; the
    reference the program is judged against.
  * "tf32": the control, the same arithmetic one step below the program's
    float32 (with TF32 off): float32 vectors and scalars, and every product
    over the design taken as a TF32 tensor-core product does it, both
    operands rounded to TF32's 10-bit mantissa and the sums kept in float32.
    The rounding is done here, bit by bit, so the control does not depend on
    which cuBLAS kernel a shape gets.

The design A (N samples x M markers) is never formed: the codes are read in
blocks of rows, and the standardization (mean and 1/sd of each marker's
codes, sd with N - 1) is folded into the vectors, as

    A x   = ( C^T (s * x) - (mu . (s * x)) 1 ) / sqrt(N)
    A^T y = s * ( C y - mu (1^T y) ) / sqrt(N)

with C the (M, N) codes.  Packed int4 codes are (M, N/2) bytes, the low
nibble sample j and the high nibble sample j + N/2, each biased by 8.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

GAMMA_MIN, GAMMA_MAX = 1e-11, 1e11  # src/vamp.hpp:33-34
# the run's settings the benchmark's configurations leave at the
# reference's defaults (src/options.hpp:79-104)
GAM1_START, RHO, LEARN_PRIOR_DELAY = 1e-6, 0.5, 1
BLOCK_BYTES = 1 << 30               # float64 bytes of one block of codes


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits;
    ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def unpack_codes(packed: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(m, N) codes in [-8, 7] of (m, N/2) packed bytes."""
    p = packed.to(torch.int16)
    return torch.cat([(p & 15) - 8, (p >> 4) - 8], dim=1).to(dtype)


class Design:
    """The standardized design over (M, N) int8 codes or (M, N/2) packed
    int4 bytes, in the precision `precision` ("f64" or "tf32")."""

    def __init__(self, codes: torch.Tensor, packed: bool, precision: str = "f64"):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.codes = codes
        self.packed = packed
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.m = codes.shape[0]
        self.n = codes.shape[1] * (2 if packed else 1)
        self.rows = max(1, BLOCK_BYTES // (8 * self.n))
        mean = torch.empty(self.m, dtype=torch.float64, device=codes.device)
        sumsq = torch.empty_like(mean)
        for lo, hi, c in self._blocks(torch.float64):
            mean[lo:hi] = c.mean(dim=1)
            sumsq[lo:hi] = ((c - mean[lo:hi, None]) ** 2).sum(dim=1)
        sd = torch.sqrt(sumsq / (self.n - 1))
        self.mean = mean.to(self.dtype)
        self.inv_sd = torch.where(sumsq > 0, 1.0 / torch.where(sd > 0, sd, 1.0), 1.0).to(self.dtype)
        self.inv_sqrt_n = 1.0 / math.sqrt(self.n)

    def _blocks(self, dtype: torch.dtype):
        for lo in range(0, self.m, self.rows):
            hi = min(self.m, lo + self.rows)
            c = self.codes[lo:hi]
            yield lo, hi, unpack_codes(c, dtype) if self.packed else c.to(dtype)

    def _op(self, v: torch.Tensor) -> torch.Tensor:
        """The vector side of a product over the codes (TF32 in the control)."""
        return round_tf32(v) if self.tf32 else v

    def ax(self, X: torch.Tensor) -> torch.Tensor:
        """A X for X (M, K) -> (N, K)."""
        W = self._op(self.inv_sd[:, None] * X.to(self.dtype))
        out = torch.zeros((self.n, X.shape[1]), dtype=self.dtype, device=X.device)
        for lo, hi, c in self._blocks(self.dtype):
            out += c.T @ W[lo:hi]
        return (out - (self.mean @ W)[None, :]) * self.inv_sqrt_n

    def atx(self, Y: torch.Tensor) -> torch.Tensor:
        """A^T Y for Y (N, K) -> (M, K)."""
        Yc = self._op(Y.to(self.dtype))
        out = torch.empty((self.m, Y.shape[1]), dtype=self.dtype, device=Y.device)
        for lo, hi, c in self._blocks(self.dtype):
            out[lo:hi] = c @ Yc
        return self.inv_sd[:, None] * (out - torch.outer(self.mean, Yc.sum(dim=0))) * self.inv_sqrt_n

    def gram(self) -> torch.Tensor:
        """K = A A^T (N, N): the standardized blocks, centred and scaled,
        multiplied in the design's precision."""
        K = torch.zeros((self.n, self.n), dtype=self.dtype, device=self.codes.device)
        for lo, hi, c in self._blocks(self.dtype):
            b = self._op((c - self.mean[lo:hi, None]) * (self.inv_sd[lo:hi, None] * self.inv_sqrt_n))
            K.addmm_(b.T, b)
        return K


class Eigen(NamedTuple):
    """K = U diag(lam) U^T."""
    U: torch.Tensor
    lam: torch.Tensor

    def shifted_solve(self, b: torch.Tensor, tau, gam2) -> torch.Tensor:
        """(gam2 I + tau K)^{-1} b for b (N,)."""
        return self.U @ ((self.U.T @ b) / (gam2 + tau * self.lam))


def eigen_of(K: torch.Tensor) -> Eigen:
    lam, U = torch.linalg.eigh(K)
    return Eigen(U=U, lam=lam)


class Prior(NamedTuple):
    """Spike (component 0, variance 0) and slab components; the variances
    on the internal scale (times N, src/vamp.cpp:87-88)."""
    probs: list
    vars: list


def _weights(r: torch.Tensor, gam1: float, prior: Prior):
    """sigma, the components' variances and each marker's posterior weights
    over the components: p_k / sqrt(v_k + sigma) exp(...), the largest
    variance factored out of every exponent (src/vamp.cpp:440-492)."""
    sigma = 1.0 / gam1
    v = torch.tensor(prior.vars, dtype=r.dtype, device=r.device)
    p = torch.tensor(prior.probs, dtype=r.dtype, device=r.device)
    eta = max(prior.vars)
    z = p / torch.sqrt(v + sigma) * torch.exp(
        -0.5 * (r * r)[:, None] * (eta - v) / (v + sigma) / (eta + sigma))
    return sigma, v, z / z.sum(dim=1, keepdim=True)


def denoise(r: torch.Tensor, gam1: float, prior: Prior) -> tuple[torch.Tensor, torch.Tensor]:
    """The posterior mean g1(r) and its derivative g1'(r) under the mixture
    prior at noise variance 1/gam1: g1 = r sum_k w_k v_k a_k and
    g1' = sum_k w_k v_k a_k + sigma r^2 Var_w[a], a_k = 1/(v_k + sigma)."""
    sigma, v, w = _weights(r, gam1, prior)
    a = 1.0 / (v + sigma)
    shrink = (w * (v * a)).sum(dim=1)
    mean_a = (w * a).sum(dim=1)
    var_a = (w * (a - mean_a[:, None]) ** 2).sum(dim=1)
    return r * shrink, shrink + sigma * (r * r) * var_a


def em_step(r1: torch.Tensor, gam1: float, prior: Prior, learn_vars: bool) -> Prior:
    """One EM update of the prior (src/vamp.cpp:531-643), then the merge of
    components whose variances lie within a factor merge_vars_thr (0.5),
    which erases the later one."""
    nv = 1.0 / gam1
    L = len(prior.probs)
    lam = 1.0 - prior.probs[0]
    vmax = max(prior.vars)
    vs = torch.tensor(prior.vars[1:], dtype=r1.dtype, device=r1.device)
    ps = torch.tensor(prior.probs[1:], dtype=r1.dtype, device=r1.device)
    half_r2 = (0.5 * r1 * r1)[:, None]
    num = ps * torch.exp(-half_r2 * (vmax - vs) / (vs + nv) / (vmax + nv)) \
        / torch.sqrt(vs + nv) / math.sqrt(2 * math.pi)
    s = num.sum(dim=1)
    beta = num / s[:, None]
    pin = 1.0 / (1.0 + (1.0 - lam) / math.sqrt(2 * math.pi * nv)
                 * torch.exp(-half_r2[:, 0] * vmax / nv / (nv + vmax)) / s)
    gmean = gam1 * r1[:, None] / (1.0 / vs + gam1)
    vpost = 1.0 / (1.0 / vs + gam1)
    lam_total = float(pin.sum())
    res = (beta * pin[:, None]).sum(dim=0).tolist()
    res_g = (beta * (gmean * gmean + vpost) * pin[:, None]).sum(dim=0).tolist()
    lam = lam_total / r1.shape[0]
    probs, vars_ = [1.0 - lam], [prior.vars[0]]
    for j in range(1, L):
        vars_.append(res_g[j - 1] / res[j - 1] if learn_vars else prior.vars[j])
        probs.append(lam * res[j - 1] / lam_total)
    j = 0
    while j < len(vars_):
        k = j + 1
        while k < len(vars_):
            denom = min(vars_[j], vars_[k]) if vars_[j] != 0 else 1e-7
            if denom != 0 and abs(vars_[j] - vars_[k]) / denom < 0.5:
                probs[j] += probs.pop(k)
                vars_.pop(k)
            else:
                k += 1
        j += 1
    return Prior(probs=probs, vars=vars_)


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    den = math.sqrt(float(a @ a) * float(b @ b))
    return float(a @ b) / den if den > 0 else 0.0


def _r2(z: torch.Tensor, y: torch.Tensor) -> float:
    yy = float(y @ y)
    return 1.0 - float((y - z) @ (y - z)) / (yy if yy != 0 else 1.0)


def metrics_row(z1, x1_hat, z2, x2_hat, y, ts) -> list:
    """The engine's six error measures of an iteration (src/vamp.cpp:760-852)."""
    return [_r2(z1, y), _corr(x1_hat, ts), _r2(z2, y), _corr(x2_hat, ts),
            _corr(z1, y) ** 2, _corr(z2, y) ** 2]


def _clamp(g: float) -> float:
    return min(max(g, GAMMA_MIN), GAMMA_MAX)


def probes(seed: int, m: int, iterations: int) -> list:
    """The engine's Hutchinson trace probes, +-1/sqrt(M) (its documented
    stream: a CPU torch.Generator seeded with the run's seed, one draw of M
    signs an iteration, under every solver)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return [(torch.randint(0, 2, (m,), generator=g) * 2 - 1).double() / math.sqrt(m)
            for _ in range(iterations)]


class Answer(NamedTuple):
    """What a fit returns: the metrics row of each iteration and the state
    after the last; x1 and r1 in file units (the internal scale over
    sqrt(N), as the engine's x1_hat_scaled and r1_scaled)."""
    rows: list
    x1: torch.Tensor
    r1: torch.Tensor
    gam1: float
    gamw: float


def tail_row(design: Design, x1: torch.Tensor, y: torch.Tensor, ts: torch.Tensor) -> list:
    """The measures of an iteration's metrics row that follow from its x1
    alone, worked out from x1 in file units: [R2 of z1 = A x1 against y,
    the correlation of x1 with the true signal, that of z1 with y squared]
    (the row's entries 0, 1 and 4)."""
    dt, dev = design.dtype, design.codes.device
    x1 = x1.to(device=dev, dtype=dt) * math.sqrt(design.n)
    y = y.to(device=dev, dtype=dt)
    z1 = design.ax(x1[:, None])[:, 0]
    return [_r2(z1, y), _corr(x1, ts.to(device=dev, dtype=dt)), _corr(z1, y) ** 2]


def run(design: Design, eig: Eigen, y: torch.Tensor, ts: torch.Tensor, prior: Prior, *,
        iterations: int, h2: float, probe_seed: int | None = None) -> Answer:
    """`iterations` gVAMP iterations from the cold start (x1 = r1 = 0) with
    an exact LMMSE step and EM from iteration LEARN_PRIOR_DELAY + 1; the
    metrics row of each and the state after the last.  With `probe_seed` the two traces of the LMMSE step
    are the engine's Hutchinson estimates on its probes (the CG solver's),
    each taken exactly; without, the exact traces (the exact solvers').  `y`
    (N,) and `ts` (M,) in file units."""
    dt, dev = design.dtype, design.codes.device
    m, n = design.m, design.n
    y = y.to(device=dev, dtype=dt)
    ts = ts.to(device=dev, dtype=dt)
    aty = design.atx(y[:, None])[:, 0]
    lam = eig.lam.to(dt)
    eig = Eigen(U=eig.U.to(dt), lam=lam)
    gam1, rho = GAM1_START, RHO
    bern = probes(probe_seed, m, iterations) if probe_seed is not None else None
    x1_hat = torch.zeros(m, dtype=dt, device=dev)
    r1 = torch.zeros_like(x1_hat)
    gamw = 1.0 / (1.0 - h2)
    prior = Prior(probs=list(prior.probs), vars=[v * n for v in prior.vars])
    rows = []
    for it in range(1, iterations + 1):
        if it > LEARN_PRIOR_DELAY:
            prior = em_step(r1, gam1, prior, learn_vars=True)
        x1_prev = x1_hat
        x1_new, dx = denoise(r1, gam1, prior)
        x1_hat = rho * x1_new + (1.0 - rho) * x1_prev if it > 1 else x1_new
        alpha1 = float(dx.sum()) / m
        eta1 = gam1 / alpha1
        gam2 = _clamp(eta1 - gam1)
        r2 = (eta1 * x1_hat - gam1 * r1) / gam2
        v = gamw * aty + gam2 * r2
        cols = [x1_hat, v] + ([bern[it - 1].to(device=dev, dtype=dt)] if bern else [])
        Z = design.ax(torch.stack(cols, dim=1))
        z1 = Z[:, 0]
        q = eig.shifted_solve(Z[:, 1], gamw, gam2)
        x2_hat = (v - gamw * design.atx(q[:, None])[:, 0]) / gam2
        if bern:
            b = cols[2]
            s = float(Z[:, 2] @ eig.shifted_solve(Z[:, 2], gamw, gam2))
            alpha2 = float(b @ b) - gamw * s
            tr_ata = m * s
        else:
            d = 1.0 / (gam2 + gamw * lam)
            alpha2 = gam2 * (float(d.sum()) + (m - n) / gam2) / m
            tr_ata = float((lam * d).sum())
        eta2 = gam2 / alpha2
        gam1_new = rho * _clamp(eta2 - gam2) + (1.0 - rho) * gam1
        r1 = (eta2 * x2_hat - gam2 * r2) / gam1_new
        resid = q - y
        gamw = n / (float(resid @ resid) + tr_ata)
        gam1 = gam1_new
        rows.append(metrics_row(z1, x1_hat, q, x2_hat, y, ts))
    root_n = math.sqrt(n)
    return Answer(rows=rows, x1=x1_hat / root_n, r1=r1 / root_n, gam1=gam1, gamw=gamw)
