"""The spectral solver's dense step on the card: the blocked factor and inverse
of ops/spectral.py by diagonal blocks x leaf size, at the sizes where the
`auto` solver runs spectral.

    python -m vampomi_tpu_torch.tools.dense_step_probe [--device cuda|cpu] [--small] [--seed S]

For each N of SIZES, S = gam2 I + tau K with K = A A^T / (2N), A an
(N, 2N) standard normal matrix made on the device from the seed, at the
shift of a north-star spectral iteration.  First the check: W of
`shift_inverse` at every (nb, leaf size) of GRID against W of potrf and a
triangular solve against the identity (max |W - W_ref| over max |W_ref|),
and T against the trace of torch.cholesky_inverse.  Then, on
a card, the times with CUDA events (a sample is the mean of KERNEL_CALLS
back-to-back calls, each with its host sync): every pair of GRID in two
turns (forward, then backward), potrf + the triangular solve, and the
least work, potrf + trtri = 2N^3/3 FLOPs at the f32 rate; at
default_nb(N) and _FACTOR_BASE, the host's enqueue of one call and the
card's own time (own_time).  Last, at the largest N,
torch.profiler's kernel times of one call at the default pair, summed by
kind (GEMM, potrf, trsm, the rest).

The last line of standard output is the JSON summary.  `--small` runs
N = 300 and 700; with `--device cpu` it runs the checks only.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from ..ops import spectral
from . import F32_FLOPS, KERNEL_CALLS, card_info, card_ms, tool_args

SIZES = (2048, 4096, 8192, 10240, 16384)
SMALL_SIZES = (300, 700)
GRID = [(nb, base) for base in (256, 512) for nb in (4, 8, 16, 32)]
SHIFT = (4.4934, 24.6408)  # (tau, gam2) of the int8 north star's last auto iteration
CHECK_TOL = 1e-4
KINDS = (("gemm", "gemm"), ("potrf", "potrf"), ("potrf", "getrf"), ("trsm", "trsm"))


def log(msg: str) -> None:
    print(f"[dense] {msg}", flush=True)


def shifted_gram(n: int, seed: int, device) -> spectral.GramFactor:
    g = torch.Generator(device=device)
    g.manual_seed(seed + n)
    A = torch.randn((n, 2 * n), device=device, generator=g) / (2 * n) ** 0.5
    K = A @ A.T
    return spectral.GramFactor(K=0.5 * (K + K.T))


def blocked(fac, shift, nb: int, base: int):
    """shift_inverse over nb diagonal blocks with leaves of at most `base` rows."""
    saved, spectral._FACTOR_BASE = spectral._FACTOR_BASE, base
    try:
        return spectral.shift_inverse(fac, *shift, nb=nb)
    finally:
        spectral._FACTOR_BASE = saved


def potrf_trsm(S: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    return torch.linalg.solve_triangular(torch.linalg.cholesky_ex(S)[0], eye, upper=False)


def check(fac, shift) -> dict:
    """Every pair of GRID against potrf + trsm: max |W - W_ref| / max |W_ref|
    and |T / tr S^{-1} - 1|."""
    S = spectral._shifted(fac, *shift)
    W_ref = potrf_trsm(S)
    trace = float(torch.cholesky_inverse(torch.linalg.cholesky_ex(S)[0]).diagonal().double().sum())
    out = {}
    for nb, base in GRID:
        w = blocked(fac, shift, nb, base)
        out[f"nb {nb} base {base}"] = {
            "W": float((w.W - W_ref).abs().max() / W_ref.abs().max()),
            "T": abs(float(w.T) / trace - 1.0)}
    return out


def own_time(fac, shift, nb: int) -> tuple[float, float]:
    """(host enqueue ms, the card's ms) of one blocked body (no host sync):
    the enqueue from an idle card, then the card's own time, with the card
    asleep while the host enqueues the body.  A full launch queue may then
    hold the host back until the card wakes; the host still runs ahead of
    the card from there, so the events time the card's work."""
    def body():
        spectral._shift_inverse_body(spectral._shifted(fac, *shift), nb, [])

    body()
    torch.cuda.synchronize()
    t = time.perf_counter()
    body()
    enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e8))  # ~0.2 s of the card's clock
    e0.record()
    body()
    e1.record()
    torch.cuda.synchronize()
    return 1e3 * enqueue, e0.elapsed_time(e1)


def timings(fac, shift) -> dict:
    n = fac.n
    S = spectral._shifted(fac, *shift)
    res = {f"nb {nb} base {base}": [] for nb, base in GRID}
    for order in (GRID, GRID[::-1]):
        for nb, base in order:
            res[f"nb {nb} base {base}"].append(round(card_ms(
                lambda: blocked(fac, shift, nb, base), reps=3, warmup=1, calls=KERNEL_CALLS), 3))
    enqueue, own = own_time(fac, shift, spectral.default_nb(n))
    return {"blocked_ms": res,
            "potrf_trsm_ms": round(card_ms(lambda: potrf_trsm(S), reps=3, warmup=1,
                                           calls=KERNEL_CALLS), 3),
            "least_ms": round(1e3 * (2 * n**3 / 3) / F32_FLOPS, 3),
            "default": f"nb {spectral.default_nb(n)} base {spectral._FACTOR_BASE}",
            "enqueue_ms": round(enqueue, 3), "own_ms": round(own, 3)}


def kernel_profile(fac, shift) -> dict:
    """The card's ms of one default call by kind of kernel, and its kernels'
    count, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn = lambda: spectral.shift_inverse(fac, *shift)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {"gemm": 0.0, "potrf": 0.0, "trsm": 0.0, "rest": 0.0}
    count = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t <= 0 or e.key.startswith("aten::"):
            continue
        kind = next((k for k, part in KINDS if part in e.key.lower()), "rest")
        ms[kind] += t / 1e3
        count += e.count
    return {"n": fac.n, "kernel_ms": {k: round(v, 3) for k, v in ms.items()},
            "kernels": count}


def probe(sizes, seed: int, device) -> dict:
    results, checks, prof = {}, {}, "not measured"
    for n in sizes:
        fac = shifted_gram(n, seed, device)
        checks[str(n)] = check(fac, SHIFT)
        log(f"N={n} checks (max |W - W_ref| / max |W_ref|, |T / tr S^-1 - 1|): {checks[str(n)]}")
        if device.type == "cuda":
            results[str(n)] = timings(fac, SHIFT)
            log(f"N={n}: {results[str(n)]}")
            if n == sizes[-1]:
                prof = kernel_profile(fac, SHIFT)
                log(f"N={n} kernels of one call: {prof}")
        else:
            results[str(n)] = "not measured"
        del fac
    ok = all(v < CHECK_TOL for c in checks.values() for d in c.values() for v in d.values())
    return {"tool": "dense_step_probe", "device": card_info(device), "shift": SHIFT,
            "check_tol": CHECK_TOL, "checks_pass": ok, "checks": checks, "results": results,
            "profile": prof}


def main(argv=None) -> int:
    args = tool_args(__doc__.splitlines()[0], argv)
    summary = probe(SMALL_SIZES if args.small else SIZES, args.seed, args.device)
    print(json.dumps(summary))
    return 0 if summary["checks_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
