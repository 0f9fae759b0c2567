"""The card's HBM read floor and the int8 design's two matvec directions
against it: the port of tools/matvec_floor_probe.py.

    python -m vampomi_tpu_torch.tools.matvec_floor_probe [--device cuda|cpu] [--small] [--seed S] [--out PATH]

At the north-star shape, M = 1,048,576 x N = 10,240 int8 (10.0 GiB of X,
tools/matvec_floor_probe.py:59-60), it measures
  1. the pure read floor: `stream_sum` and `stream_rowsum` (ops/stream.py),
     which read every byte once and do the least compute that cannot be
     elided — the ceiling no matvec over the same bytes can beat;
  2. the reduce direction X y: `atx_int8` (the CUDA-core kernel the operator
     runs, the JAX tool's "atx_vpu"), `atx_mxu` (tensor cores, y in bf16)
     and the plain `atx_int8_plain` (the counterpart of its einsum row);
  3. the broadcast direction X^T w: `ax_batch_int8` at K = 1, `ax_mxu` and
     the plain `ax_batch_int8_plain`;
  4. the fused `normal_eq_mult` (A^T A w, two passes) on a unit design
     (mave 0, msig 1, as tools/matvec_floor_probe.py:297-304 builds it),
     and the two-pass rate the best single passes imply,
     2 / (1/best_ax + 1/best_atx).
Every kernel is first held to its plain version and the exact f64 product.
Rates are GB/s of X (10^9 bytes).  The TPU tool's tile sweeps (tm) do not
carry over: the CUDA kernels pick their own launch shapes.

The last line of standard output is the JSON summary; `--out` also writes
it to a file.  `--small` runs M = 4,096 x N = 512; with `--device cpu` that
is the JAX tool's `--small`: the checks only, through the plain versions.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.atx_int8 import atx_int8, atx_int8_plain
from ..ops.broadcast import ax_batch_int8, ax_batch_int8_plain
from ..ops.mxu import atx_mxu, atx_mxu_plain, ax_mxu, ax_mxu_plain, bf16_round
from ..ops.operator import DesignMatrix, normal_eq_mult
from ..ops.stream import stream_rowsum, stream_rowsum_plain, stream_sum, stream_sum_plain
from . import (
    KERNEL_CALLS, KERNEL_TOL, card_info, card_ms, exact_and_scale, in_turns, random_codes, rel_err,
    tool_args,
)

FULL = (1 << 20, 10_240)
SMALL = (4096, 512)


def log(msg: str) -> None:
    print(f"[floor] {msg}", flush=True)


def unit_design(X: torch.Tensor) -> DesignMatrix:
    """The design over X with mave 0 and msig 1: A = X / sqrt(N)."""
    m, n = X.shape
    one = torch.ones(m, dtype=torch.float32, device=X.device)
    return DesignMatrix(X=X, mave=torch.zeros_like(one), msig=one, mmask=one,
                        inv_sqrt_n=torch.tensor(1.0 / np.sqrt(n), dtype=torch.float32,
                                                device=X.device),
                        n=float(n), mt=float(m))


def probe(X: torch.Tensor, seed: int = 7) -> dict:
    """Check, then (on a card) time, every row on the int8 X; returns the
    summary."""
    dev = X.device
    m, n = X.shape
    gb = X.numel() / 1e9
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    y = torch.randn(n, device=dev, generator=g)
    w = torch.randn((m, 1), device=dev, generator=g)

    # 1. checks: bitwise for the integer sums, KERNEL_TOL of sum |x||v| for
    # the matvecs, against the plain version and the exact f64 product of
    # the vector the kernel multiplies (bf16-rounded for the tensor cores)
    checks = {}
    for name, kern, plain in (("stream_sum", stream_sum, stream_sum_plain),
                              ("stream_rowsum", stream_rowsum, stream_rowsum_plain)):
        got = kern(X)
        ok = torch.equal(got, plain(X)) and torch.equal(got, kern(X))
        checks[name] = {"bitwise_equal_plain_and_repeatable": ok}
    vec = {"atx_int8": (atx_int8, atx_int8_plain, y, False),
           "atx_mxu": (atx_mxu, atx_mxu_plain, bf16_round(y), False),
           "ax_batch_int8": (ax_batch_int8, ax_batch_int8_plain, w, True),
           "ax_mxu": (ax_mxu, ax_mxu_plain, bf16_round(w), True)}
    for name, (kern, plain, v_exact, broadcast) in vec.items():
        v = w if broadcast else y
        got, want = kern(X, v), plain(X, v)
        ex, sc = exact_and_scale(X, v_exact if broadcast else v_exact[:, None], broadcast)
        if not broadcast:
            got, want = got[:, None], want[:, None]
        checks[name] = {"rel_err_vs_plain": rel_err(got, want, sc),
                        "rel_err_vs_f64": rel_err(got, ex, sc),
                        "repeatable": torch.equal(got, kern(X, v).reshape(got.shape))}
    for name, c in checks.items():
        log(f"check {name}: {c}")
    bad = [k for k, c in checks.items()
           if not all(v if isinstance(v, bool) else v < KERNEL_TOL for v in c.values())]
    if bad:
        raise RuntimeError(f"matvec_floor_probe: {bad} disagree with their plain versions "
                           f"or the f64 product (tolerance {KERNEL_TOL:g} of sum|x||v|)")

    rows = ("stream_sum", "stream_rowsum", "atx_int8", "atx_mxu", "atx_int8_plain",
            "ax_batch_int8", "ax_mxu", "ax_batch_int8_plain", "fused_normal_eq")
    summary = {"tool": "matvec_floor_probe",
               "shape": {"M": m, "N": n, "dtype": "int8", "x_bytes_gb": gb},
               "device": card_info(dev), "kernel_tol": KERNEL_TOL, "checks": checks}
    if dev.type != "cuda":
        log("no card: checks only, nothing timed")
        summary["results"] = {r: "not measured" for r in rows}
        for key in ("read_floor_gbps", "best_atx_gbps", "best_ax_gbps",
                    "implied_two_pass_gbps", "fused_measured_gbps"):
            summary[key] = "not measured"
        return summary

    # 2. timings: each kernel in turns with its plain version
    results = {}

    def rec(name, ms, plain_ms=None, passes=1):
        r = {"ms": ms, "gbps": passes * gb / ms * 1e3}
        if plain_ms is not None:
            r.update(plain_ms=plain_ms, plain_gbps=passes * gb / plain_ms * 1e3)
        results[name] = r
        log(f"{name}: {ms:.3f} ms = {r['gbps']:.1f} GB/s of X"
            + (f" (plain {plain_ms:.3f} ms = {r['plain_gbps']:.1f} GB/s)" if plain_ms else ""))

    for name, kern, plain in (("stream_sum", stream_sum, stream_sum_plain),
                              ("stream_rowsum", stream_rowsum, stream_rowsum_plain)):
        ms, plain_ms, _, _ = in_turns(lambda: kern(X), lambda: plain(X))
        rec(name, ms, plain_ms)
    for name, (kern, plain, _, broadcast) in vec.items():
        v = w if broadcast else y
        ms, plain_ms, _, _ = in_turns(lambda: kern(X, v), lambda: plain(X, v))
        rec(name, ms, plain_ms)
    for name in ("atx_int8", "ax_batch_int8"):
        rec(f"{name}_plain", results[name]["plain_ms"])

    dm = unit_design(X)
    rec("fused_normal_eq", card_ms(lambda: normal_eq_mult(dm, w[:, 0], 1.0, 1.0),
                                   calls=KERNEL_CALLS), passes=2)

    def best(prefix):
        return max(r["gbps"] for k, r in results.items() if k.startswith(prefix))

    best_atx, best_ax = best("atx"), best("ax_")
    summary.update(
        read_floor_gbps=max(results[k]["gbps"] for k in ("stream_sum", "stream_rowsum")),
        best_atx_gbps=best_atx, best_ax_gbps=best_ax,
        implied_two_pass_gbps=2.0 / (1.0 / best_ax + 1.0 / best_atx),
        fused_measured_gbps=results["fused_normal_eq"]["gbps"], results=results)
    log(f"floor {summary['read_floor_gbps']:.1f}, implied two-pass "
        f"{summary['implied_two_pass_gbps']:.1f}, fused {summary['fused_measured_gbps']:.1f} "
        f"GB/s on {summary['device']['nvidia_smi']}")
    return summary


def main(argv=None) -> int:
    args = tool_args(__doc__.splitlines()[0], argv, out=True)
    m, n = SMALL if args.small else FULL
    X = random_codes(m, n, torch.int8, args.seed, args.device)
    summary = probe(X, args.seed)
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
