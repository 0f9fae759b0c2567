"""The int8 and packed-int4 matvec kernels at the north-star M, on the CUDA
cores and on the tensor cores: the port of tools/r4_probe.py.

    python -m vampomi_tpu_torch.tools.r4_probe [--device cuda|cpu] [--small] [--seed S]

The TPU probe asked whether Pallas beat XLA's int8 matvec and whether packed
int4 pays (tools/r4_probe.py:1-15).  Its kernels and their counterparts here:

  #9  `atx_i8_vpu_call`  (r4_probe.py:52-74)   → `atx_int8`, the same function
  #10 `ax2_i8_pallas`    (r4_probe.py:77-103)  → `ax_batch_int8`, K = 2
  #11 `atx_i4_vpu_call`  (r4_probe.py:109-136) → `atx_packed4`, the same function
  #12 `ax2_i4_pallas`    (r4_probe.py:139-174) → `ax2_packed4_mxu`, K = 2,
      tensor cores with W in bf16; timed beside the f32 CUDA-core
      `ax_batch_packed4` at K = 2.

#9 and #11 are the prototypes of the operator's Pallas kernels and differ
from them only in tiling, so the kernels that replace those stand for them.

Correctness on the first 65,536 rows (r4_probe.py:209-229): #9 and #11
against the exact f64 product, #12 against the f64 product of the
bf16-rounded W and against its own bf16 reference (the plain version).
Timings at M = 1,048,576: int8 X of N = 10,240 and packed X of N/2 = 5,120
bytes a row, int8 codes uniform in [-127, 127] and nibbles uniform in
[0, 15], each kernel in turns with its plain version.  Rates are GB/s of
the bytes of X (10^9 bytes).

The last line of standard output is the JSON summary.  `--small` runs
M = 4,096 x N = 512; with `--device cpu` it runs the checks only, through
the plain versions.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops.atx_int8 import atx_int8, atx_int8_plain
from ..ops.broadcast import (
    ax_batch_int8, ax_batch_int8_plain, ax_batch_packed4, ax_batch_packed4_plain,
)
from ..ops.mxu import ax2_packed4_mxu, ax2_packed4_mxu_plain, bf16_round
from ..ops.operator import PACKED4_DTYPE
from ..ops.packed4 import atx_packed4, atx_packed4_plain
from . import KERNEL_TOL, card_info, exact_and_scale, in_turns, random_codes, rel_err, tool_args

FULL = (1 << 20, 10_240)
SMALL = (4096, 512)
CHECK_ROWS = 65_536


def log(msg: str) -> None:
    print(f"[r4] {msg}", flush=True)


def probe(X8: torch.Tensor, X4: torch.Tensor, seed: int = 0) -> dict:
    """Check on the first CHECK_ROWS rows, then (on a card) time every row
    at full M, for int8 X8 (M, N) and packed X4 (M, N/2); returns the
    summary."""
    dev = X8.device
    m, n = X8.shape
    if X4.shape != (m, n // 2) or X4.dtype != PACKED4_DTYPE:
        raise ValueError(f"r4_probe: need packed X4 ({m}, {n // 2}) uint8 beside int8 X8 "
                         f"{tuple(X8.shape)}, got {tuple(X4.shape)} {X4.dtype}")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    y = torch.randn(n, device=dev, generator=g)
    W2 = torch.randn((m, 2), device=dev, generator=g)

    ms_rows = min(m, CHECK_ROWS)
    x8, x4, w2 = X8[:ms_rows], X4[:ms_rows], W2[:ms_rows]
    checks = {}
    for name, kern, plain, X in (("atx_int8", atx_int8, atx_int8_plain, x8),
                                 ("atx_packed4", atx_packed4, atx_packed4_plain, x4)):
        got = kern(X, y)[:, None]
        ex, sc = exact_and_scale(X, y[:, None], broadcast=False)
        checks[name] = {"rel_err_vs_f64": rel_err(got, ex, sc),
                        "rel_err_vs_plain": rel_err(got, plain(X, y)[:, None], sc)}
    got = ax2_packed4_mxu(x4, w2)
    ex, sc = exact_and_scale(x4, bf16_round(w2), broadcast=True)
    checks["ax2_packed4_mxu"] = {"rel_err_vs_f64": rel_err(got, ex, sc),
                                 "rel_err_vs_plain": rel_err(got, ax2_packed4_mxu_plain(x4, w2),
                                                             sc),
                                 "repeatable": torch.equal(got, ax2_packed4_mxu(x4, w2))}
    for name, c in checks.items():
        log(f"check {name} on {ms_rows} rows: {c}")
    bad = [k for k, c in checks.items()
           if not all(v if isinstance(v, bool) else v < KERNEL_TOL for v in c.values())]
    if bad:
        raise RuntimeError(f"r4_probe: {bad} disagree with the f64 product or their plain "
                           f"versions (tolerance {KERNEL_TOL:g} of sum|x||v|)")

    timed = {  # name: (kernel, plain, X, right-hand side)
        "atx_int8": (atx_int8, atx_int8_plain, X8, y),
        "ax_batch_int8": (ax_batch_int8, ax_batch_int8_plain, X8, W2),
        "atx_packed4": (atx_packed4, atx_packed4_plain, X4, y),
        "ax2_packed4_mxu": (ax2_packed4_mxu, ax2_packed4_mxu_plain, X4, W2),
        "ax_batch_packed4": (ax_batch_packed4, ax_batch_packed4_plain, X4, W2),
    }
    summary = {"tool": "r4_probe", "shape": {"M": m, "N": n, "int8_bytes_gb": X8.numel() / 1e9,
                                             "packed_bytes_gb": X4.numel() / 1e9},
               "device": card_info(dev), "kernel_tol": KERNEL_TOL, "check_rows": ms_rows,
               "checks": checks}
    if dev.type != "cuda":
        log("no card: checks only, nothing timed")
        summary["results"] = {name: "not measured" for name in timed}
        return summary
    results = {}
    for name, (kern, plain, X, v) in timed.items():
        ms, plain_ms, _, _ = in_turns(lambda: kern(X, v), lambda: plain(X, v))
        gb = X.numel() / 1e9
        results[name] = {"ms": ms, "gbps": gb / ms * 1e3, "plain_ms": plain_ms,
                         "plain_gbps": gb / plain_ms * 1e3, "K": v.shape[1] if v.dim() == 2 else 1}
        log(f"{name} (K={results[name]['K']}): {ms:.3f} ms = {results[name]['gbps']:.1f} GB/s "
            f"of X; plain {plain_ms:.3f} ms = {results[name]['plain_gbps']:.1f} GB/s")
    summary["results"] = results
    return summary


def main(argv=None) -> int:
    args = tool_args(__doc__.splitlines()[0], argv)
    m, n = SMALL if args.small else FULL
    X8 = random_codes(m, n, torch.int8, args.seed, args.device)
    X4 = random_codes(m, n // 2, PACKED4_DTYPE, args.seed + 1, args.device)
    print(json.dumps(probe(X8, X4, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
