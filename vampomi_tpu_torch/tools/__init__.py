"""Measurement tools of the port, the counterparts of the JAX package's probe
scripts under tools/, and what they share with chip_smoke.py.

    python -m vampomi_tpu_torch.tools.matvec_floor_probe [--device cuda|cpu] [--small] [--seed S] [--out PATH]
    python -m vampomi_tpu_torch.tools.r4_probe [--device cuda|cpu] [--small] [--seed S]
    python -m vampomi_tpu_torch.tools.dense_step_probe [--device cuda|cpu] [--small] [--seed S]

Each matvec tool checks every kernel it times against its plain version and the
exact f64 product first, then times kernel and plain with CUDA events in
turns (plain, kernel, kernel, plain), and prints one JSON summary line last,
with the card's name and power limit as nvidia-smi reports them.  A
kernel's sample is the mean of KERNEL_CALLS back-to-back calls, so the
host's launch time does not count as the card's.  With
`--device cpu` the wrappers run their plain versions and nothing is timed:
no time measured on a CPU is reported.  `--device cuda` without a card
raises; there is no fallback to the CPU.  The dense-step probe checks and
times the spectral solver's blocked factor the same way (its docstring).
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ..config import resolve_device
from ..ops.operator import PACKED4_DTYPE
from ..ops.packed4 import unpack_rows

# A kernel against its plain version or the f64 product: both sum exact f32
# products in different orders.  The worst-case bound relative to
# sum |x||v| is (terms in the longest chain of additions) * 2^-24; rounding
# errors of random signs meet ~sqrt(chain) * 2^-24: ~6e-6 for the N = 10,240
# products of a row, and no more for the broadcast kernels, whose lanes each
# sum at most ~16k rows before the partials meet.  The tensor cores' f32
# sums truncate where IEEE adds round, at most one unit in the last place
# of the running sum per product, which at these shapes stays below 2e-6 of
# sum |x||v| (PERF.md).
KERNEL_TOL = 1e-5

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes
# per second, and FLOPs per second of f32 on the CUDA cores and of bf16 on
# the tensor cores
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


def tool_args(description: str, argv, out: bool = False) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    p.add_argument("--small", action="store_true",
                   help="a toy shape: checks only on the CPU, a quick run on a card")
    p.add_argument("--seed", type=int, default=7)
    if out:
        p.add_argument("--out", default="", help="also write the JSON summary to this file")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def card_info(device: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi) and torch's name for it;
    on the CPU, "not measured" for both."""
    if device.type != "cuda":
        return {"platform": "cpu", "nvidia_smi": "not measured", "kind": "not measured"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return {"platform": "gpu", "nvidia_smi": smi.stdout.strip().splitlines()[0],
            "kind": torch.cuda.get_device_name(device)}


def random_codes(m: int, nb: int, dtype: torch.dtype, seed: int, device) -> torch.Tensor:
    """Uniform codes made on the device in row chunks: int8 in [-127, 127],
    or uint8 bytes of two uniform nibbles in [0, 15] (codes in [-8, 7]);
    for bfloat16, standard normal values rounded to bf16."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lo, hi = (-127, 128) if dtype == torch.int8 else (0, 256)
    X = torch.empty((m, nb), dtype=dtype, device=device)
    rows = max(1, (256 << 20) // nb)
    for r in range(0, m, rows):
        r1 = min(m, r + rows)
        if dtype == torch.bfloat16:
            X[r:r1] = torch.randn((r1 - r, nb), device=device, generator=g)
        else:
            X[r:r1] = torch.randint(lo, hi, (r1 - r, nb), dtype=dtype, device=device,
                                    generator=g)
    return X


def codes64(X: torch.Tensor) -> torch.Tensor:
    return unpack_rows(X, torch.float64) if X.dtype == PACKED4_DTYPE else X.double()


def exact_and_scale(X: torch.Tensor, V: torch.Tensor, broadcast: bool):
    """The f64 product of the codes of X with V (rows, K), and |codes| @ |V|:
    per row of X (X V), or summed over rows (X^T V), one chunk of rows at a
    time."""
    V64 = V.double()
    if broadcast:
        ex = torch.zeros((codes64(X[:1]).shape[1], V.shape[1]), dtype=torch.float64,
                         device=X.device)
        sc = torch.zeros_like(ex)
    else:
        ex = torch.empty((X.shape[0], V.shape[1]), dtype=torch.float64, device=X.device)
        sc = torch.empty_like(ex)
    for r in range(0, X.shape[0], 16384):
        r1 = min(X.shape[0], r + 16384)
        C = codes64(X[r:r1])
        if broadcast:
            ex += C.T @ V64[r:r1]
            sc += C.abs().T @ V64[r:r1].abs()
        else:
            ex[r:r1] = C @ V64
            sc[r:r1] = C.abs() @ V64.abs()
    return ex, sc


def bound_ms(nbytes: int, ops: int, ops_rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least milliseconds the card could take for work that moves
    `nbytes` through HBM (each input read once, each output written once)
    and does `ops` operations at `ops_rate`: the larger of the two times,
    and which sets it ("bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def matvec_bound(X: torch.Tensor, k: int, broadcast: bool,
                 ops_rate: float = F32_FLOPS) -> tuple[float, str]:
    """bound_ms of one pass over the codes (or bf16 values) of X with k
    right-hand sides: X Ys (Ys (N, k) in, (M, k) out) or, broadcast, X^T W
    (W (M, k) in, (N, k) out), each byte once, at 2 operations per code and
    column."""
    m = X.shape[0]
    codes = X.numel() * (2 if X.dtype == PACKED4_DTYPE else 1)
    n = codes // m
    vectors = 4 * k * (m + n)
    return bound_ms(X.numel() * X.element_size() + vectors, 2 * codes * k, ops_rate)


def rel_err(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """max |got - want| relative to `scale` (sum |x||v|), elementwise."""
    return float(((got.double() - want.double()).abs() / scale.clamp_min(1e-30)).max())


# calls timed back to back per sample for a kernel: the host's time to
# launch each call then overlaps the card's work on the call before, so it
# does not count as the card's (single-call samples once read up to 0.5 ms
# high on the H100, PERF.md)
KERNEL_CALLS = 5


def card_ms(fn, reps: int = 7, warmup: int = 2, calls: int = 1) -> float:
    """Median milliseconds of one fn() on the card, by CUDA events around
    `calls` back-to-back calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return float(np.median(times))


def in_turns(kern, plain, plain_calls: int = 1) -> tuple[float, float, list, list]:
    """Kernel and plain version timed in turns (plain, kernel, kernel,
    plain): the medians over the kernel's two runs of 7 samples of
    KERNEL_CALLS calls and the plain version's two runs of 5 samples of
    `plain_calls` calls, and the runs."""
    t_plain = [card_ms(plain, reps=5, warmup=1, calls=plain_calls)]
    t_kern = [card_ms(kern, calls=KERNEL_CALLS), card_ms(kern, calls=KERNEL_CALLS)]
    t_plain.append(card_ms(plain, reps=5, warmup=1, calls=plain_calls))
    return float(np.median(t_kern)), float(np.median(t_plain)), t_kern, t_plain
