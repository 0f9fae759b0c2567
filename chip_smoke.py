#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py [--log-dir DIR]

Phases (each prints its own lines; any failure ends the run non-zero):

  0. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit and torch's device name.
  1. build    — builds the atx_int8 kernel from vampomi_tpu_torch/csrc.
  2. kernel   — atx_int8 against its plain PyTorch version at the north-star
                shape M = 1,048,576 x N = 10,240 (int8 X made on the card
                from a seed) and at a ragged shape, plus an f64 reference on
                a sample of rows; both timed with CUDA events.
  3. parity   — infere_linear on the card against the same port on the CPU
                at M = 16,384 x N = 2,048 (int8, data_sim): eigen for 4
                iterations, cg for 3.
  4. cli      — the CLI through files (N = 2,000 x M = 8,000, int8) with
                eigen and with cg; every output file must exist, be finite,
                and the x1 correlation must rise.
  5. main     — the main path at the north-star shape: a planted int8 design
                (1,024 causal markers, h2 = 0.8, prior fixed at the truth),
                5 eigen iterations and 2 CG iterations; prints setup and
                per-iteration seconds and peak memory, and checks that every
                iteration went through the kernel.

The line before the last is the kernel record {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.  The engine's own per-iteration
narration goes to log files in --log-dir when given; outputs and (by
default) logs go to a temporary directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from vampomi_tpu_torch import cli  # noqa: E402
from vampomi_tpu_torch.config import RunConfig, resolve_device  # noqa: E402
from vampomi_tpu_torch.engine.linear import infere_linear  # noqa: E402
from vampomi_tpu_torch.io.bin_io import read_bin_slab  # noqa: E402
from vampomi_tpu_torch.io.csv_writer import read_positional_csv  # noqa: E402
from vampomi_tpu_torch.ops import _build  # noqa: E402
from vampomi_tpu_torch.ops.atx_int8 import atx_int8, atx_int8_plain  # noqa: E402
from vampomi_tpu_torch.ops.operator import (  # noqa: E402
    ax, ax_batch, build_design, design_from_codes,
)
from vampomi_tpu_torch.sim.data_sim import simulate_iid, write_fixture  # noqa: E402

NS_M, NS_N = 1_048_576, 10_240          # the north-star shape (README.md, bench.py)
SEED = 20261016
# kernel vs plain / f64: both sum N f32 products, in different orders.  The
# worst-case bound relative to sum|x||y| is N * 2^-24 ~ 6e-4 at N = 10,240;
# rounding errors of random signs meet ~sqrt(N) * 2^-24 ~ 6e-6 at most.
KERNEL_TOL = 1e-5
# card against CPU, both f32 with the same probes: sums in another order.
# eigen is exact per iteration (1e-4 leaves room for 4 iterations of
# amplification); CG stops at rel-residual 1e-5 and may stop one step
# apart, which the Hutchinson alpha2 and gamw carry (1e-3).
PARITY_RTOL = {"eigen": 1e-4, "cg": 1e-3}
PARITY_ATOL = 1e-5  # metrics that start at 0 at the cold start
PRIOR3 = dict(probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], h2=0.8)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def engine_log(log_dir: str, name: str):
    """Send the engine's narration of one run to <log_dir>/<name>.log."""
    with open(os.path.join(log_dir, f"{name}.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        yield


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def rel_err(got: torch.Tensor, want: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> float:
    """max |got - want| / sum_n |x_mn||y_n| over the rows, in f64."""
    scale = torch.empty(X.shape[0], dtype=torch.float64, device=X.device)
    ya = y.double().abs()
    for lo in range(0, X.shape[0], 65536):
        scale[lo:lo + 65536] = X[lo:lo + 65536].double().abs() @ ya
    return float(((got.double() - want.double()).abs() / scale.clamp_min(1e-30)).max())


# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        raise SystemExit(2)
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s) visible")
    return str(dev)


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library("atx_int8")
    log(f"[build] atx_int8 from vampomi_tpu_torch/csrc/atx_int8.cu in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_build.BUILD_SECONDS['atx_int8']:.2f}s)")


def make_codes(m: int, n: int, seed: int, device) -> torch.Tensor:
    """Uniform int8 codes in [-127, 127], made on the device in row chunks."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    X = torch.empty((m, n), dtype=torch.int8, device=device)
    rows = max(1, (256 << 20) // n)
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        X[lo:hi] = torch.randint(-127, 128, (hi - lo, n), dtype=torch.int8,
                                 device=device, generator=g)
    return X


def phase_kernel(dev: str) -> tuple[torch.Tensor, dict]:
    X = make_codes(NS_M, NS_N, SEED, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    y = torch.randn(NS_N, device=dev, generator=g)
    got = atx_int8(X, y)
    plain = atx_int8_plain(X, y)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    err_plain = rel_err(got, plain, X, y)
    max_abs = float((got - plain).abs().max())
    rows = torch.randperm(NS_M, generator=torch.Generator().manual_seed(SEED))[:4096].to(dev)
    ref = X[rows].double() @ y.double()
    err_ref = rel_err(got[rows], ref, X[rows], y)
    log(f"[kernel] M={NS_M} N={NS_N}: max rel err vs plain {err_plain:.3e}, vs f64 "
        f"on 4096 rows {err_ref:.3e} (tolerance {KERNEL_TOL:g} of sum|x||y|); "
        f"max abs diff vs plain {max_abs:.4g}")
    check(err_plain < KERNEL_TOL and err_ref < KERNEL_TOL, "kernel disagrees at the full shape")
    check(torch.equal(got, atx_int8(X, y)), "kernel not bitwise repeatable")

    Xr = make_codes(1000, 1001, SEED + 2, dev)
    yr = torch.randn(1001, device=dev, generator=g)
    err_r = rel_err(atx_int8(Xr, yr), Xr.double() @ yr.double(), Xr, yr)
    log(f"[kernel] ragged M=1000 N=1001: max rel err vs f64 {err_r:.3e}")
    check(err_r < KERNEL_TOL, "kernel disagrees at the ragged shape")

    # plain, kernel, kernel, plain: both medians from the same card and call
    t_plain = [cuda_ms(lambda: atx_int8_plain(X, y))]
    t_kern = [cuda_ms(lambda: atx_int8(X, y)), cuda_ms(lambda: atx_int8(X, y))]
    t_plain.append(cuda_ms(lambda: atx_int8_plain(X, y)))
    ms, plain_ms = float(np.median(t_kern)), float(np.median(t_plain))
    gb = NS_M * NS_N / 1e9
    log(f"[kernel] atx_int8 {ms:.3f} ms ({gb / ms * 1e3:.1f} GB/s of X); plain "
        f"{plain_ms:.3f} ms ({gb / plain_ms * 1e3:.1f} GB/s); medians of 7 after "
        f"2 warm-ups, runs {t_kern} / {t_plain}")
    rec = dict(name="atx_int8", route="cuda", source="vampomi_tpu_torch/csrc/atx_int8.cu",
               replaces="vampomi_tpu/ops/pallas_matvec.py:55", launches=0,
               max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    return X, rec


def _params_rows(d: str, name: str) -> np.ndarray:
    return np.asarray(read_positional_csv(os.path.join(d, f"{name}_params.csv")))


def run_pair(devices, m: int, n: int, log_dir: str, out_dir: str, iters: dict) -> dict:
    """infere_linear on each device on the same int8 design; returns the
    per-iteration [alpha1, gam1, alpha2, gam2, gamw] + metrics per run."""
    fx = simulate_iid(n=n, m=m, lam=0.1, h2=PRIOR3["h2"], seed=SEED)
    y = fx.y * math.sqrt((n - 1.0) / np.sum((fx.y - fx.y.mean()) ** 2))
    out = {}
    for solver, k in iters.items():
        for dev in devices:
            dm = build_design(fx.X.T, compute_dtype=torch.int8, device=dev)
            cfg = RunConfig(out_dir=out_dir, out_name=f"parity_{solver}_{dev}", iterations=k,
                            lmmse_solver=solver, stop_criteria_thr=0.0, device=dev,
                            seed=SEED, **PRIOR3)
            with engine_log(log_dir, f"parity_{solver}_{dev}"):
                res = infere_linear(dm, y, cfg, true_signal=fx.beta)
            p = _params_rows(out_dir, cfg.out_name)[:, 1:]
            out[(solver, dev)] = np.concatenate([p, np.asarray(res.metrics_history)], axis=1)
    return out


def phase_parity(dev: str, log_dir: str, out_dir: str, m: int = 16_384, n: int = 2_048) -> None:
    t0 = time.perf_counter()
    runs = run_pair([dev, "cpu"], m, n, log_dir, out_dir, {"eigen": 4, "cg": 3})
    for solver in ("eigen", "cg"):
        a, b = runs[(solver, dev)], runs[(solver, "cpu")]
        check(a.shape == b.shape and np.all(np.isfinite(a)), f"{solver}: bad shapes or values")
        err = np.abs(a - b) / np.maximum(np.abs(b), PARITY_ATOL / PARITY_RTOL[solver])
        log(f"[parity] {solver} M={m} N={n} int8, {a.shape[0]} iterations: max rel diff "
            f"card vs cpu {err.max():.3e} (tolerance {PARITY_RTOL[solver]:g}, atol "
            f"{PARITY_ATOL:g}); x1 corr per it {np.round(a[:, 6], 6).tolist()}")
        check(np.all(np.abs(a - b) <= PARITY_RTOL[solver] * np.abs(b) + PARITY_ATOL),
              f"{solver}: card and cpu disagree")
    log(f"[parity] done in {time.perf_counter() - t0:.1f}s")


def phase_cli(dev: str, log_dir: str, n: int = 2_000, m: int = 8_000, iters: int = 8) -> None:
    with tempfile.TemporaryDirectory(prefix="vampomi_cli_") as d:
        paths = write_fixture(simulate_iid(n=n, m=m, lam=0.1, h2=0.8, seed=SEED), d, "ex")
        log(f"[cli] fixture N={n} M={m}: {os.path.getsize(paths['bin'])} bytes of .bin")
        for solver in ("eigen", "cg"):
            out = f"run_{solver}"
            argv = ["--run-mode", "infere", "--model", "linear", "--meth-file", paths["bin"],
                    "--phen-file", paths["phen"], "--true-signal-file", paths["ts"],
                    "--N", str(n), "--Mt", str(m), "--out-dir", d, "--out-name", out,
                    "--iterations", str(iters), "--stop-criteria-thr", "0",
                    "--h2", "0.8", "--probs", "0.9,0.07,0.03", "--vars", "0.0,0.001,0.01",
                    "--device", dev, "--compute-dtype", "int8", "--lmmse-solver", solver]
            t0 = time.perf_counter()
            with engine_log(log_dir, f"cli_{solver}"):
                check(cli.main(argv) == 0, f"cli {solver} returned non-zero")
            took = time.perf_counter() - t0
            want = {f"{out}_{s}.csv" for s in ("metrics", "params", "prior")}
            want |= {f"{out}_trace.jsonl"}
            want |= {f"{out}_{k}it_{i}.bin" for k in ("", "r1_") for i in range(1, iters + 1)}
            have = {f for f in os.listdir(d) if f.startswith(out + "_")}
            check(have == want, f"cli {solver}: files {sorted(have ^ want)} differ")
            for f in sorted(want):
                p = os.path.join(d, f)
                if f.endswith(".bin"):
                    check(bool(np.all(np.isfinite(read_bin_slab(p, m)))), f"{f} not finite")
                elif f.endswith(".csv"):
                    check(bool(np.all(np.isfinite(read_positional_csv(p)))), f"{f} not finite")
            x1c = [r[2] for r in read_positional_csv(os.path.join(d, f"{out}_metrics.csv"))]
            log(f"[cli] {solver}: {len(want)} files in {took:.1f}s; x1 corr "
                f"{np.round(x1c, 4).tolist()}")
            check(x1c[-1] > x1c[0] and x1c[-1] > 0.5, f"cli {solver}: x1 correlation did not rise")


def planted_problem(X: torch.Tensor, causal: int = 1024, h2: float = 0.8):
    """y = A beta + e in file units on the design of the codes X."""
    dm = design_from_codes(X)
    m, n = X.shape
    gen = torch.Generator().manual_seed(SEED + 3)
    idx = torch.randperm(m, generator=gen)[:causal]
    beta = np.zeros(m)
    beta[idx.numpy()] = np.random.default_rng(SEED).normal(0.0, math.sqrt(h2 / causal), causal)
    g = math.sqrt(n) * ax(dm, torch.as_tensor(beta, dtype=torch.float32, device=X.device))
    y = g.double().cpu().numpy() + np.random.default_rng(SEED + 1).normal(
        0.0, math.sqrt(1.0 - h2), n)
    y = y * math.sqrt((n - 1.0) / np.sum((y - y.mean()) ** 2))  # as read_phen does
    prior = dict(probs=[1.0 - causal / m, causal / m], vars=[0.0, h2 / causal], h2=h2)
    return dm, y, beta, prior


def phase_main(X: torch.Tensor, log_dir: str, out_dir: str, iters: int = 5,
               cg_iters: int = 2, cg_max_iter: int = 50, causal: int = 1024) -> int:
    dev = X.device
    t0 = time.perf_counter()
    dm, y, beta, prior = planted_problem(X, causal)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    m, n = X.shape
    log(f"[main] planted int8 design M={m} N={n} (M/N={m / n:.0f}), {causal} causal, "
        f"h2=0.8, prior fixed at the truth: built in {time.perf_counter() - t0:.1f}s")
    if dev.type == "cuda":
        W = torch.randn((m, 2), device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
        ms = cuda_ms(lambda: ax_batch(dm, W), reps=5, warmup=1)
        log(f"[main] plain int8 ax_batch (K=2): {ms:.3f} ms ({m * n / ms / 1e6:.1f} GB/s of X)")
        del W
    launches = 0
    for solver, k in (("eigen", iters), ("cg", cg_iters)):
        cfg = RunConfig(out_dir=out_dir, out_name=f"main_{solver}", iterations=k,
                        lmmse_solver=solver, stop_criteria_thr=0.0, learn_vars=0,
                        learn_prior_delay=k, CG_max_iter=cg_max_iter, device=str(dev),
                        seed=SEED, **prior)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        atx_int8.launches = 0
        with engine_log(log_dir, f"main_{solver}"):
            res = infere_linear(dm, y, cfg, true_signal=beta)
        sync()
        count = atx_int8.launches
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")
        mh = np.asarray(res.metrics_history)
        secs = res.iter_seconds
        steady = secs[1:] if len(secs) > 1 else secs
        setup = res.setup
        extra = (f"gram {setup['gram']:.3f}s, eigh {setup['eigh']:.3f}s (residual "
                 f"{setup['eigen_resid']:.2e}), " if solver == "eigen" else "")
        log(f"[main] {solver}: {extra}A^T y {setup['aty']:.4f}s; per-iteration seconds "
            f"{[round(s, 4) for s in secs]}; {1.0 / np.mean(steady):.2f} it/s over "
            f"iterations 2..{len(secs)}; peak memory {peak:.2f} GiB; atx_int8 launches "
            f"{count}; x1 corr {np.round(mh[:, 1], 4).tolist()}")
        check(np.all(np.isfinite(mh)) and np.all(np.isfinite(res.x1_hat_scaled)),
              f"{solver}: outputs not finite")
        check(mh[-1, 1] > mh[0, 1], f"{solver}: x1 correlation did not rise")
        # the trajectory recovers signal first; at M/N ~ 100 the noise-
        # precision EM then drives it down in the JAX engine too (PERF.md)
        check(mh[:, 1].max() > 0.4, f"{solver}: x1 correlation never passed 0.4")
        for i in range(1, k + 1):
            check(bool(np.all(np.isfinite(read_bin_slab(
                os.path.join(out_dir, f"main_{solver}_it_{i}.bin"), m)))), "dump not finite")
        if solver == "eigen":
            check(count >= k + 1, f"atx_int8 launched {count} times, want >= {k + 1}")
            launches = count
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log-dir", default="",
                   help="keep the engine's logs here (default: a temporary "
                        "directory, removed at the end)")
    args = p.parse_args(argv)
    dev = phase_device()
    with tempfile.TemporaryDirectory(prefix="vampomi_smoke_") as out_dir:
        log_dir = args.log_dir or out_dir
        os.makedirs(log_dir, exist_ok=True)
        t0 = time.perf_counter()
        phase_build()
        X, rec = phase_kernel(dev)
        phase_parity(dev, log_dir, out_dir)
        phase_cli(dev, log_dir)
        rec["launches"] = phase_main(X, log_dir, out_dir)
        log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [rec]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
