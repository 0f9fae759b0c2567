"""Command-line interface of the port: the JAX package's parser
(vampomi_tpu/cli.py:21-120, flag-compatible with the reference) plus
`--device {cuda,cpu}`.

Ported: `--run-mode infere --model linear` with the cg and eigen LMMSE
solvers over f64, f32 and int8 designs.  Every other mode, model and the
flags below exit with a message naming ROADMAP.md; none is replaced by other
behaviour.

    python -m vampomi_tpu_torch.cli --device cuda --meth-file x.bin ...
"""

from __future__ import annotations

import argparse
import sys

from .config import NOT_PORTED_DTYPES, RunConfig, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vampomi_tpu_torch",
        description="gVAMP for omics-scale Bayesian regression (PyTorch/CUDA)",
    )
    s = p.add_argument_group("files")
    s.add_argument("--meth-file", default="")
    s.add_argument("--meth-file-test", default="")
    s.add_argument("--phen-file", default="")
    s.add_argument("--phen-file-test", default="")
    s.add_argument("--true-signal-file", default="")
    s.add_argument("--estimate-file", default="")
    s.add_argument("--r1-file", default="")
    s.add_argument("--cov-estimate-file", default="",
                   help="accepted for flag parity; unused (the reference "
                        "parses but never consumes it)")
    s.add_argument("--cov-file", default="")
    s.add_argument("--cov-file-test", default="")
    s.add_argument("--out-dir", default="")
    s.add_argument("--out-name", default="")

    m = p.add_argument_group("mode")
    m.add_argument("--run-mode", default="infere",
                   choices=["infere", "test", "association_test", "predict"])
    m.add_argument("--model", default="linear", choices=["linear", "bin_class"])
    m.add_argument("--pval-method", default="se", choices=["se", "loo", "loo_std"])

    d = p.add_argument_group("dimensions")
    d.add_argument("--Mt", type=int, default=0)
    d.add_argument("--N", type=int, default=0)
    d.add_argument("--N-test", type=int, default=0)
    d.add_argument("--Mt-test", type=int, default=0)
    d.add_argument("--C", type=int, default=0)

    h = p.add_argument_group("hyperparameters")
    h.add_argument("--iterations", type=int, default=50)
    h.add_argument("--stop-criteria-thr", type=float, default=0.01)
    h.add_argument("--merge-vars-thr", type=float, default=5e-1)
    h.add_argument("--EM-err-thr", type=float, default=1e-2)
    h.add_argument("--EM-max-iter", type=int, default=1)
    h.add_argument("--CG-max-iter", type=int, default=500)
    h.add_argument("--CG-err-tol", type=float, default=1e-5)
    # default -1 = "not passed": the flag is decorative (prior size is
    # len(--probs), reference options.cpp:147-155)
    h.add_argument("--num-mix-comp", type=int, default=-1)
    h.add_argument("--learn-vars", type=int, default=1)
    h.add_argument("--learn-prior-delay", type=int, default=1)
    h.add_argument("--em-h2-budget", type=float, default=0.0)
    h.add_argument("--alpha-scale", type=float, default=1.0)
    h.add_argument("--probit-var", type=float, default=1.0)
    h.add_argument("--rho", type=float, default=0.5)
    h.add_argument("--h2", type=float, default=0.5)
    h.add_argument("--gam1", type=float, default=1e-6)
    h.add_argument("--verbosity", type=int, default=0)
    h.add_argument("--redglob", type=int, default=0)
    h.add_argument("--vars", type=str, default="")
    h.add_argument("--probs", type=str, default="")
    h.add_argument("--test-iter-range", type=str, default="")

    x = p.add_argument_group("extensions")
    x.add_argument("--compute-dtype", default="auto",
                   choices=["auto", "float64", "float32", "bfloat16", "int8",
                            "int4", "f64", "f32", "bf16", "i8", "i4"])
    x.add_argument("--seed", type=int, default=0)
    x.add_argument("--lmmse-solver", default="auto",
                   choices=["auto", "cg", "spectral", "eigen"],
                   help="LMMSE solve: CG (reference-parity) or the eigen path "
                        "(once-per-dataset eigh of the Gram matrix); spectral "
                        "is not ported yet")
    x.add_argument("--spectral-max-n", type=int, default=16384,
                   help="auto solver picks spectral only when N <= this")
    x.add_argument("--eigen-cache", default="")
    x.add_argument("--eigen-build-budget", type=float, default=0.0,
                   help="wall-clock seconds the eigen build may take "
                        "(0 = unlimited)")
    x.add_argument("--checkpoint-file", default="")
    x.add_argument("--resume-file", default="")
    x.add_argument("--trace", type=int, default=1,
                   help="write <out>_trace.jsonl per-iteration telemetry")
    x.add_argument("--init-conf", default="")
    x.add_argument("--profile-dir", default="")
    x.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default; raises without one) or "
                        "on the CPU")
    return p


def parse_config(argv: list[str]) -> RunConfig:
    args = build_parser().parse_args(argv)
    cfg = RunConfig()
    for key in vars(args):
        if key in ("vars", "probs", "test_iter_range", "init_conf",
                   "num_mix_comp"):
            continue
        setattr(cfg, key, getattr(args, key))
    if args.num_mix_comp >= 0:
        cfg.num_mix_comp = args.num_mix_comp
    if args.vars:
        cfg.vars = [float(v) for v in args.vars.split(",")]
    if args.probs:
        cfg.probs = [float(v) for v in args.probs.split(",")]
    if args.test_iter_range:
        cfg.test_iter_range = [int(v) for v in args.test_iter_range.split(",")]
    if args.num_mix_comp >= 0 and args.num_mix_comp != len(cfg.probs):
        print(f"WARNING: --num-mix-comp {args.num_mix_comp} is decorative — "
              f"the prior has len(--probs) = {len(cfg.probs)} components "
              f"(reference options.cpp:147-155)")
    _reject_unported(cfg, args.init_conf)
    cfg.check()
    return cfg


def _reject_unported(cfg: RunConfig, init_conf: str) -> None:
    """SystemExit naming ROADMAP.md for every mode, model and flag the
    port does not run yet."""
    bad = []
    if cfg.run_mode != "infere":
        bad.append(f"--run-mode {cfg.run_mode}")
    if cfg.model != "linear":
        bad.append(f"--model {cfg.model}")
    if cfg.C > 0:
        bad.append("--C > 0 (covariates)")
    for flag, val in (("--resume-file", cfg.resume_file),
                      ("--checkpoint-file", cfg.checkpoint_file),
                      ("--eigen-cache", cfg.eigen_cache),
                      ("--init-conf", init_conf),
                      ("--profile-dir", cfg.profile_dir)):
        if val:
            bad.append(flag)
    if cfg.lmmse_solver == "spectral":
        bad.append("--lmmse-solver spectral")
    if cfg.compute_dtype in NOT_PORTED_DTYPES:
        bad.append(f"--compute-dtype {cfg.compute_dtype}")
    if bad:
        raise SystemExit(
            f"vampomi_tpu_torch: {', '.join(bad)} not ported yet — see the "
            "port's queue in ROADMAP.md (use the JAX package vampomi_tpu meanwhile)")


def main(argv: list[str] | None = None) -> int:
    cfg = parse_config(sys.argv[1:] if argv is None else argv)
    device = resolve_device(cfg.device)
    dtype = cfg.resolved_compute_dtype()

    from .dataset import load_dataset
    from .engine.linear import infere_linear
    from .io.bin_io import read_bin_slab

    ds = load_dataset(cfg.meth_file, cfg.phen_file, cfg.N, cfg.Mt, cfg.model,
                      dtype, device, alpha_scale=cfg.alpha_scale)
    true_signal = (read_bin_slab(cfg.true_signal_file, cfg.Mt)
                   if cfg.true_signal_file else None)
    x1hat_init = (read_bin_slab(cfg.estimate_file, cfg.Mt)
                  if cfg.estimate_file else None)
    infere_linear(ds.dm, ds.phen.y, cfg, true_signal, x1hat_init)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
