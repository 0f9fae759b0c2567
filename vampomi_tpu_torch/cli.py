"""Command-line interface of the port: the JAX package's parser
(vampomi_tpu/cli.py:21-120, flag-compatible with the reference) plus
`--device {cuda,cpu}`.

Ported: `--run-mode infere` for both models (`--model linear` and
`--model bin_class`, with covariates through `--C` and `--cov-file`) with
the cg, spectral and eigen LMMSE solvers (auto picks as the JAX package
does, a warm `--eigen-cache` included) over f64, f32, bf16, int8 and
packed-int4 (`--compute-dtype int4`) designs, with `--checkpoint-file` and
`--resume-file`; `--run-mode test` and `predict` for both models;
`--run-mode association_test` (`--pval-method se | loo | loo_std`), which
does not depend on the model; `--init-conf` starts the prior from a Gibbs
warm start's `.conf` (python -m vampomi_tpu_torch.gibbs, then
scripts/conf_gibbs_init.py); `--profile-dir DIR` records the inference
run with torch.profiler, as the JAX package wraps it in jax.profiler.trace
(vampomi_tpu/cli.py:194-220).  The port refuses no flag of the JAX CLI.

    python -m vampomi_tpu_torch.cli --device cuda --meth-file x.bin ...

Every run mode of both models also runs with the markers split over ranks,
one process a rank, each holding a contiguous slab (sharding.py):

    VAMPOMI_DISTRIBUTED=1 python -m torch.distributed.run --nproc-per-node P \
        -m vampomi_tpu_torch.cli ...

The backend is gloo for `--device cpu`, nccl with a card per local rank,
gloo when ranks share a card.  Rank 0 writes the CSVs, the trace, the
checkpoint and `.yhat`; each rank writes its slab of the dumps and of a
p-value file, so every file is the one a single process writes, to the
rounding of the sums over markers.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

from .config import RunConfig, resolve_device


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
                   help="LMMSE solve: CG (reference-parity), the exact "
                        "spectral/Woodbury path (a Cholesky of the Gram "
                        "matrix's shift every iteration), or the eigen path "
                        "(once-per-dataset eigh of the Gram matrix)")
    x.add_argument("--spectral-max-n", type=int, default=16384,
                   help="auto solver picks spectral only when N <= this")
    x.add_argument("--eigen-cache", default="")
    x.add_argument("--eigen-build-budget", type=float, default=0.0,
                   help="wall-clock seconds the eigen build may take "
                        "(0 = unlimited)")
    x.add_argument("--checkpoint-file", default="")
    x.add_argument("--resume-file", default="")
    x.add_argument("--trace", type=int, default=1,
                   help="write <out>_trace.jsonl: each iteration's wall, phase "
                        "walls and passes over X")
    x.add_argument("--init-conf", default="",
                   help="warm-start .conf from scripts/conf_gibbs_init.py: sets "
                        "rho, h2, probs and vars; explicit --probs/--vars "
                        "flags still win")
    x.add_argument("--profile-dir", default="",
                   help="record the inference run (--run-mode infere) with "
                        "torch.profiler: CPU activity, and CUDA activity on the "
                        "card; one Chrome/TensorBoard trace a rank "
                        "(rank<r>.*.pt.trace.json) in this directory")
    x.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default; raises without one) or "
                        "on the CPU")
    return p


def load_init_conf(path: str) -> dict:
    """Parse a conf_gibbs_init .conf (tab-separated: ID rho mix_comp lambda
    probs vars h2; probs/vars comma-joined); vampomi_tpu/cli.py:123-135."""
    lines = [line for line in open(path).read().splitlines() if line.strip()]
    header = lines[0].split("\t")
    fields = dict(zip(header, lines[1].split("\t")))
    return dict(
        rho=float(fields["rho"]),
        h2=float(fields["h2"]),
        probs=[float(v) for v in fields["probs"].split(",")],
        vars=[float(v) for v in fields["vars"].split(",")],
    )


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
    if args.init_conf:
        conf = load_init_conf(args.init_conf)
        cfg.rho, cfg.h2 = conf["rho"], conf["h2"]
        cfg.probs, cfg.vars = conf["probs"], conf["vars"]
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
    cfg.check()
    return cfg


def _distributed() -> bool:
    """VAMPOMI_DISTRIBUTED=1: one process a rank (the JAX package's switch,
    vampomi_tpu/cli.py:171-183)."""
    return os.environ.get("VAMPOMI_DISTRIBUTED") == "1"


def profiled(profile_dir: str, device, shard):
    """torch.profiler over the block when `profile_dir` is set (else a null
    context): CPU activity, plus CUDA activity on a card, written when the
    block ends as one Chrome trace a rank, `rank<r>.<time>.pt.trace.json`,
    which TensorBoard's profiler plugin reads too."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    rank = 0 if shard is None else shard.rank
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir, f"rank{rank}"))


def main(argv: list[str] | None = None) -> int:
    """Dispatch the run mode as vampomi_tpu/cli.py:199-254 does: infere
    (with the covariates of `--cov-file` when `--C` > 0) and
    association_test load the training split, test and predict the test
    split (`--meth-file-test`, `--phen-file-test`, `--N-test`).  Under
    VAMPOMI_DISTRIBUTED=1 the rank's process group starts first, before
    anything touches the device, and ends with the run."""
    cfg = parse_config(sys.argv[1:] if argv is None else argv)
    if not _distributed():
        return _run(cfg, resolve_device(cfg.device), None)
    import torch.distributed as dist

    from .sharding import init_from_env, shard_for

    device = resolve_device(init_from_env(cfg.device))
    try:
        return _run(cfg, device, shard_for(cfg.Mt, device))
    finally:
        dist.destroy_process_group()


def _run(cfg: RunConfig, device, shard) -> int:
    """The run mode of `cfg` on `device`, on the rank's slab of `shard`
    (None: one process)."""
    dtype = cfg.resolved_compute_dtype()

    from .dataset import load_dataset

    if cfg.run_mode == "infere":
        ds = load_dataset(cfg.meth_file, cfg.phen_file, cfg.N, cfg.Mt, cfg.model,
                          dtype, device, alpha_scale=cfg.alpha_scale,
                          cov_file=cfg.cov_file, c=cfg.C, shard=shard)
    elif cfg.run_mode == "association_test":
        ds = load_dataset(cfg.meth_file, cfg.phen_file, cfg.N, cfg.Mt, cfg.model,
                          dtype, device, alpha_scale=cfg.alpha_scale, shard=shard)
    else:
        ds = load_dataset(cfg.meth_file_test, cfg.phen_file_test, cfg.N_test, cfg.Mt,
                          cfg.model, dtype, device, alpha_scale=cfg.alpha_scale, shard=shard)

    if cfg.run_mode == "infere":
        from .io.bin_io import read_bin_slab

        true_signal = (read_bin_slab(cfg.true_signal_file, cfg.Mt)
                       if cfg.true_signal_file else None)
        x1hat_init = (read_bin_slab(cfg.estimate_file, cfg.Mt)
                      if cfg.estimate_file else None)
        if cfg.model == "bin_class":
            from .engine.probit import infere_bin_class as infere
        else:
            from .engine.linear import infere_linear as infere
        with profiled(cfg.profile_dir, device, shard):
            infere(ds.dm, ds.phen.y, cfg, true_signal, x1hat_init, covariates=ds.covariates)
    elif cfg.run_mode == "test":
        from .modes.test_mode import run_test_linear, run_test_probit

        (run_test_probit if cfg.model == "bin_class" else run_test_linear)(ds, cfg)
    elif cfg.run_mode == "association_test":
        from .modes.association import run_association_test

        run_association_test(ds, cfg)
    else:
        from .modes.predict import run_predict

        run_predict(ds, cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
