#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py [--log-dir DIR] [--gibbs-reference CU]

Phases (each prints its own lines; any failure ends the run non-zero):

  0. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit and torch's device name.
  1. build    — builds the sixteen kernel libraries from vampomi_tpu_torch/csrc,
                one nvcc each, and the host IO runtime (host_io.cpp, the
                host C++ compiler), all started together.
  2. kernel   — each kernel against its plain PyTorch version and against f64
                at its main-path shape (int8 X of the north star,
                M = 1,048,576 x N = 10,240, and packed int4 X of
                M = 2,097,152 x N = 10,240, both made on the card from a
                seed) and at ragged shapes (the two X Ys kernels at K = 1,
                2, 3, 8 with M not a multiple of the rows per warp and M
                below it); bitwise repeatability; kernel and plain timed
                with CUDA events in turns, beside the kernel's bound; the
                three bf16 kernels likewise on bf16 X of the north-star
                shape (20 GiB, freed after) and at ragged shapes, each
                beside cuBLAS's X @ V.to(bfloat16), a rounder function
                (logged; not their library yardstick); the int8 and packed
                kernels also on a rank's slab cut as a view X[333:1000] of
                a larger X (rows off a 16-byte boundary, N % 16 != 0).
  2b. probe   — the five probe kernels (read floor, tensor cores) against
                their plain versions and f64 at full and ragged shapes on the
                same X, then the two measurement tools' entry functions at
                full shape (vampomi_tpu_torch/tools: matvec_floor_probe on
                the int8 X, r4_probe on it and the first 1,048,576 rows of
                the packed X), with launch counts; prints each tool's JSON
                summary line; the read-floor sums beside torch's own int32
                sums (their library yardstick), in turns.
                row_moments_int8 on rows past the int32 range of a sum of
                squares (N = 262,144 and a ragged 262,147), bitwise against
                its plain version and the exact integers.
  2c. gram    — the Gram on the tensor cores (ops/gram_tc.py) for int8,
                packed int4 and bf16 designs at M = 131,072 x N = 10,240
                and a ragged 20,000 x 1,000: G and t within 1e-5 of the
                largest of its plain version's, two launches a block of
                16,384 rows, its K error against an f64 K at most 2x today's
                f32 route's and 10x below the single-bf16 route's, G
                exactly symmetric and bitwise repeatable; at N = 10,240
                timed in turns with today's torch.matmul route (its
                yardstick) beside its bound; then an eigen cache written
                from today's K must load against its K.  Every exact run of
                the later phases counts its launches exactly.
  3. parity   — infere_linear and infere_bin_class (probit) on the card
                against the same port on the CPU at M = 16,384 x N = 2,048
                (data_sim; 0/1 labels for probit), int8 and int4: eigen and
                spectral for 3 iterations, cg for 2 (the depth where card
                and CPU first part), the same p1 and probes; then C = 2
                covariates, once for each model (int8); then linear on the
                bf16 design.
  4. cli      — the CLI through files (N = 2,000 x M = 8,000), int8 and
                int4, with eigen, spectral and cg (every output file must
                exist, be finite, and the x1 correlation must rise); then
                test, association_test (se, loo, loo_std) and predict on the
                eigen run's dumps; then --model bin_class (int8 with each
                solver, one of them with --C 2 --cov-file, and int4 eigen),
                linear with --C 2, and test, predict and association_test
                with --model bin_class on the probit eigen run's dumps.
  4b. resume  — exact-state resume through the CLI at N = 2,000 x M = 8,000
                (int8): linear with eigen, spectral and cg, probit with
                eigen and cg; 8 iterations straight with --checkpoint-file
                against 4 and --resume-file to 8: the CSVs and the dumps of
                iterations 5-8 byte-identical (a file that is not is named
                and held to rtol 1e-6).
  5. main     — the int8 main path at the north-star shape: a planted design
                (1,024 causal markers, h2 = 0.8, prior fixed at the truth),
                every run with --eigen-cache: 4 iterations of
                --lmmse-solver auto on the cold cache (which must resolve
                to spectral there), 5 eigen iterations (which build the
                factor and write the cache file, its write timed), 4 of auto
                with the cache warm (which must log its upgrade to eigen,
                load the file, and repeat the eigen run's iterations byte
                for byte) and 2 CG iterations (CG's A^T pass through
                atx_batch_int8), each with the per-iteration outputs on and
                then off; then eigen with --checkpoint-file against without
                (a checkpoint's cost an iteration); prints setup and
                per-iteration seconds, peak memory and kernel launches, and
                checks the launches of every run exactly (setup's A^T y,
                the passes of each iteration and CG step); then the
                spectral dense step timed alone by route.
  5b. modes   — the run modes at full width on that design and its dumps:
                row_moments_int8 against its plain version (bitwise, timed);
                SE, LOO and loo_std p-values, the LOO statistics of 4,096
                rows against f64 on the host; test mode over the 5 eigen
                estimates in one pass; predict; with launch counts.
  5c. probit  — probit GLM-VAMP on the same design: 0/1 labels
                y = 1[A beta sqrt(N) + N(0, 1) > 0] of the planted effects,
                the prior started at the truth with its variances fixed;
                4 iterations of --lmmse-solver auto (spectral there), 4 of
                eigen and 2 of CG (capped at 50 steps), each with the outputs
                on and then off; setup and per-iteration seconds, peak
                memory, acc1/acc2, x1 correlation and launches, checked
                exactly from the launch counts (exact solvers: atx_int8 2 and
                ax_batch_int8 1 an iteration; CG: atx_batch_int8 once a CG
                step and once for the initial residual).
  6. int4     — phases 5 (eigen and CG) and 5b at M = 2,097,152 x
                N = 10,240 on a planted packed design (2,048 causal markers:
                the same density), after the int8 X is freed.
  7. gibbs    — the Gibbs warm start (vampomi_tpu_torch/gibbs): after the CLI
                phases, card against CPU at M = 16,384 x N = 2,048 for int8,
                int4 and bf16 (the block Grams bitwise; bf16's, f32 products
                of the upcast values, to f32 rounding; then 3 sweeps, each
                from the card's state with the same draws) and the workflow
                through files at N = 2,000 x M = 8,000 (the Gibbs CLI, 40
                sweeps; conf_gibbs_init; pip; the CLI's eigen run from the
                .conf); after phase 5c, gibbs_block_update against its plain
                version on two blocks of the int8 north-star design and at
                ragged B and L (the tails of its sub-blocks of 32 markers, L
                past a warp's lanes; timed in turns at block 0, with the
                host's time a call) and, with
                --gibbs-reference CU (an earlier gibbs_block.cu), bitwise
                against that kernel and timed against it in turns; then
                run_gibbs at full width on that design (4,096 blocks of 256,
                3 sweeps), after phase 6 on the packed one (8,192 blocks, 2
                sweeps) and after phase 8 on the bf16 one (4,096 blocks, 2
                sweeps: atx_bf16 and ax_batch_bf16 at a block's shape):
                Gram build and sweep seconds, peak
                memory, h2 and m_incl per sweep, launches checked exactly
                (nb kernel launches and nb passes each way a sweep), one
                more sweep's host enqueue time against its wall, the host
                syncs of one sweep.
  8. bf16     — after the packed X is freed, the bf16 main path: the design
                built on the card from seeded uniform values (f64 statistics
                of the raw values, chunk by chunk; 20 GiB of bf16 X), 4
                eigen, 4 auto (spectral) and 2 CG iterations with the
                outputs on and off, launches checked exactly per run; then
                SE, LOO, loo_std, test and predict on its dumps; then phase
                7's full-width bf16 sweeps on this design.
  9. doctor   — python -m vampomi_tpu_torch.doctor in a subprocess: exit 0.
  10. ranks   — the markers split over torch.distributed ranks
                (vampomi_tpu_torch/sharding.py), in subprocesses of this
                script (--ranks-worker) and of the CLI: (a) the int8 north
                star, its design made on the card chunk by chunk (65,536
                rows a seed, so a rank makes only its own rows), the planted
                y, beta, probit labels 1[sqrt(N) A beta + N(0, 1) > 0] and
                prior made once and passed through a file; 4 eigen
                iterations with --eigen-cache (rank 0 writes it), 4 of auto
                with it warm (every rank on the loaded factor), 2 spectral,
                2 CG (50 steps at most); probit 4 eigen iterations on the
                warm cache and 2 CG; the run modes on the one-process eigen
                run's dumps of iteration 4 (SE, LOO, loo_std, test over its
                4 estimates in one pass, predict).  All of it as one process
                without a group, which then joins a process group of its
                own as one NCCL rank (world size 1) and runs eigen, CG,
                probit and the modes again on the same design: every CSV,
                dump and mode file byte for byte the group-less run's; and
                as two gloo ranks sharing the card (524,288 markers, 5 GiB
                of X each): gamw, gam1, tau1 and the eigenvalue sums bitwise
                equal across the ranks, the dumps within rtol 1e-4 and atol
                2e-6 (CG 1e-3) of one process, probit's confusion counts
                within 3, the SE p-values byte-identical, LOO and loo_std
                -log10 p, the test CSV and .yhat within rtol 1e-4; every
                rank's launches and collectives exact per iteration and per
                mode; each dump's largest difference as a share of its
                bar; one (N, 2) all_reduce timed under gloo and NCCL, the
                wall an iteration (linear and probit), each mode's seconds
                and the peak memory a rank; the bytes of U each process
                and rank holds and its torch.cuda.memory_allocated right
                after the eigen run's setup.  (b) the CLI under python -m
                torch.distributed.run with 3 ranks at N = 2,000 x
                Mt = 8,002 (ragged slabs), each command once: linear int8
                and int4 with eigen and CG, --model bin_class int8 with
                eigen and CG and int4 with eigen, every dump full length
                and within rtol of the one-process CLI (probit counts within
                3); each model's 3-rank checkpoint at iteration 4 resumed to
                8 by 3 ranks (CSVs and dumps byte-identical to the straight
                run) and by one process (within rtol); test,
                association_test (se, loo, loo_std) and predict on the
                one-process linear eigen run's dumps and test and predict
                with --model bin_class on the probit one's (these seven in
                one launch, each through the CLI's parse_config and run-mode
                dispatch in one process group: a launch costs more than the
                commands), against the same commands in one process (the
                bars of (a)); --profile-dir over 3 ranks (a Chrome trace a
                rank; the dumps byte for byte the run's without it); in
                the run modes' launch, api.py with shard="auto" over the 3
                ranks (fit_linear and fit_probit with eigen,
                association_pvals, predict_probit) within rtol 1e-4 of the
                one-process CLI's dumps, SE p-values and probit scores.
                Prints the walls of its two waves of launches and the
                {"ranks": {...}} line.
  11. files   — after phase 9, the user's workflow through real files: (a)
                an f64 .bin of N = 10,240 x M = 262,144 (20 GiB, a quarter
                of the north star's markers; M halved while the disk with
                the most free space holds less than 25 GiB) written chunk by
                chunk from per-chunk seeds (methylation-like values in
                [0, 1], each marker in its own range), its .phen and true
                signal planted as phase 5 plants them; the CLI's int8 eigen
                run (4 iterations, dumps on), test on the same file and
                association_test --pval-method se, in one process
                through cli.main (--files-worker), its own peak RSS under
                8 GiB; the CLI's design on three slabs bitwise
                build_design's; launches exact; scripts.p_vals' file the
                SE mode's bytes; the ingest's rate beside the plain numpy
                reader's on one chunk, and on a 1 GiB slab at 1 to 8
                ingest threads; an M-vector dump's write by the runtime
                against a bytes copy and os.pwrite; the int8 codes the
                fused f32 ingest would change on one slab; (b) two per-chromosome zarr
                stores of 2,000 x 4,096 (zlib, blosc-lz4) through
                python -m vampomi_tpu_torch.sim.sim_top_iid (its train .bin
                the stores' rows), the CLI on its train split and test on
                its test split; (c) --profile-dir on phase 4's int8 eigen
                run in a subprocess with a deadline: the trace parses and
                names the atx_int8 and int8 xtw kernels, as many of each
                as an exact run launches, the outputs byte for byte the
                run's without the flag, the card's busy share of the
                profiled run.  Prints the {"files": {...}} line.

Before the ranks line, a line "[timing] {...}" gives each phase's wall
seconds (a phase run in several parts, such as 7, summed) and the total.
The line before the last is the kernel record {"kernels": [...]}: eighteen
kernels standing for the twelve TPU kernels of the repo, the int8 einsum
of CG's A^T pass, the LOO pass's row reductions, the Gibbs sampler's
block update, the bf16 design's three einsums and the Gram, each with its bound
(the larger of its bytes over 3.35 TB/s and its operations over the peak
rate of their type, from this run's shapes) and its one-call PyTorch
yardstick where one exists; the last line is {"ok": true, "device":
{...}}.  The engine's own per-iteration narration goes to log files in
--log-dir when given; outputs and (by default) logs go to a temporary
directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from typing import Callable, NamedTuple
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from vampomi_tpu_torch import cli  # noqa: E402
from vampomi_tpu_torch.config import RunConfig, resolve_device  # noqa: E402
from vampomi_tpu_torch.dataset import Dataset  # noqa: E402
from vampomi_tpu_torch.engine import linear as linear_engine  # noqa: E402
from vampomi_tpu_torch.engine.linear import infere_linear  # noqa: E402
from vampomi_tpu_torch.engine.probit import infere_bin_class  # noqa: E402
from vampomi_tpu_torch.gibbs import __main__ as gibbs_cli  # noqa: E402
from vampomi_tpu_torch.gibbs import sampler as gibbs  # noqa: E402
from vampomi_tpu_torch.gibbs.runner import run_gibbs  # noqa: E402
from vampomi_tpu_torch.io.bin_io import read_bin_slab  # noqa: E402
from vampomi_tpu_torch.io.csv_writer import read_positional_csv  # noqa: E402
from vampomi_tpu_torch.io.phen import Phenotype  # noqa: E402
from vampomi_tpu_torch.modes import association, predict, test_mode  # noqa: E402
from vampomi_tpu_torch.ops import _build  # noqa: E402
from vampomi_tpu_torch.engine.checkpoint import load_checkpoint  # noqa: E402
from vampomi_tpu_torch.ops.atx_int8 import (  # noqa: E402
    atx_batch_int8, atx_batch_int8_plain, atx_int8, atx_int8_plain,
)
from vampomi_tpu_torch.ops.bf16 import (  # noqa: E402
    atx_batch_bf16, atx_batch_bf16_plain, atx_bf16, atx_bf16_plain, ax_batch_bf16,
    ax_batch_bf16_plain,
)
from vampomi_tpu_torch.ops.broadcast import (  # noqa: E402
    ax_batch_int8, ax_batch_int8_plain, ax_batch_packed4, ax_batch_packed4_plain,
)
from vampomi_tpu_torch.ops.gibbs_block import (  # noqa: E402
    SMEM_BYTES, gibbs_block_update, gibbs_block_update_plain,
)
from vampomi_tpu_torch.ops.moments import (  # noqa: E402
    row_moments_int8, row_moments_int8_plain, row_moments_packed4, row_moments_packed4_plain,
)
from vampomi_tpu_torch.ops.mxu import (  # noqa: E402
    atx_mxu, atx_mxu_plain, ax2_packed4_mxu, ax2_packed4_mxu_plain, ax_mxu, ax_mxu_plain,
    bf16_round,
)
from vampomi_tpu_torch.ops.operator import (  # noqa: E402
    PACKED4_DTYPE, QUANTIZED, atx, ax, ax_batch, build_design, design_from_codes,
    design_from_packed, design_from_raw_rows,
)
from vampomi_tpu_torch.ops.packed4 import (  # noqa: E402
    atx_batch_packed4, atx_batch_packed4_plain, atx_packed4, atx_packed4_plain,
)
from vampomi_tpu_torch.ops import gram_tc, spectral  # noqa: E402
from vampomi_tpu_torch.ops.eigen import build_eigen_cached  # noqa: E402
from vampomi_tpu_torch.ops.spectral import build_spectral, shift_inverse  # noqa: E402
from vampomi_tpu_torch.ops.stream import (  # noqa: E402
    stream_rowsum, stream_rowsum_plain, stream_sum, stream_sum_plain,
)
from vampomi_tpu_torch.scripts import conf_gibbs_init, pip  # noqa: E402
from vampomi_tpu_torch.sim.data_sim import simulate_iid, write_fixture  # noqa: E402
from vampomi_tpu_torch.tools import (  # noqa: E402
    BF16_FLOPS, F32_FLOPS, KERNEL_CALLS, KERNEL_TOL, bound_ms, card_info, card_ms, codes64,
    exact_and_scale, in_turns, matvec_bound, random_codes, rel_err,
)
from vampomi_tpu_torch.tools import dense_step_probe, matvec_floor_probe, r4_probe  # noqa: E402
from vampomi_tpu_torch.utils.mathx import normal_cdf  # noqa: E402

NS_M, NS_N = 1_048_576, 10_240          # the north-star shape (README.md, bench.py)
I4_M = 2_097_152                        # the int4 configuration: twice the markers
SEED = 20261016
# kernel vs plain / f64: KERNEL_TOL of sum|x||v| (vampomi_tpu_torch/tools
# gives its reason)
# card against CPU, both f32 with the same probes: sums in another order.
# eigen and spectral are exact per iteration (1e-4 leaves room for 4
# iterations of amplification; spectral's f32 Cholesky of S = gam2 I + gamw K
# is well conditioned at M/N = 8, where K's eigenvalues span a factor ~4);
# CG stops at rel-residual 1e-5 and may stop one step apart, which the
# Hutchinson alpha2 and gamw carry (1e-3).
PARITY_RTOL = {"eigen": 1e-4, "spectral": 1e-4, "cg": 1e-3}
PARITY_ATOL = 1e-5  # metrics that start at 0 at the cold start
# the parity phase's depth: the trajectories still move at iteration 3
# (eigen, spectral) and 2 (CG), where the card and the CPU first part
PARITY_ITERS = {"eigen": 3, "spectral": 3, "cg": 2}
PRIOR3 = dict(probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], h2=0.8)
PROBIT = dict(probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], rho=0.3, gam1=1e-2)
# probit labels are thresholds of z: a sample whose z lies within the f32
# rounding of 0 may take the other label on the card, so the confusion
# counts agree to a few samples, not to rtol
PARITY_LABELS = 3
# the least x1 correlation the int4 main path must reach: the JAX int4
# engine on down-scaled copies of its planted problem (M/N = 204, one causal
# marker per 1,024, prior fixed at the truth) peaks at 0.367 (CG, 2
# iterations) and 0.413 (eigen, 5) at N = 256, and 0.387 and 0.568 at
# N = 512 (PERF.md); the port on the CPU matches it to 1e-3 (eigen) and
# within the spread of the CG probes.
X1_MIN_INT4 = 0.3
DTYPES = {"int8": torch.int8, "int4": PACKED4_DTYPE}
PARITY_DTYPES = {**DTYPES, "bf16": torch.bfloat16}


class Kernel(NamedTuple):
    fn: Callable            # the wrapper (counts its launches)
    plain: Callable         # its plain PyTorch version
    source: str             # the CUDA source it is built from
    replaces: str           # the TPU kernels it stands for, "file:line; ..."
    kind: str               # "vec": X y; "rows": X Ys; "cols": X^T W; "stream"; "moments";
    #                         "gibbs": the sequential block update; "gram": X^T diag(w2) X
    bf16: bool = False      # the vector is rounded to bf16 (tensor cores)
    library: Callable | None = None  # one PyTorch call computing the same, if any


CSRC = "vampomi_tpu_torch/csrc/"
# every kernel of the port, each with the TPU kernels it replaces (#9 and #11
# are the r4 probe's prototypes of #1 and #2: the same functions;
# atx_batch_int8 replaces an XLA einsum).  Only the read-floor sums have a
# one-call PyTorch yardstick: no single call multiplies int8 or packed
# nibbles by f32 (torch._int_mm needs int8 on both sides; X.float() @ y is
# two calls and a 40 GiB copy)
KERNELS = {
    "atx_int8": Kernel(atx_int8, atx_int8_plain, CSRC + "atx_int8.cu",
                       "vampomi_tpu/ops/pallas_matvec.py:55; tools/r4_probe.py:52", "vec"),
    "ax_batch_int8": Kernel(ax_batch_int8, ax_batch_int8_plain, CSRC + "ax_batch_int8.cu",
                            "tools/r4_probe.py:77", "cols"),
    "atx_packed4": Kernel(atx_packed4, atx_packed4_plain, CSRC + "atx_packed4.cu",
                          "vampomi_tpu/ops/pallas_matvec.py:89; tools/r4_probe.py:109", "vec"),
    "ax_batch_packed4": Kernel(ax_batch_packed4, ax_batch_packed4_plain,
                               CSRC + "ax_batch_packed4.cu",
                               "vampomi_tpu/ops/pallas_matvec.py:127", "cols"),
    "atx_batch_packed4": Kernel(atx_batch_packed4, atx_batch_packed4_plain,
                                CSRC + "atx_batch_packed4.cu",
                                "vampomi_tpu/ops/pallas_matvec.py:183", "rows"),
    "atx_batch_int8": Kernel(atx_batch_int8, atx_batch_int8_plain, CSRC + "atx_batch_int8.cu",
                             "vampomi_tpu/ops/operator.py:334 (XLA einsum, no Pallas kernel)",
                             "rows"),
    "stream_sum": Kernel(stream_sum, stream_sum_plain, CSRC + "stream.cu",
                         "tools/matvec_floor_probe.py:83", "stream",
                         library=lambda X: torch.sum(X, dtype=torch.int32)),
    "stream_rowsum": Kernel(stream_rowsum, stream_rowsum_plain, CSRC + "stream.cu",
                            "tools/matvec_floor_probe.py:112", "stream",
                            library=lambda X: X.sum(dim=1, dtype=torch.int32)),
    "atx_mxu": Kernel(atx_mxu, atx_mxu_plain, CSRC + "atx_mxu.cu",
                      "tools/matvec_floor_probe.py:135", "vec", bf16=True),
    "ax_mxu": Kernel(ax_mxu, ax_mxu_plain, CSRC + "ax_mxu.cu",
                     "tools/matvec_floor_probe.py:168", "cols", bf16=True),
    "ax2_packed4_mxu": Kernel(ax2_packed4_mxu, ax2_packed4_mxu_plain, CSRC + "ax2_packed4_mxu.cu",
                              "tools/r4_probe.py:139", "cols", bf16=True),
    # the LOO pass's per-row code sums: XLA reductions fused into the read of
    # X in JAX, no Pallas kernel; no single PyTorch call gives both sums
    "row_moments_int8": Kernel(row_moments_int8, row_moments_int8_plain,
                               CSRC + "row_moments.cu",
                               "vampomi_tpu/modes/association.py:98 (XLA reductions, no "
                               "Pallas kernel)", "moments"),
    "row_moments_packed4": Kernel(row_moments_packed4, row_moments_packed4_plain,
                                  CSRC + "row_moments.cu",
                                  "vampomi_tpu/modes/association.py:78 (XLA reductions, no "
                                  "Pallas kernel)", "moments"),
    # the Gibbs sampler's B dependent marker steps of a block: no PyTorch
    # call does a sequential categorical scan
    "gibbs_block_update": Kernel(gibbs_block_update, gibbs_block_update_plain,
                                 CSRC + "gibbs_block.cu",
                                 "vampomi_tpu/gibbs/sampler.py:128 (XLA fori_loop, no Pallas "
                                 "kernel)", "gibbs"),
    # the bf16 design's passes: XLA einsums in JAX, no Pallas kernel; no
    # PyTorch call computes them (a bf16 matmul rounds the vector and the
    # output, BF16_ROUNDER below)
    "atx_bf16": Kernel(atx_bf16, atx_bf16_plain, CSRC + "atx_bf16.cu",
                       "vampomi_tpu/ops/operator.py:261 (XLA einsum, no Pallas kernel)", "vec"),
    "atx_batch_bf16": Kernel(atx_batch_bf16, atx_batch_bf16_plain, CSRC + "atx_batch_bf16.cu",
                             "vampomi_tpu/ops/operator.py:334 (XLA einsum, no Pallas kernel)",
                             "rows"),
    "ax_batch_bf16": Kernel(ax_batch_bf16, ax_batch_bf16_plain, CSRC + "ax_batch_bf16.cu",
                            "vampomi_tpu/ops/operator.py:186 (XLA einsum, no Pallas kernel)",
                            "cols"),
    # the Gram of eigen and spectral: an XLA dot in JAX, no Pallas kernel;
    # no PyTorch call computes it (phase 2c times it beside today's f32
    # route, gram_blocks: torch.matmul over upcast blocks)
    "gram_tc": Kernel(gram_tc.gram_tc, gram_tc.gram_tc_plain, CSRC + "gram_tc.cu",
                      "vampomi_tpu/ops/spectral.py:111-133 (XLA dot, no Pallas kernel)", "gram",
                      bf16=True),
}
# one cuBLAS call beside each bf16 kernel, timed and logged but not its
# library yardstick: X @ V.to(bfloat16) rounds V and the output to bf16, a
# rounder function than the kernel's
BF16_ROUNDER = {
    "atx_bf16": lambda X, v: X @ v.to(torch.bfloat16),
    "atx_batch_bf16": lambda X, V: X @ V.to(torch.bfloat16),
    "ax_batch_bf16": lambda X, W: X.T @ W.to(torch.bfloat16),
}
LIBRARIES = list(dict.fromkeys(os.path.basename(k.source)[:-3] for k in KERNELS.values()))


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


def launches() -> dict:
    return {name: k.fn.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.fn.launches = 0


def bound(name: str, X: torch.Tensor, k: int) -> tuple[float, str]:
    """The least milliseconds the card could take for one call of kernel
    `name` on X with k right-hand sides, and what sets it (tools.bound_ms):
    the matvecs at 2 operations per code and right-hand side, at the f32
    rate of the CUDA cores or the bf16 rate of the tensor cores; the
    read-floor sums at one add per byte, counted at the f32 rate, with X and
    their int32 sums crossing HBM once; the row moments at three operations
    per code (an add for the sum, a multiply and an add for the squares) at
    the f32 rate, with X and two int64 a row crossing HBM once."""
    kn = KERNELS[name]
    if kn.kind == "gibbs":  # X is the (B, B) f32 Gram, k the mixture size L
        b = X.shape[0]
        return bound_ms(4 * b * b + 4 * 7 * b + 16 * k + 16, 2 * b * b)
    if kn.kind == "moments":
        codes = X.numel() * (2 if X.dtype == PACKED4_DTYPE else 1)
        return bound_ms(X.numel() + 16 * X.shape[0], 3 * codes)
    if kn.kind != "stream":
        return matvec_bound(X, k, kn.kind == "cols", BF16_FLOPS if kn.bf16 else F32_FLOPS)
    out = 4 * X.shape[0] if name == "stream_rowsum" else 4
    return bound_ms(X.numel() + out, X.numel())


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
    """The kernel libraries (nvcc) and the host IO runtime (the host C++
    compiler, csrc/host_io.cpp), one compiler process each, all at once."""
    t0 = time.perf_counter()
    _build.build_all(LIBRARIES + ["host_io"])
    each = ", ".join(f"{n} {s:.1f}s" for n, s in _build.BUILD_SECONDS.items())
    log(f"[build] {len(LIBRARIES)} kernel libraries and the host IO runtime from "
        f"vampomi_tpu_torch/csrc in {time.perf_counter() - t0:.2f}s, in parallel (each "
        f"compiler until seen done: {each})")


def check_kernel(name: str, X: torch.Tensor, V: torch.Tensor, timed: bool) -> dict:
    """One kernel against its plain version and the exact f64 product on
    the same inputs (errors relative to sum |x||v|; the tensor-core kernels
    against the product with V rounded to bf16), bitwise repeatability,
    and, when timed, kernel and plain by CUDA events in turns (plain,
    kernel, kernel, plain).  V is (rows, K); "vec" kernels take V[:, 0]."""
    k = KERNELS[name]
    kern, plain = k.fn, k.plain
    run = (lambda f: f(X, V[:, 0].contiguous())[:, None]) if k.kind == "vec" else \
        (lambda f: f(X, V))
    got = run(kern)
    want = run(plain)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    ex, sc = exact_and_scale(X, bf16_round(V) if k.bf16 else V, k.kind == "cols")
    err_plain = rel_err(got, want, sc)
    err_ref = rel_err(got, ex, sc)
    max_abs = float((got - want).abs().max())
    shape = f"X {tuple(X.shape)} {str(X.dtype).replace('torch.', '')}, K={V.shape[1]}"
    log(f"[kernel] {name} {shape}: max rel err vs plain {err_plain:.3e}, vs f64 "
        f"{err_ref:.3e} (tolerance {KERNEL_TOL:g} of sum|x||v|); max abs diff vs plain "
        f"{max_abs:.4g}")
    check(err_plain < KERNEL_TOL and err_ref < KERNEL_TOL, f"{name} disagrees at {shape}")
    check(torch.equal(got, run(kern)), f"{name} not bitwise repeatable at {shape}")
    rec = dict(max_abs_err=max_abs)
    if timed:
        ms, plain_ms, t_kern, t_plain = in_turns(lambda: run(kern), lambda: run(plain))
        gb = X.numel() * X.element_size() / 1e9
        least_ms, least_by = bound(name, X, V.shape[1])
        log(f"[kernel] {name} {shape}: {ms:.3f} ms ({gb / ms * 1e3:.1f} GB/s of X; bound "
            f"{least_ms:.3f} ms by {least_by}, {100 * least_ms / ms:.1f}% of it); plain "
            f"{plain_ms:.3f} ms ({gb / plain_ms * 1e3:.1f} GB/s); medians of 7 samples of "
            f"{KERNEL_CALLS} calls (kernel) and 5 calls (plain) after warm-up, runs {t_kern} / "
            f"{t_plain}")
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=least_ms, bound_by=least_by,
                   library_ms=None)
        if name in BF16_ROUNDER:
            rounder = BF16_ROUNDER[name]
            Vr = V[:, 0].contiguous() if k.kind == "vec" else V
            r_ms = card_ms(lambda: rounder(X, Vr), calls=KERNEL_CALLS)
            log(f"[kernel] {name} {shape}: cuBLAS X @ V.to(bfloat16) {r_ms:.3f} ms (not the "
                f"same function: it rounds V and the output to bf16; library_ms stays null)")
    return rec


def phase_kernel(dev: str) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Every kernel at its main-path shapes (timed at the K the eigen
    iteration uses) and at a ragged one.  Returns the int8 and packed X and
    {name: record}."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)

    def rhs(rows, k):
        return torch.randn((rows, k), device=dev, generator=g)

    X8 = random_codes(NS_M, NS_N, torch.int8, SEED, dev)
    X4 = random_codes(I4_M, NS_N // 2, PACKED4_DTYPE, SEED + 2, dev)
    plan = [  # (name, X, rows of V, K values; the last K is timed)
        ("atx_int8", X8, NS_N, [1]),
        ("ax_batch_int8", X8, NS_M, [1, 2]),
        ("atx_packed4", X4, NS_N, [1]),
        ("ax_batch_packed4", X4, I4_M, [1, 2]),
        ("atx_batch_packed4", X4, NS_N, [2]),
        ("atx_batch_int8", X8, NS_N, [2]),
    ]
    recs = {}
    for name, X, rows, ks in plan:
        for k in ks:
            r = check_kernel(name, X, rhs(rows, k), timed=True)
            if name in recs:
                r["max_abs_err"] = max(r["max_abs_err"], recs[name]["max_abs_err"])
            recs[name] = r
        torch.cuda.empty_cache()
    # ragged shapes: no 16-byte path, a partial column tile, a few splits
    for name, dtype, m, n in (("atx_int8", torch.int8, 1000, 1001),
                              ("ax_batch_int8", torch.int8, 1000, 1002),
                              ("atx_packed4", PACKED4_DTYPE, 1000, 1002),
                              ("ax_batch_packed4", PACKED4_DTYPE, 1000, 1002),
                              ("atx_batch_packed4", PACKED4_DTYPE, 1000, 1002)):
        Xr = random_codes(m, n if dtype == torch.int8 else n // 2, dtype, SEED + 3, dev)
        for k in ((1,) if name.startswith("atx_") and "batch" not in name else (1, 2, 3)):
            check_kernel(name, Xr, rhs(m if name.startswith("ax_batch") else n, k), timed=False)
    # a rank's slab cut as a view X[lo:hi] of a larger X (chip_smoke phase
    # 10, convert.design_from_arrays): an odd lo with N % 16 != 0 starts
    # its rows off a 16-byte boundary, which the kernels read a unit at a time
    for name, dtype, n in (("atx_int8", torch.int8, 1001), ("ax_batch_int8", torch.int8, 1001),
                           ("atx_batch_int8", torch.int8, 1001),
                           ("atx_packed4", PACKED4_DTYPE, 1002),
                           ("ax_batch_packed4", PACKED4_DTYPE, 1002),
                           ("atx_batch_packed4", PACKED4_DTYPE, 1002)):
        nb = n if dtype == torch.int8 else n // 2
        Xr = random_codes(1001, nb, dtype, SEED + 4, dev)[333:1000]
        check(Xr.data_ptr() % 16 != 0, f"{name}: the slab view is 16-byte aligned")
        for k in ((1,) if name in ("atx_int8", "atx_packed4") else (1, 2, 3)):
            check_kernel(name, Xr, rhs(667 if name.startswith("ax_batch") else n, k),
                         timed=False)
    # the X Ys kernels (R rows per warp): M not a multiple of R, and M below
    # R, on the byte path and on the 16-byte path; at N = 8,192, K = 8 reads
    # Ys through the read-only cache (256 KB, above the shared-memory cap)
    for name, dtype in (("atx_batch_int8", torch.int8), ("atx_batch_packed4", PACKED4_DTYPE)):
        for m, n in ((1003, 1002), (3, 1002), (1003, 8192), (3, 8192)):
            Xr = random_codes(m, n if dtype == torch.int8 else n // 2, dtype, SEED + 6, dev)
            for k in (1, 2, 3, 8):
                check_kernel(name, Xr, rhs(n, k), timed=False)
    recs.update(check_bf16_kernels(dev, rhs))
    check_long_rows(dev)
    return X8, X4, recs


def check_bf16_kernels(dev: str, rhs) -> dict:
    """The three bf16 kernels on bf16 X of the north-star shape (20 GiB,
    made on the card and freed after) at the K the main path gives each,
    timed, and at ragged shapes: N % 8 != 0 (the unit path), M not a
    multiple of the rows per warp and below it, N = 8,192 at K = 8 (Ys
    through the read-only cache)."""
    X16 = random_codes(NS_M, NS_N, torch.bfloat16, SEED + 7, dev)
    recs = {}
    for name, rows, ks in (("atx_bf16", NS_N, [1]), ("ax_batch_bf16", NS_M, [1, 2]),
                           ("atx_batch_bf16", NS_N, [2])):
        for k in ks:
            r = check_kernel(name, X16, rhs(rows, k), timed=True)
            if name in recs:
                r["max_abs_err"] = max(r["max_abs_err"], recs[name]["max_abs_err"])
            recs[name] = r
    del X16
    torch.cuda.empty_cache()
    for m, n in ((1000, 1001), (1000, 1002), (1003, 1024), (3, 1002), (1003, 8192), (3, 8192)):
        Xr = random_codes(m, n, torch.bfloat16, SEED + 8, dev)
        check_kernel("atx_bf16", Xr, rhs(n, 1), timed=False)
        for k in (1, 2, 3, 8):
            check_kernel("ax_batch_bf16", Xr, rhs(m, k), timed=False)
            check_kernel("atx_batch_bf16", Xr, rhs(n, k), timed=False)
    return recs


def check_long_rows(dev: str) -> None:
    """row_moments_int8 on rows whose sum of squares leaves int32: all codes
    -128 at N = 262,144 (Σq² = 4.29e9, the 16-byte path) and codes of
    -128 and 127 at a ragged N = 262,147 (the byte path), bitwise against
    the plain version and the exact integers, and repeatable."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    rows = {262_144: torch.full((4, 262_144), -128, dtype=torch.int8, device=dev),
            262_147: (torch.randint(0, 2, (5, 262_147), device=dev, generator=g) * 255
                      - 128).to(torch.int8)}
    for n, X in rows.items():
        got = row_moments_int8(X)
        q = X.long()
        exact = torch.stack([q.sum(dim=1), (q * q).sum(dim=1)], dim=1)
        check(got.dtype == torch.int64 and torch.equal(got, row_moments_int8_plain(X))
              and torch.equal(got, exact), f"row_moments_int8 wrong at N = {n}")
        check(torch.equal(got, row_moments_int8(X)), f"row_moments_int8 not repeatable at N = {n}")
        log(f"[kernel] row_moments_int8 X {tuple(X.shape)} int8: bitwise equal to its plain "
            f"version and the exact sums (largest sum of squares {int(got[:, 1].max())}, "
            f"int32 max {2**31 - 1})")


def check_stream(name: str, X: torch.Tensor) -> dict:
    """A read-floor kernel against its plain version: bitwise, and
    repeatable."""
    k = KERNELS[name]
    got, want = k.fn(X), k.plain(X)
    shape = f"X {tuple(X.shape)} int8"
    check(torch.equal(got, want), f"{name} differs from its plain version at {shape}")
    check(torch.equal(got, k.fn(X)), f"{name} not bitwise repeatable at {shape}")
    log(f"[probe] {name} {shape}: bitwise equal to its plain version and repeatable")
    return dict(max_abs_err=float((got.long() - want.long()).abs().max()))


# the probe kernels: each must launch on the probe path
PROBE_KERNELS = ("stream_sum", "stream_rowsum", "atx_mxu", "ax_mxu", "ax2_packed4_mxu")


def phase_probe(dev: str, X8: torch.Tensor, X4: torch.Tensor) -> tuple[dict, dict]:
    """The probe kernels at full shape (the int8 X and the first 1,048,576
    rows of the packed X: the tools' own shapes) and at ragged ones, then
    the two tools' entry functions on the same X with the launch counts set
    to 0 just before and read just after.  Returns {name: record} with the
    tools' times in turns with the plain versions, and the counts."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    X4r = X4[:NS_M]  # a row view: no new memory
    recs = {}

    def keep(name, r):
        if name in recs:
            r["max_abs_err"] = max(r["max_abs_err"], recs[name]["max_abs_err"])
        recs[name] = r

    for name in ("stream_sum", "stream_rowsum"):
        keep(name, check_stream(name, X8))
        keep(name, check_stream(name, random_codes(1000, 1001, torch.int8, SEED + 3, dev)))
        # a view one row in: not 16-byte aligned, so the byte-per-lane path
        keep(name, check_stream(name, random_codes(1001, 1001, torch.int8, SEED + 5, dev)[1:]))
    plan = [("atx_mxu", X8, NS_N, [1]), ("ax_mxu", X8, NS_M, [1, 2]),
            ("ax2_packed4_mxu", X4r, NS_M, [1, 2])]
    for name, X, rows, ks in plan:
        for k in ks:
            keep(name, check_kernel(name, X, torch.randn((rows, k), device=dev, generator=g),
                                    timed=False))
    for name, dtype, m, n in (("atx_mxu", torch.int8, 1000, 1001),
                              ("ax_mxu", torch.int8, 1000, 1002),
                              ("ax2_packed4_mxu", PACKED4_DTYPE, 1000, 1002)):
        Xr = random_codes(m, n if dtype == torch.int8 else n // 2, dtype, SEED + 3, dev)
        for k in ((1,) if name == "atx_mxu" else (1, 2, 3)):
            V = torch.randn((n if name == "atx_mxu" else m, k), device=dev, generator=g)
            keep(name, check_kernel(name, Xr, V, timed=False))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_launches()
    floor = matvec_floor_probe.probe(X8, SEED)
    r4 = r4_probe.probe(X8, X4r, SEED)
    torch.cuda.synchronize()
    counts = launches()
    log(json.dumps(floor))
    log(json.dumps(r4))
    log(f"[probe] both tools at full shape in {time.perf_counter() - t0:.1f}s: read floor "
        f"{floor['read_floor_gbps']:.1f} GB/s of X; kernel launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    timed = {**floor["results"], **r4["results"]}
    shapes = {"stream_sum": (X8, 1), "stream_rowsum": (X8, 1), "atx_mxu": (X8, 1),
              "ax_mxu": (X8, 1), "ax2_packed4_mxu": (X4r, 2)}  # as the tools time them
    for name in PROBE_KERNELS:
        X, k = shapes[name]
        least_ms, least_by = bound(name, X, k)
        recs[name].update(ms=timed[name]["ms"], plain_ms=timed[name]["plain_ms"],
                          bound_ms=least_ms, bound_by=least_by, library_ms=None)
    # the read-floor sums against torch's own int32 sums of the same X, in
    # turns (library, kernel, kernel, library), both 5 calls a sample
    for name in ("stream_sum", "stream_rowsum"):
        kn = KERNELS[name]
        ms, lib_ms, _, _ = in_turns(lambda: kn.fn(X8), lambda: kn.library(X8),
                                    plain_calls=KERNEL_CALLS)
        check(torch.equal(kn.library(X8).flatten(), kn.plain(X8).flatten()),
              f"{name}: library call disagrees")
        recs[name]["library_ms"] = lib_ms
        log(f"[probe] {name}: {ms:.3f} ms beside torch's one-call int32 sum {lib_ms:.3f} ms "
            f"(in turns; the tool's time {recs[name]['ms']:.3f} ms is the record)")
    return recs, {name: counts[name] for name in PROBE_KERNELS}


# The Gram on the tensor cores (ops/gram_tc.py): each design kind at
# M x N, the north-star width and a ragged one (N not a multiple of the
# 128-wide tile, M not one of the 16,384-row block); against its plain
# version to GRAM_VS_PLAIN of the largest |G| and |t|; its K error against
# an f64 K at most GRAM_VS_F32 times that of today's f32 route
# (gram_tc.gram_blocks) and GRAM_VS_BF16 times below that of the JAX
# package's single-bf16 route
GRAM_SHAPES = ((131_072, 10_240), (20_000, 1_000))
GRAM_VS_PLAIN, GRAM_VS_F32, GRAM_VS_BF16 = 1e-5, 2.0, 10.0
GRAM_BLOCK = 16_384  # rows of a block of spectral.gram's (two launches each)


def gram_launches(solver: str, rows: int) -> dict:
    """The Gram kernel's launches of one run on `rows` rows of X: an exact
    solver builds K once (a loaded eigen cache too: its fingerprint reads
    K), two launches a block; CG none."""
    return {} if solver == "cg" else {"gram_tc": 2 * -(-rows // GRAM_BLOCK)}


def gram_design(kind: str, m: int, n: int, dev: str):
    """m x n random int8 codes, packed nibbles or bf16 normal values made on
    the card, as a DesignMatrix."""
    if kind == "bf16":
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 11)
        return design_from_raw_rows(m, n, lambda lo, hi: torch.randn(
            (hi - lo, n), device=dev, generator=g), dev)
    X = random_codes(m, n // 2 if kind == "int4" else n, PARITY_DTYPES[kind], SEED + 12, dev)
    return design_from_packed(X) if kind == "int4" else design_from_codes(X)


def _k64(G: torch.Tensor, t: torch.Tensor, s2: float, n: int) -> torch.Tensor:
    """K in f64 from a route's G and t: the Gram's error alone."""
    t = t.double()
    return (G.double() - t[:, None] - t[None, :] + s2) / n


def gram_single_bf16(X: torch.Tensor, w2: torch.Tensor, n: int,
                     block: int = GRAM_BLOCK) -> torch.Tensor:
    """The JAX package's G: w2 x rounded to bf16 once, products and sums in
    f32 (vampomi_tpu/ops/spectral.py:111-133)."""
    G = torch.zeros((n, n), dtype=torch.float32, device=X.device)
    for lo in range(0, X.shape[0], block):
        Xb = gram_tc.decode(X[lo:lo + block])
        G += (w2[lo:lo + block, None] * Xb).to(torch.bfloat16).to(torch.float32).T @ Xb
    return G


def gram_bound(m: int, n: int) -> tuple[float, str]:
    """The three-piece products of the lower block triangle at the bf16 rate."""
    side = -(-n // gram_tc.TILE)
    flops = 3 * 2 * m * gram_tc.TILE ** 2 * side * (side + 1) // 2
    return bound_ms(0, flops, BF16_FLOPS)


def check_gram(kind: str, m: int, n: int, dev: str, timed: bool) -> dict:
    """gram_tc against its plain version and against an f64 G on one design,
    beside today's f32 route and the single-bf16 one; its launches, two a
    block, counted from 0; exact symmetry and bitwise repeatability; when
    timed, in turns with today's route."""
    dm = gram_design(kind, m, n, dev)
    X = dm.X
    w2 = dm.msig * dm.msig
    u = w2 * dm.mave
    s2 = float((u.double() * dm.mave.double()).sum())
    shape = f"{kind} {m} x {n}"
    reset_launches()
    G, t = gram_tc.gram_tc(X, w2, u)
    count = {name: c for name, c in launches().items() if c}
    check(count == gram_launches("eigen", m), f"gram_tc at {shape}: launches {count}, want "
                                              f"{gram_launches('eigen', m)}")
    routes = {"kernel": (G, t), "plain": gram_tc.gram_tc_plain(X, w2, u),
              "f32": gram_tc.gram_blocks(X, w2, u, n)}
    routes["bf16"] = (gram_single_bf16(X, w2, n), routes["f32"][1])
    K64 = _k64(*gram_tc.gram_blocks(X, w2.double(), u.double(), n), s2, n)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(G).all() and torch.isfinite(t).all()),
          f"gram_tc: not finite at {shape}")
    check(torch.equal(G, G.T), f"gram_tc: G not exactly symmetric at {shape}")
    scale = float(K64.abs().max())
    err, bias = {}, {}
    for name, (Gr, tr) in routes.items():
        D = _k64(Gr, tr, s2, n) - K64
        err[name] = float(D.abs().max()) / scale
        bias[name] = float((D.diagonal() / K64.diagonal()).mean())
    Gp, tp = routes["plain"]
    vs_plain = float((G - Gp).abs().max() / Gp.abs().max())
    t_vs_plain = float((t - tp).abs().max() / tp.abs().max())
    log(f"[gram] {shape}: max |K - K_f64| / max |K_f64|: kernel {err['kernel']:.3e}, plain "
        f"{err['plain']:.3e}, today's f32 route {err['f32']:.3e}, single bf16 "
        f"{err['bf16']:.3e}; G vs plain {vs_plain:.3e}, t vs plain {t_vs_plain:.3e} (of max); "
        f"the diagonal's mean relative error: kernel {bias['kernel']:.2e}, f32 route "
        f"{bias['f32']:.2e}; launches {count}")
    check(vs_plain <= GRAM_VS_PLAIN and t_vs_plain <= GRAM_VS_PLAIN,
          f"gram_tc: G or t against its plain version {vs_plain:.3e}, {t_vs_plain:.3e} of "
          f"max, above {GRAM_VS_PLAIN} at {shape}")
    check(err["kernel"] <= GRAM_VS_F32 * err["f32"],
          f"gram_tc: K error {err['kernel']:.3e} above {GRAM_VS_F32}x today's at {shape}")
    check(GRAM_VS_BF16 * err["kernel"] <= err["bf16"],
          f"gram_tc: K error {err['kernel']:.3e} not {GRAM_VS_BF16}x below single bf16's "
          f"at {shape}")
    check(torch.equal(G, gram_tc.gram_tc(X, w2, u)[0]), f"gram_tc not repeatable at {shape}")
    rec = dict(max_abs_err=float((G - Gp).abs().max()), err=err, diag_bias=bias)
    if timed:
        ms, lib_ms, t_kern, t_lib = in_turns(lambda: gram_tc.gram_tc(X, w2, u),
                                             lambda: gram_tc.gram_blocks(X, w2, u, n))
        plain_ms = card_ms(lambda: gram_tc.gram_tc_plain(X, w2, u), reps=3, warmup=1)
        least_ms, least_by = gram_bound(m, n)
        log(f"[gram] {shape}: {ms:.3f} ms (bound {least_ms:.3f} ms by {least_by}, "
            f"{100 * least_ms / ms:.1f}% of it); today's torch.matmul f32 route {lib_ms:.3f} ms "
            f"({lib_ms / ms:.2f}x); plain {plain_ms:.3f} ms; runs {t_kern} / {t_lib}")
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=least_ms, bound_by=least_by,
                   library_ms=lib_ms)
    return rec


def phase_gram(dev: str) -> dict:
    """The Gram kernel on each design kind and shape (check_gram; timed at
    the north-star width), then an eigen cache written from today's K must
    load against the kernel's K (a fingerprint hit).  The main path's
    runs count its launches (phase_main).  Returns the kernel's record: the
    int8 timing, the largest error over all cases."""
    recs = {}
    for m, n in GRAM_SHAPES:
        for kind in PARITY_DTYPES:
            recs[(kind, n)] = check_gram(kind, m, n, dev, timed=n == GRAM_SHAPES[0][1])
            torch.cuda.empty_cache()
    m, n = GRAM_SHAPES[0]
    dm = gram_design("int8", m, n, dev)
    K_old = spectral.gram(dm._replace(X=gram_tc.decode(dm.X)))  # today's route: f32 X
    K_new = spectral.gram(dm)
    with tempfile.TemporaryDirectory(prefix="vampomi_gram_") as d:
        path = os.path.join(d, "eigen.npz")
        build_eigen_cached(spectral.GramFactor(K_old), path)
        _, diag = build_eigen_cached(spectral.GramFactor(K_new), path)
    check(bool(diag.get("loaded")), "gram_tc: an eigen cache of today's K missed the new K")
    log(f"[gram] K against today's route max |diff| {float((K_new - K_old).abs().max()):.3e}; "
        f"the eigen cache written from today's K loaded against it")
    rec = dict(recs[("int8", n)])
    rec["max_abs_err"] = max(r["max_abs_err"] for r in recs.values())
    rec["err"] = {f"{kind}_{nn}": r["err"] for (kind, nn), r in recs.items()}
    rec["ms_by_kind"] = {kind: recs[(kind, n)]["ms"] for kind in PARITY_DTYPES}
    del dm, K_old, K_new
    torch.cuda.empty_cache()
    return rec


def _params_rows(d: str, name: str) -> np.ndarray:
    return np.asarray(read_positional_csv(os.path.join(d, f"{name}_params.csv")))


def parity_problem(m: int, n: int, model: str, c: int):
    """The parity phase's fixture (data_sim): the read_phen-scaled phenotype
    or, for probit, 0/1 labels y = 1[X beta + N(0, 1) > 0]; with c > 0, c
    covariates that shift it."""
    fx = simulate_iid(n=n, m=m, lam=0.1, h2=PRIOR3["h2"], seed=SEED)
    rng = np.random.default_rng(SEED + 8)
    Z = rng.normal(size=(n, c)) if c else None
    shift = Z @ np.linspace(0.6, -0.4, c) if c else 0.0
    if model == "bin_class":
        y = (fx.X @ fx.beta + shift + rng.normal(size=n) > 0).astype(np.float64)
    else:
        y = fx.y + shift
        y = y * math.sqrt((n - 1.0) / np.sum((y - y.mean()) ** 2))
    return fx, y, Z


def run_pair(devices, dtype: str, m: int, n: int, log_dir: str, out_dir: str,
             iters: dict, model: str = "linear", c: int = 0) -> dict:
    """infere_linear or infere_bin_class on each device on the same quantized
    design (the same seed, so the same p1 and probes); returns each run's
    per-iteration params + metrics rows."""
    fx, y, Z = parity_problem(m, n, model, c)
    engine, hyper = ((infere_bin_class, PROBIT) if model == "bin_class"
                     else (infere_linear, PRIOR3))
    out = {}
    for solver, k in iters.items():
        for dev in devices:
            dm = build_design(fx.X.T, compute_dtype=PARITY_DTYPES[dtype], device=dev)
            name = f"parity_{model}_{dtype}_{solver}_c{c}_{dev}"
            cfg = RunConfig(out_dir=out_dir, out_name=name, iterations=k, model=model,
                            lmmse_solver=solver, stop_criteria_thr=0.0, device=dev,
                            seed=SEED, C=c, **hyper)
            with engine_log(log_dir, name):
                res = engine(dm, y, cfg, true_signal=fx.beta, covariates=Z)
            p = _params_rows(out_dir, cfg.out_name)[:, 1:]
            out[(solver, dev)] = np.concatenate([p, np.asarray(res.metrics_history)], axis=1)
    return out


def phase_parity(dev: str, dtype: str, log_dir: str, out_dir: str, model: str = "linear",
                 c: int = 0, iters: dict | None = None, m: int = 16_384, n: int = 2_048) -> None:
    """Card against CPU.  Linear rows: 5 params, 6 metrics, each to the
    solver's rtol.  Probit rows: 8 params and the two correlations to the
    same rtol; the eight confusion counts to PARITY_LABELS samples and the
    two accuracies to PARITY_LABELS / N."""
    t0 = time.perf_counter()
    iters = iters or PARITY_ITERS
    runs = run_pair([dev, "cpu"], dtype, m, n, log_dir, out_dir, iters, model, c)
    if model == "bin_class":
        counts = [8, 9, 10, 11, 14, 15, 16, 17]  # after the 8 params
        accs, x1_col = [12, 18], 13
    else:
        counts, accs, x1_col = [], [], 6
    tag = f"{model} {dtype}" + (f", C = {c}" if c else "")
    for solver in iters:
        a, b = runs[(solver, dev)], runs[(solver, "cpu")]
        check(a.shape == b.shape and np.all(np.isfinite(a)), f"{tag} {solver}: bad shapes or values")
        cont = [j for j in range(a.shape[1]) if j not in counts + accs]
        ac, bc = a[:, cont], b[:, cont]
        err = np.abs(ac - bc) / np.maximum(np.abs(bc), PARITY_ATOL / PARITY_RTOL[solver])
        labels = np.abs(a[:, counts] - b[:, counts]).max() if counts else 0.0
        log(f"[parity] {tag} {solver} M={m} N={n}, {a.shape[0]} iterations: max rel diff card vs "
            f"cpu {err.max():.3e} (tolerance {PARITY_RTOL[solver]:g}, atol {PARITY_ATOL:g})"
            + (f", confusion counts within {labels:g} samples (tolerance {PARITY_LABELS})"
               if counts else "") + f"; x1 corr per it {np.round(a[:, x1_col], 6).tolist()}")
        check(np.all(np.abs(ac - bc) <= PARITY_RTOL[solver] * np.abs(bc) + PARITY_ATOL),
              f"{tag} {solver}: card and cpu disagree")
        check(labels <= PARITY_LABELS
              and np.all(np.abs(a[:, accs] - b[:, accs]) <= PARITY_LABELS / n + 1e-12),
              f"{tag} {solver}: card and cpu labels disagree")
    log(f"[parity] {tag} done in {time.perf_counter() - t0:.1f}s")


def phase_cli(dev: str, log_dir: str, n: int = 2_000, m: int = 8_000, iters: int = 8) -> None:
    with tempfile.TemporaryDirectory(prefix="vampomi_cli_") as d:
        fx = simulate_iid(n=n, m=m, lam=0.1, h2=0.8, seed=SEED)
        paths = write_fixture(fx, d, "ex")
        log(f"[cli] fixture N={n} M={m}: {os.path.getsize(paths['bin'])} bytes of .bin")
        for dtype in DTYPES:
            for solver in ("eigen", "spectral", "cg"):
                out = f"run_{dtype}_{solver}"
                argv = ["--run-mode", "infere", "--model", "linear",
                        "--meth-file", paths["bin"], "--phen-file", paths["phen"],
                        "--true-signal-file", paths["ts"], "--N", str(n), "--Mt", str(m),
                        "--out-dir", d, "--out-name", out, "--iterations", str(iters),
                        "--stop-criteria-thr", "0", "--h2", "0.8", "--probs", "0.9,0.07,0.03",
                        "--vars", "0.0,0.001,0.01", "--device", dev,
                        "--compute-dtype", dtype, "--lmmse-solver", solver]
                t0 = time.perf_counter()
                with engine_log(log_dir, f"cli_{dtype}_{solver}"):
                    check(cli.main(argv) == 0, f"cli {dtype} {solver} returned non-zero")
                took = time.perf_counter() - t0
                want = {f"{out}_{s}.csv" for s in ("metrics", "params", "prior")}
                want |= {f"{out}_trace.jsonl"}
                want |= {f"{out}_{k}it_{i}.bin" for k in ("", "r1_")
                         for i in range(1, iters + 1)}
                have = {f for f in os.listdir(d) if f.startswith(out + "_")}
                check(have == want, f"cli {dtype} {solver}: files {sorted(have ^ want)} differ")
                for f in sorted(want):
                    p = os.path.join(d, f)
                    if f.endswith(".bin"):
                        check(bool(np.all(np.isfinite(read_bin_slab(p, m)))), f"{f} not finite")
                    elif f.endswith(".csv"):
                        check(bool(np.all(np.isfinite(read_positional_csv(p)))),
                              f"{f} not finite")
                x1c = [r[2] for r in read_positional_csv(os.path.join(d, f"{out}_metrics.csv"))]
                log(f"[cli] {dtype} {solver}: {len(want)} files in {took:.1f}s; x1 corr "
                    f"{np.round(x1c, 4).tolist()}")
                check(x1c[-1] > x1c[0] and x1c[-1] > 0.5,
                      f"cli {dtype} {solver}: x1 correlation did not rise")
            cli_modes(dev, d, paths, fx.beta != 0, dtype, iters, log_dir)


def cli_modes(dev: str, d: str, paths: dict, causal: np.ndarray, dtype: str, iters: int,
              log_dir: str) -> None:
    """test, association_test (se, loo, loo_std) and predict through files
    on the eigen run's dumps: each output exists, is finite and has its
    shape; the test R2 rises with the iterations, the p-values lie in
    [0, 1] and the causal markers' median p-value is below the others'."""
    m, n = causal.size, len(open(paths["phen"]).read().splitlines())
    run = os.path.join(d, f"run_{dtype}_eigen")
    common = ["--Mt", str(m), "--out-dir", d, "--compute-dtype", dtype, "--device", dev]
    train = ["--meth-file", paths["bin"], "--phen-file", paths["phen"], "--N", str(n)]
    test = ["--meth-file-test", paths["bin"], "--phen-file-test", paths["phen"],
            "--N-test", str(n)]
    gam1 = read_positional_csv(f"{run}_params.csv")[-1][2]
    est = f"{run}_it_{iters}.bin"
    pred_est = os.path.join(d, f"pred_{dtype}_it_{iters}.bin")
    read_bin_slab(est, m).tofile(pred_est)  # predict writes <prefix>.yhat beside it
    jobs = {
        "test": ["--run-mode", "test", "--estimate-file", f"{run}_it_1.bin",
                 "--test-iter-range", f"1,{iters}", "--out-name", f"test_{dtype}"] + test,
        "se": ["--run-mode", "association_test", "--pval-method", "se",
               "--r1-file", f"{run}_r1_it_{iters}.bin", "--gam1", repr(gam1),
               "--out-name", f"assoc_{dtype}"] + train,
        "predict": ["--run-mode", "predict", "--estimate-file", pred_est,
                    "--out-name", f"pred_{dtype}"] + test,
    }
    for method in ("loo", "loo_std"):
        jobs[method] = ["--run-mode", "association_test", "--pval-method", method,
                        "--estimate-file", est, "--out-name", f"assoc_{dtype}"] + train
    took = {}
    for mode, argv in jobs.items():
        t0 = time.perf_counter()
        with engine_log(log_dir, f"cli_{dtype}_{mode}"):
            check(cli.main(argv + common) == 0, f"cli {dtype} {mode} returned non-zero")
        took[mode] = round(time.perf_counter() - t0, 2)
    rows = np.asarray([r for r in read_positional_csv(os.path.join(d, f"test_{dtype}_test.csv"))])
    check(rows.shape == (iters, 3) and np.all(np.isfinite(rows)), f"cli {dtype} test: bad CSV")
    check(rows[-1, 1] > rows[0, 1] and rows[-1, 1] > 0.5, f"cli {dtype} test: R2 did not rise")
    for method in ("se", "loo", "loo_std"):
        pv = read_bin_slab(os.path.join(d, f"assoc_{dtype}_it_{iters}_pval_{method}.bin"), m)
        check(bool(np.all((pv >= 0) & (pv <= 1))), f"cli {dtype} {method}: p-values outside [0, 1]")
        check(np.median(pv[causal]) < np.median(pv[~causal]),
              f"cli {dtype} {method}: causal markers not ranked above the others")
    with open(os.path.join(d, f"pred_{dtype}_.yhat")) as f:
        yhat = np.array([float(v) for v in f.read().split()])
    check(yhat.shape == (n,) and bool(np.all(np.isfinite(yhat))), f"cli {dtype} predict: bad .yhat")
    log(f"[cli] {dtype} run modes through files, seconds {took}; test R2 per iteration "
        f"{np.round(rows[:, 1], 4).tolist()}")


def _csv_raw(path: str) -> np.ndarray:
    """Rows of a positional CSV without a header (the probit test CSV)."""
    text = open(path, "rb").read().replace(b"\0", b"").decode()
    return np.array([[float(v) for v in line.split(",")] for line in text.splitlines()
                     if line.strip()])


def phase_cli_probit(dev: str, log_dir: str, n: int = 2_000, m: int = 8_000,
                     iters: int = 6) -> None:
    """--model bin_class through files: int8 with eigen, spectral (with
    --C 2 --cov-file) and cg, int4 with eigen; linear int8 eigen with
    --C 2; then test, predict and association_test (se, loo, loo_std) with
    --model bin_class on the probit int8 eigen run's dumps.  Every output
    exists and is finite; the probit params CSV has 9 columns (8 values)."""
    with tempfile.TemporaryDirectory(prefix="vampomi_cli_probit_") as d:
        fx = simulate_iid(n=n, m=m, lam=0.1, h2=0.8, seed=SEED)
        paths = write_fixture(fx, d, "ex")
        rng = np.random.default_rng(SEED + 9)
        Z = rng.normal(size=(n, 2))
        y01 = (fx.X @ fx.beta + Z @ [0.6, -0.4] + rng.normal(size=n) > 0).astype(int)
        with open(os.path.join(d, "ex_bin.phen"), "w") as f:
            f.writelines(f"{i} {i} {v}\n" for i, v in enumerate(y01))
        with open(os.path.join(d, "ex.cov"), "w") as f:
            f.write("ID FID age batch\n")
            f.writelines(f"{i} {i} {a!r} {b!r}\n" for i, (a, b) in enumerate(Z.tolist()))
        cov = ["--C", "2", "--cov-file", os.path.join(d, "ex.cov")]
        runs = {"bin_int8_eigen": ("bin_class", "int8", "eigen", []),
                "bin_int8_spectral_cov": ("bin_class", "int8", "spectral", cov),
                "bin_int8_cg": ("bin_class", "int8", "cg", []),
                "bin_int4_eigen": ("bin_class", "int4", "eigen", []),
                "lin_int8_eigen_cov": ("linear", "int8", "eigen", cov)}
        for out, (model, dtype, solver, extra) in runs.items():
            phen = os.path.join(d, "ex_bin.phen") if model == "bin_class" else paths["phen"]
            hyper = (["--rho", "0.3", "--gam1", "1e-2"] if model == "bin_class"
                     else ["--h2", "0.8"])
            argv = ["--run-mode", "infere", "--model", model, "--meth-file", paths["bin"],
                    "--phen-file", phen, "--true-signal-file", paths["ts"], "--N", str(n),
                    "--Mt", str(m), "--out-dir", d, "--out-name", out, "--iterations",
                    str(iters), "--stop-criteria-thr", "0", "--probs", "0.9,0.07,0.03",
                    "--vars", "0.0,0.001,0.01", "--device", dev, "--compute-dtype", dtype,
                    "--lmmse-solver", solver] + hyper + extra
            t0 = time.perf_counter()
            with engine_log(log_dir, f"cli_{out}"):
                check(cli.main(argv) == 0, f"cli {out} returned non-zero")
            took = time.perf_counter() - t0
            want = {f"{out}_{s}.csv" for s in ("metrics", "params", "prior")}
            want |= {f"{out}_trace.jsonl"}
            want |= {f"{out}_{k}it_{i}.bin" for k in ("", "r1_") for i in range(1, iters + 1)}
            have = {f for f in os.listdir(d) if f.startswith(out + "_")}
            check(have == want, f"cli {out}: files {sorted(have ^ want)} differ")
            for f in sorted(want):
                p = os.path.join(d, f)
                if f.endswith(".bin"):
                    check(bool(np.all(np.isfinite(read_bin_slab(p, m)))), f"{f} not finite")
                elif f.endswith(".csv"):
                    check(bool(np.all(np.isfinite(read_positional_csv(p)))), f"{f} not finite")
            params = np.asarray(read_positional_csv(os.path.join(d, f"{out}_params.csv")))
            check(params.shape == (iters, 9 if model == "bin_class" else 6),
                  f"cli {out}: params CSV of shape {params.shape}")
            met = np.asarray(read_positional_csv(os.path.join(d, f"{out}_metrics.csv")))
            quality = (f"acc1 {np.round(met[:, 5], 4).tolist()}, x1 corr "  # after the iteration
                       f"{np.round(met[:, 6], 4).tolist()}" if model == "bin_class"
                       else f"x1 corr {np.round(met[:, 2], 4).tolist()}")
            log(f"[cli] {out}: {len(want)} files in {took:.1f}s; {quality}")

        run = os.path.join(d, "bin_int8_eigen")
        est = f"{run}_it_{iters}.bin"
        pred_est = os.path.join(d, f"pred_bin_it_{iters}.bin")
        read_bin_slab(est, m).tofile(pred_est)
        gam1 = read_positional_csv(f"{run}_params.csv")[-1][3]
        common = ["--Mt", str(m), "--out-dir", d, "--compute-dtype", "int8", "--device", dev,
                  "--model", "bin_class"]
        train = ["--meth-file", paths["bin"], "--phen-file", os.path.join(d, "ex_bin.phen"),
                 "--N", str(n)]
        test = ["--meth-file-test", paths["bin"], "--phen-file-test",
                os.path.join(d, "ex_bin.phen"), "--N-test", str(n)]
        jobs = {"test": ["--run-mode", "test", "--estimate-file", f"{run}_it_1.bin",
                         "--test-iter-range", f"1,{iters}", "--out-name", "test_bin"] + test,
                "predict": ["--run-mode", "predict", "--estimate-file", pred_est,
                            "--out-name", "pred_bin"] + test,
                "se": ["--run-mode", "association_test", "--pval-method", "se", "--r1-file",
                       f"{run}_r1_it_{iters}.bin", "--gam1", repr(gam1),
                       "--out-name", "assoc_bin"] + train}
        for method in ("loo", "loo_std"):
            jobs[method] = ["--run-mode", "association_test", "--pval-method", method,
                            "--estimate-file", est, "--out-name", "assoc_bin"] + train
        for mode, argv in jobs.items():
            with engine_log(log_dir, f"cli_bin_{mode}"):
                check(cli.main(argv + common) == 0, f"cli bin_class {mode} returned non-zero")
        rows = _csv_raw(os.path.join(d, "test_bin_test.csv"))
        check(rows.shape == (iters, 6) and np.all(np.isfinite(rows)), "cli bin_class test: bad CSV")
        with open(os.path.join(d, "pred_bin_.yhat")) as f:
            yhat = np.array([float(v) for v in f.read().split()])
        check(yhat.shape == (n,) and bool(np.all(np.isfinite(yhat))), "cli bin_class predict")
        for method in ("se", "loo", "loo_std"):
            pv = read_bin_slab(os.path.join(d, f"assoc_bin_it_{iters}_pval_{method}.bin"), m)
            check(bool(np.all((pv >= 0) & (pv <= 1))), f"cli bin_class {method}: p-values")
        log(f"[cli] bin_class run modes through files: test accuracy per iteration "
            f"{np.round(rows[:, 5], 4).tolist()}; predict, association_test se, loo, loo_std "
            f"written and finite")


# (model, solver) of the resume phase, int8
RESUME_RUNS = (("linear", "eigen"), ("linear", "spectral"), ("linear", "cg"),
               ("bin_class", "eigen"), ("bin_class", "cg"))


def phase_resume(dev: str, log_dir: str, n: int = 2_000, m: int = 8_000, iters: int = 8,
                 split: int = 4) -> None:
    """Exact-state resume through the CLI (int8, each (model, solver) of
    RESUME_RUNS): an uninterrupted run of `iters` iterations with
    --checkpoint-file, and in another directory a run of `split` iterations
    with --checkpoint-file followed by --resume-file to `iters`.  The CSVs
    (whole: the resumed run appends) and the .bin dumps of iterations
    split+1..iters must be byte-identical to the uninterrupted run's; a file
    that is not is named and held to rtol 1e-6 (a library call that does
    not repeat its bits)."""
    with tempfile.TemporaryDirectory(prefix="vampomi_resume_") as d:
        fx = simulate_iid(n=n, m=m, lam=0.1, h2=0.8, seed=SEED)
        paths = write_fixture(fx, d, "ex")
        y01 = (fx.X @ fx.beta + np.random.default_rng(SEED + 10).normal(size=n) > 0).astype(int)
        binphen = os.path.join(d, "ex_bin.phen")
        with open(binphen, "w") as f:
            f.writelines(f"{i} {i} {v}\n" for i, v in enumerate(y01))
        t0 = time.perf_counter()
        for model, solver in RESUME_RUNS:
            phen, hyper = ((binphen, ["--rho", "0.3", "--gam1", "1e-2"]) if model == "bin_class"
                           else (paths["phen"], ["--h2", "0.8"]))
            tag = f"{model}_{solver}"

            def run(sub: str, k: int, extra: list[str], what: str) -> None:
                os.makedirs(sub, exist_ok=True)
                argv = ["--run-mode", "infere", "--model", model, "--meth-file", paths["bin"],
                        "--phen-file", phen, "--true-signal-file", paths["ts"], "--N", str(n),
                        "--Mt", str(m), "--out-dir", sub, "--out-name", "r", "--iterations",
                        str(k), "--stop-criteria-thr", "0", "--probs", "0.9,0.07,0.03",
                        "--vars", "0.0,0.001,0.01", "--device", dev, "--compute-dtype", "int8",
                        "--lmmse-solver", solver, "--seed", str(SEED)] + hyper + extra
                with engine_log(log_dir, f"resume_{tag}_{what}"):
                    check(cli.main(argv) == 0, f"resume {tag} {what}: non-zero exit")

            full, part = os.path.join(d, f"{tag}_full"), os.path.join(d, f"{tag}_part")
            run(full, iters, ["--checkpoint-file", os.path.join(full, "ck.npz")], "full")
            run(part, split, ["--checkpoint-file", os.path.join(part, "ck.npz")], "first")
            check(load_checkpoint(os.path.join(part, "ck.npz"))["iteration"] == split,
                  f"resume {tag}: checkpoint not at iteration {split}")
            run(part, iters, ["--resume-file", os.path.join(part, "ck.npz")], "resumed")
            names = [f"r_{c}.csv" for c in ("params", "metrics", "prior")]
            names += [f"r_{k}it_{i}.bin" for k in ("", "r1_") for i in range(split + 1, iters + 1)]
            apart = []
            for f in names:
                a, b = (os.path.join(x, f) for x in (full, part))
                if _bytes(a) == _bytes(b):
                    continue
                if f.endswith(".csv"):
                    va, vb = (np.asarray(read_positional_csv(x)) for x in (a, b))
                else:
                    va, vb = read_bin_slab(a, m), read_bin_slab(b, m)
                err = float(np.max(np.abs(va - vb) / np.maximum(np.abs(va), 1e-30)))
                apart.append(f"{f} (max rel diff {err:.2e})")
                check(va.shape == vb.shape and err <= 1e-6,
                      f"resume {tag}: {f} differs past rtol 1e-6 ({err:.2e})")
            log(f"[resume] {tag} int8 N={n} M={m}: {split} + {iters - split} iterations against "
                f"{iters} straight: " + (f"{len(names)} files byte-identical (3 CSVs, the dumps "
                                         f"of iterations {split + 1}-{iters})" if not apart else
                                         "NOT byte-identical, within rtol 1e-6: "
                                         + ", ".join(apart)))
        log(f"[resume] done in {time.perf_counter() - t0:.1f}s")


def phase_doctor() -> None:
    """`python -m vampomi_tpu_torch.doctor` in a subprocess: exit 0."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "vampomi_tpu_torch.doctor"], capture_output=True,
                         text=True, timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in out.stdout.strip().splitlines():
        log(f"[doctor] {line}")
    check(out.returncode == 0, f"the doctor exited {out.returncode}: {out.stderr[-2000:]}")
    log(f"[doctor] exit 0 in {time.perf_counter() - t0:.1f}s")


def bf16_design(dev: str):
    """The bf16 north-star design built on the card from seeded uniform
    values (design_from_raw_rows: f64 statistics of the raw values, the
    values stored as bf16), 20 GiB of X."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 9)
    return design_from_raw_rows(
        NS_M, NS_N, lambda lo, hi: torch.rand((hi - lo, NS_N), device=dev, generator=g), dev)


def planted_problem(dm, causal: int, h2: float = 0.8):
    """y = A beta + e in file units on the design dm of codes made on the card."""
    m, n = dm.m_pad, int(dm.n)
    gen = torch.Generator().manual_seed(SEED + 3)
    idx = torch.randperm(m, generator=gen)[:causal]
    beta = np.zeros(m)
    beta[idx.numpy()] = np.random.default_rng(SEED).normal(0.0, math.sqrt(h2 / causal), causal)
    g = math.sqrt(n) * ax(dm, torch.as_tensor(beta, dtype=torch.float32, device=dm.device))
    y = g.double().cpu().numpy() + np.random.default_rng(SEED + 1).normal(
        0.0, math.sqrt(1.0 - h2), n)
    y = y * math.sqrt((n - 1.0) / np.sum((y - y.mean()) ** 2))  # as read_phen does
    prior = dict(probs=[1.0 - causal / m, causal / m], vars=[0.0, h2 / causal], h2=h2)
    return y, beta, prior


# the kernels' suffix for each design of the main path
MAIN_SUFFIX = {"int8": "int8", "int4": "packed4", "bf16": "bf16"}
# (label, solver, iterations, the solver that must run)
MAIN_RUNS = (("eigen", "eigen", 5, "eigen"), ("cg", "cg", 2, "cg"))
# the int8 path: a cold auto, an eigen run that writes the eigen cache, auto
# again with the cache warm (eigen, its factor loaded), CG
MAIN_RUNS_INT8 = (("auto", "auto", 4, "spectral"), ("eigen", "eigen", 5, "eigen"),
                  ("auto_warm", "auto", 4, "eigen"), ("cg", "cg", 2, "cg"))
# bf16: eigen 4 iterations, not 5: on this design the trajectory's x1
# correlation peaks at iteration 3 and the noise-precision EM has driven it
# below its start (0) by iteration 5 (0, 0.453, 0.656, 0.289, -0.138 on an
# NVIDIA H100 80GB HBM3 at 700 W; the int8 design's ends at 0.004), the
# collapse at M/N >= 16 of EM_STABILITY.json
MAIN_RUNS_BF16 = (("eigen", "eigen", 4, "eigen"), ("auto", "auto", 4, "spectral"),
                  ("cg", "cg", 2, "cg"))


class MainPath(NamedTuple):
    launches: dict          # kernel launches of the whole path
    dataset: Dataset        # the planted design and its phenotype, for the run modes
    beta: np.ndarray        # the planted effects, file units


def exact_launches(dtype: str, solver: str, k: int, steps: list[int], rows: int) -> dict:
    """The launches of a linear run of k iterations on `rows` rows of X: the
    setup's A^T y and one A^T pass an iteration, and the two-column
    ax_batch pass (exact solvers, with the Gram's, gram_launches); CG adds,
    an iteration, ax of x1, x2 and the probe's trace pass, the initial
    residual's pass each way, then one pass each way a CG step (`steps`,
    from the run's trace)."""
    sfx = MAIN_SUFFIX[dtype]
    atx_k, ax_k, rows_k = (f"atx_{sfx}", f"ax_batch_{sfx}", f"atx_batch_{sfx}")
    if solver != "cg":
        return {atx_k: k + 1, ax_k: k, **gram_launches(solver, rows)}
    return {atx_k: k + 1, ax_k: sum(steps) + 4 * k, rows_k: sum(steps) + k}


def phase_main(dtype: str, build: Callable, log_dir: str, out_dir: str, x1_min: float,
               runs=MAIN_RUNS, cg_max_iter: int = 50, cache: str = "",
               checkpoint_cost: bool = False) -> MainPath:
    """The main path on a planted design (build() makes it on the card),
    prior fixed at the truth, one causal marker per 1,024: each run of
    `runs` once with the per-iteration outputs (CSV rows, .bin dumps) and
    once without, for the wall without the dumps and the kernel launches of
    a run, checked exactly (exact_launches).  With `cache`, every run
    passes --eigen-cache; a run labelled *_warm repeats the eigen run's
    iterations bitwise.  With `checkpoint_cost`, one more eigen run without
    outputs and with --checkpoint-file gives a checkpoint's cost an
    iteration.  Launches are counted from 0 set just before the path and
    read just after."""
    t0 = time.perf_counter()
    dm = build()
    dev = dm.device
    causal = dm.m_pad // 1024
    y, beta, prior = planted_problem(dm, causal)
    torch.cuda.synchronize()
    m, n = dm.m_pad, int(dm.n)
    gib = dm.X.numel() * dm.X.element_size() / 2**30
    log(f"[main {dtype}] planted design M={m} N={n} (M/N={m / n:.0f}, {gib:.2f} GiB of X), "
        f"{causal} causal, h2=0.8, prior fixed at the truth: built in "
        f"{time.perf_counter() - t0:.1f}s")
    W = torch.randn((m, 2), device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    ms = card_ms(lambda: ax_batch(dm, W), reps=5, warmup=1, calls=KERNEL_CALLS)
    log(f"[main {dtype}] operator ax_batch (K=2): {ms:.3f} ms "
        f"({dm.X.numel() * dm.X.element_size() / ms / 1e6:.1f} GB/s of X)")
    del W
    reset_launches()
    off_secs = {}
    for label, solver, k, expect in runs:
        name = f"main_{dtype}_{label}"
        cfg = RunConfig(out_dir=out_dir, out_name=name, iterations=k,
                        lmmse_solver=solver, stop_criteria_thr=0.0, learn_vars=0,
                        learn_prior_delay=k, CG_max_iter=cg_max_iter, device=str(dev),
                        seed=SEED, eigen_cache=cache, **prior)
        torch.cuda.reset_peak_memory_stats(dev)
        before = launches()
        with engine_log(log_dir, name):
            res = infere_linear(dm, y, cfg, true_signal=beta)
        torch.cuda.synchronize()
        count = {key: c - before[key] for key, c in launches().items() if c > before[key]}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        mh = np.asarray(res.metrics_history)
        secs = res.iter_seconds
        steady = secs[1:] if len(secs) > 1 else secs
        setup = res.setup
        extra = f"gram {setup['gram']:.3f}s, " if "gram" in setup else ""
        if "eigh" in setup:
            extra += f"eigh {setup['eigh']:.3f}s (residual {setup['eigen_resid']:.2e}), "
        for key in ("eigen_cache_write", "eigen_cache_load"):
            if key in setup:
                extra += f"{key.replace('_', ' ')} {setup[key]:.3f}s, "
        log(f"[main {dtype}] {label} (ran {res.solver}): {extra}A^T y {setup['aty']:.4f}s; "
            f"per-iteration seconds {[round(t, 4) for t in secs]}; {1.0 / np.mean(steady):.2f} "
            f"it/s over iterations 2..{len(secs)}; peak memory {peak:.2f} GiB; kernel launches "
            f"{count}; x1 corr {np.round(mh[:, 1], 4).tolist()}")
        check(res.solver == expect, f"{dtype} {label}: the solver that ran was {res.solver}, "
                                    f"want {expect}")
        if cache and res.solver == "eigen":
            loaded = "eigen_cache_load" in setup
            check(loaded == (label != "eigen"), f"{dtype} {label}: eigen cache "
                                                f"{'loaded' if loaded else 'built'}")
        check(np.all(np.isfinite(mh)) and np.all(np.isfinite(res.x1_hat_scaled)),
              f"{dtype} {label}: outputs not finite")
        check(mh[-1, 1] > mh[0, 1], f"{dtype} {label}: x1 correlation did not rise")
        # the trajectory recovers signal first; at M/N >= 100 the noise-
        # precision EM then drives it down in the JAX engine too (PERF.md)
        check(mh[:, 1].max() > x1_min,
              f"{dtype} {label}: x1 correlation never passed {x1_min}")
        for i in range(1, k + 1):
            check(bool(np.all(np.isfinite(read_bin_slab(
                os.path.join(out_dir, f"{name}_it_{i}.bin"), m)))), "dump not finite")
        steps = (_trace_steps(os.path.join(out_dir, f"{name}_trace.jsonl"))
                 if res.solver == "cg" else [])
        want = exact_launches(dtype, res.solver, k, steps, m)
        check(count == want, f"{dtype} {label}: launches {count}, want {want}")
        if label.endswith("_warm"):
            with open(os.path.join(log_dir, f"{name}.log")) as f:
                narration = f.read()
            check("upgraded from spectral" in narration and "eigenbasis of K loaded" in narration,
                  f"{dtype} {label}: no upgrade to eigen or no cache load in the log")
            warm_equals_eigen(out_dir, dtype, label, k)
        before = launches()
        with engine_log(log_dir, f"{name}_off"):
            off = infere_linear(dm, y, cfg, true_signal=beta, write_outputs=False)
        torch.cuda.synchronize()
        count = {key: c - before[key] for key, c in launches().items() if c > before[key]}
        mo = np.asarray(off.metrics_history)
        check(mo.shape == mh.shape and np.all(np.isfinite(mo)),
              f"{dtype} {label}, outputs off: bad shapes or values")
        want = exact_launches(dtype, off.solver, k, steps, m)
        check(count == want, f"{dtype} {label}, outputs off: launches {count}, want {want}")
        off_secs[label] = off.iter_seconds
        log(f"[main {dtype}] {label}, outputs off: per-iteration seconds "
            f"{[round(t, 4) for t in off.iter_seconds]}; kernel launches {count} in {k} "
            f"iterations and the setup's A^T y; max abs diff of the metrics against the run "
            f"with outputs {float(np.abs(mo - mh).max()):.3g}")
        if res.solver == "spectral":
            params = read_positional_csv(os.path.join(out_dir, f"{name}_params.csv"))
            spectral_routes(dm, tau=params[-1][5], gam2=params[-1][4], tag=f"main {dtype}")
    if checkpoint_cost:
        k = next(r[2] for r in runs if r[0] == "eigen")
        ck = os.path.join(out_dir, f"ck_{dtype}.npz")
        cfg = RunConfig(out_dir=out_dir, out_name=f"main_{dtype}_ck", iterations=k,
                        lmmse_solver="eigen", stop_criteria_thr=0.0, learn_vars=0,
                        learn_prior_delay=k, device=str(dev), seed=SEED, eigen_cache=cache,
                        checkpoint_file=ck, **prior)
        with engine_log(log_dir, f"main_{dtype}_ck"):
            res = infere_linear(dm, y, cfg, true_signal=beta, write_outputs=False)
        on, off = np.median(res.iter_seconds[1:]), np.median(off_secs["eigen"][1:])
        with_ck = [round(t, 4) for t in res.iter_seconds]
        without = [round(t, 4) for t in off_secs["eigen"]]
        log(f"[main {dtype}] eigen with --checkpoint-file, outputs off: per-iteration seconds "
            f"{with_ck} against {without} without: a checkpoint costs {1e3 * (on - off):.2f} ms "
            f"an iteration (medians of iterations 2..{k}; the file {os.path.getsize(ck)} bytes, "
            f"written on the IO thread)")
        check(load_checkpoint(ck)["iteration"] == k, f"{dtype}: checkpoint not at iteration {k}")
    ds = Dataset(dm=dm, phen=Phenotype(y=y, intercept=0.0, scale=1.0), covariates=None,
                 qscale=np.ones(m) if dm.X.dtype in QUANTIZED else None)  # codes: scale 1
    return MainPath(launches(), ds, beta)


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def warm_equals_eigen(out_dir: str, dtype: str, label: str, k: int) -> None:
    """The run with the warm cache against the eigen run that wrote it: the
    params, metrics and prior rows of its k iterations and the dumps of
    each, byte for byte (the loaded factor is the saved one)."""
    warm, cold = (os.path.join(out_dir, f"main_{dtype}_{t}") for t in (label, "eigen"))
    for csv in ("params", "metrics", "prior"):
        a = read_positional_csv(f"{warm}_{csv}.csv")
        check(a == read_positional_csv(f"{cold}_{csv}.csv")[:k],
              f"{dtype} {label}: {csv} rows differ from the eigen run's")
    for i in range(1, k + 1):
        for kind in ("it", "r1_it"):
            check(_bytes(f"{warm}_{kind}_{i}.bin") == _bytes(f"{cold}_{kind}_{i}.bin"),
                  f"{dtype} {label}: {kind}_{i}.bin differs")
    log(f"[main {dtype}] {label}: its {k} iterations byte-identical to the eigen run's (CSV rows "
        f"and dumps)")


def host_syncs(fn) -> int:
    """The host syncs of one fn() by torch's sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def spectral_routes(dm, tau: float, gam2: float, tag: str) -> None:
    """The spectral solver's dense step at the run's N and a shift of its last
    iteration, timed alone (card_ms: means of back-to-back calls, each call
    with its own host sync): the blocked pass the engine takes
    (`shift_inverse` at default_nb(N) blocks), potrf alone, potrf and
    W = L^{-1} by a triangular solve against the identity (the port's
    route before the blocked pass, kept here as a yardstick), and potrf +
    torch.cholesky_inverse; each beside the least work, potrf + trtri =
    2N^3/3 FLOPs at the f32 rate.  Then the blocked pass at each diagonal
    block count x leaf size of dense_step_probe.GRID (three samples each), its host
    enqueue and the card's own time (tools/dense_step_probe.py own_time), its
    host syncs (one), S^{-1} b and T against the other routes, and its raise
    for tau < 0; beside them one N x N x N f32 GEMM, cuBLAS's own rate at
    this N."""
    check(not torch.backends.cuda.matmul.allow_tf32, f"{tag}: TF32 is on for matmuls")
    t0 = time.perf_counter()
    fac = build_spectral(dm)
    torch.cuda.synchronize()
    gram_s = time.perf_counter() - t0
    n, dev, nb = fac.n, fac.K.device, spectral.default_nb(fac.n)
    shift = [torch.tensor(x, dtype=torch.float64, device=dev) for x in (tau, gam2)]
    S = spectral._shifted(fac, *shift)
    blocked = f"blocked shift_inverse (nb {nb}, base {spectral._FACTOR_BASE})"
    routes = {
        blocked: lambda: shift_inverse(fac, *shift, nb=nb),
        "potrf": lambda: torch.linalg.cholesky_ex(S),
        "potrf + trsm against I": lambda: dense_step_probe.potrf_trsm(S),
        "potrf + cholesky_inverse": lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(S)[0]),
    }
    ms = {name: card_ms(fn, reps=3, warmup=1, calls=KERNEL_CALLS) for name, fn in routes.items()}
    least = 1e3 * (2 * n**3 / 3) / F32_FLOPS
    gemm_ms = card_ms(lambda: S @ S, reps=3, warmup=1, calls=KERNEL_CALLS)  # cuBLAS's f32 rate
    sweep = {}
    for k, base in dense_step_probe.GRID:
        fn = lambda: dense_step_probe.blocked(fac, shift, k, base)  # noqa: E731
        fn()
        sweep[f"nb {k} base {base}"] = [
            round(card_ms(fn, reps=1, warmup=0, calls=KERNEL_CALLS), 3) for _ in range(3)]
    enqueue, device_ms = dense_step_probe.own_time(fac, shift, nb)
    syncs = host_syncs(lambda: shift_inverse(fac, *shift, nb=nb))
    winv = shift_inverse(fac, *shift, nb=nb)
    W_ref = dense_step_probe.potrf_trsm(S)
    T_ref = torch.linalg.vector_norm(W_ref, dtype=torch.float64) ** 2
    T_inv = float(torch.cholesky_inverse(torch.linalg.cholesky_ex(S)[0]).diagonal().double().sum())
    b = torch.randn(n, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    x, x_ref = (v.double().cpu().numpy() for v in (winv.solve(b), W_ref.T @ (W_ref @ b)))
    x_err = float(np.max(np.abs(x - x_ref)) / np.max(np.abs(x_ref)))
    try:
        shift_inverse(fac, -shift[0], shift[1], nb=nb)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    card = card_info(dev)["nvidia_smi"]
    log(f"[{tag}] spectral dense step at N={n} on {card} (tau={tau:.6g}, gam2={gam2:.6g}; "
        f"Gram rebuilt in {gram_s:.3f}s; TF32 off): "
        + ", ".join(f"{k} {v:.3f} ms ({100 * least / v:.1f}% of the least work)"
                    for k, v in ms.items())
        + f"; least work potrf + trtri 2N^3/3 at 67 TFLOP/s {least:.3f} ms; one N x N x N f32 "
        f"GEMM by cuBLAS {gemm_ms:.3f} ms ({2 * n**3 / gemm_ms / 1e9:.1f} TFLOP/s); the "
        f"blocked pass by nb x base, three samples (ms): {sweep}; its host enqueue {enqueue:.3f} ms "
        f"({100 * enqueue / ms[blocked]:.1f}% of its time above), the card's own time (the "
        f"host enqueued ahead) {device_ms:.3f} ms; host syncs of one "
        f"call {syncs}; T = tr S^-1 {float(winv.T):.9g} by the blocked pass, "
        f"{float(T_ref):.9g} by potrf + trsm, {T_inv:.9g} by cholesky_inverse; S^-1 b by the "
        f"blocked pass against potrf + trsm: max |diff| {x_err:.3e} of max |x|; tau < 0 "
        f"raised: {raised!r}")
    check(syncs == 1, f"{tag}: {syncs} host syncs in one shift_inverse, want 1")
    check(abs(float(winv.T) / T_inv - 1.0) < 1e-4, f"{tag}: the routes' traces disagree")
    check(within(x, x_ref, 1e-4), f"{tag}: S^-1 b by the blocked pass and by potrf + trsm differ")
    check("leading minor" in raised and "not positive definite" in raised,
          f"{tag}: shift_inverse did not raise for tau < 0")
    del fac, S, winv, W_ref
    torch.cuda.empty_cache()


def _trace_steps(path: str) -> list[int]:
    """The CG steps of each iteration, from a run's <out>_trace.jsonl."""
    with open(path) as f:
        return [json.loads(line)["cg_iters"] for line in f if line.strip()]


def phase_probit_main(main: MainPath, log_dir: str, out_dir: str,
                      solvers=(("auto", 4), ("eigen", 4), ("cg", 2)),
                      cg_max_iter: int = 50, h2: float = 0.8) -> dict:
    """Probit GLM-VAMP on the main path's planted int8 design: 0/1 labels
    y = 1[sqrt(N) A beta + N(0, 1) > 0] (the liability model, probit_var 1,
    sum beta^2 ~ h2), the prior started at the truth with its variances
    fixed (the probit engine's EM still moves the weights from iteration
    2).  Each (solver, iterations) once with the per-iteration outputs and
    once without; the launches of each run are checked exactly against the
    X passes the engine makes.  Returns the launches of all the runs, counted
    from 0 set just before and read just after."""
    dm = main.dataset.dm
    dev = dm.device
    m, n = dm.m_pad, int(dm.n)
    beta = main.beta
    causal = int((beta != 0).sum())
    g = math.sqrt(n) * ax(dm, torch.as_tensor(beta, dtype=torch.float32, device=dev))
    y = (g.double().cpu().numpy() + np.random.default_rng(SEED + 5).normal(size=n) > 0)
    y = y.astype(np.float64)
    prior = dict(probs=[1.0 - causal / m, causal / m], vars=[0.0, h2 / causal])
    log(f"[probit] planted labels on M={m} N={n}: {int(y.sum())} cases of {n}, {causal} "
        f"causal, prior started at the truth")
    reset_launches()
    for solver, k in solvers:
        cfg = RunConfig(out_dir=out_dir, out_name=f"probit_{solver}", model="bin_class",
                        iterations=k, lmmse_solver=solver, stop_criteria_thr=0.0, learn_vars=0,
                        CG_max_iter=cg_max_iter, device=str(dev), seed=SEED, rho=0.3,
                        gam1=1e-2, **prior)
        for outputs in (True, False):
            torch.cuda.reset_peak_memory_stats(dev)
            before = launches()
            with engine_log(log_dir, f"probit_{solver}" + ("" if outputs else "_off")):
                res = infere_bin_class(dm, y, cfg, true_signal=beta, write_outputs=outputs)
            torch.cuda.synchronize()
            count = {name: c - before[name] for name, c in launches().items() if c > before[name]}
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            mh = np.asarray(res.metrics_history)
            secs = res.iter_seconds
            steady = secs[1:] if len(secs) > 1 else secs
            setup = ", ".join(f"{key} {v:.3f}s" if key != "eigen_resid" else f"residual {v:.2e}"
                              for key, v in res.setup.items())
            log(f"[probit] {solver} (ran {res.solver}), outputs {'on' if outputs else 'off'}: "
                f"setup {setup or 'none'}; per-iteration seconds {[round(t, 4) for t in secs]}; "
                f"{1.0 / np.mean(steady):.2f} it/s over iterations 2..{len(secs)}; peak memory "
                f"{peak:.2f} GiB; kernel launches {count}; acc1 {np.round(mh[:, 4], 4).tolist()}, "
                f"acc2 {np.round(mh[:, 10], 4).tolist()}, x1 corr {np.round(mh[:, 5], 4).tolist()}")
            check(res.solver == ("spectral" if solver == "auto" else solver),
                  f"probit {solver}: the solver that ran was {res.solver}")
            check(mh.shape == (k, 12) and np.all(np.isfinite(mh))
                  and np.all(np.isfinite(res.x1_hat_scaled)), f"probit {solver}: not finite")
            if res.solver == "cg" and outputs:
                steps = _trace_steps(os.path.join(out_dir, f"probit_{solver}_trace.jsonl"))
            want = probit_launches(res.solver, k, steps if res.solver == "cg" else [], m)
            check(count == want, f"probit {solver}: launches {count}, want {want}")
    return launches()


MODE_KERNELS = {"int8": ("row_moments_int8", "atx_int8", "ax_batch_int8"),
                "int4": ("row_moments_packed4", "atx_packed4", "ax_batch_packed4"),
                "bf16": (None, "atx_bf16", "ax_batch_bf16")}  # f64 moments in torch


def phase_modes(dtype: str, main: MainPath, out_dir: str, est: str, r1: str, gam1: float,
                test_runs: int) -> tuple[dict, dict]:
    """The run modes at full width on the main path's design and dumps:
    row_moments against its plain version (bitwise, timed in turns); LOO
    (`loo`, `loo_std`) and SE p-values from the dumps `est` and `r1`, and
    the LOO statistics of 4,096 rows against f64 on the host; test mode over
    the estimates main_<dtype>_eigen_it_1..test_runs (one ax_batch pass);
    predict.  Launches counted from 0 just before the modes and read just
    after.  Returns ({kernel: record}, {kernel: launches})."""
    ds = main.dataset
    dm = ds.dm
    m, n = dm.m_pad, int(dm.n)
    name = MODE_KERNELS[dtype][0]
    recs = {}
    if name is not None:
        kn = KERNELS[name]
        got, want = kn.fn(dm.X), kn.plain(dm.X)
        check(torch.equal(got, want), f"{name} differs from its plain version at full shape")
        check(torch.equal(got, kn.fn(dm.X)), f"{name} not bitwise repeatable")
        ms, plain_ms, t_kern, t_plain = in_turns(lambda: kn.fn(dm.X), lambda: kn.plain(dm.X))
        least_ms, least_by = bound(name, dm.X, 1)
        log(f"[modes {dtype}] {name} X {tuple(dm.X.shape)}: bitwise equal to its plain version "
            f"and repeatable; {ms:.3f} ms ({dm.X.numel() / ms / 1e6:.1f} GB/s of X; bound "
            f"{least_ms:.3f} ms by {least_by}, {100 * least_ms / ms:.1f}% of it); plain "
            f"{plain_ms:.3f} ms; runs {t_kern} / {t_plain}")
        recs[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=least_ms,
                          bound_by=least_by, library_ms=None)
        del got, want

    cfg = RunConfig(out_dir=out_dir, out_name=f"modes_{dtype}", N=n, Mt=m, N_test=n, gam1=gam1,
                    r1_file=r1, estimate_file=est, device=str(dm.device))
    reset_launches()
    took = {}
    pv = {}
    for method in ("se", "loo", "loo_std"):
        t0 = time.perf_counter()
        pv[method] = association.run_association_test(ds, dataclasses.replace(
            cfg, pval_method=method))
        took[method] = time.perf_counter() - t0
        p = pv[method]
        check(p.shape == (m,) and bool(np.all((p >= 0) & (p <= 1))),
              f"{dtype} {method}: p-values not in [0, 1]")
    causal = main.beta != 0
    log(f"[modes {dtype}] association at M={m} N={n}: seconds "
        f"{ {k: round(v, 3) for k, v in took.items()} }; p < 0.05/M: "
        + ", ".join(f"{k} {int((v[causal] < 0.05 / m).sum())} of {int(causal.sum())} causal, "
                    f"{int((v[~causal] < 0.05 / m).sum())} others" for k, v in pv.items()))

    # the LOO statistics of 4,096 rows against f64 on the host
    x1_up = read_bin_slab(est, m) * math.sqrt(n)
    z1 = ax(dm, torch.as_tensor(x1_up, dtype=torch.float32, device=dm.device))
    y_mod = ds.phen.y - z1.double().cpu().numpy()
    sumx, sumsqx, xy = association._loo_stats(dm, y_mod)
    rows = np.sort(np.random.default_rng(SEED).choice(m, 4096, replace=False))
    C = codes64(dm.X[torch.as_tensor(rows, device=dm.device)]).cpu().numpy()
    # integer codes sum exactly in f64; squares of bf16 values need more
    # bits than f64 has, so their sums agree to its rounding
    same = np.array_equal if dtype != "bf16" else (
        lambda a, b: np.allclose(a, b, rtol=1e-12, atol=0))
    check(same(sumx[rows], C.sum(axis=1)) and same(sumsqx[rows], (C * C).sum(axis=1)),
          f"{dtype} LOO: code sums differ from f64 on the host")
    xy_err = float(np.max(np.abs(xy[rows] - C @ y_mod) / (np.abs(C) @ np.abs(y_mod))))
    xh = x1_up[rows] / math.sqrt(n)
    p_host = association.linear_reg1d_pvals(
        C.sum(axis=1), (C * C).sum(axis=1), C @ y_mod + xh * (C * C).sum(axis=1),
        y_mod.sum() + xh * C.sum(axis=1),
        y_mod @ y_mod + xh * xh * (C * C).sum(axis=1) + 2 * xh * (C @ y_mod), n)
    lg, lh = np.log10(pv["loo"][rows] + 1e-300), np.log10(p_host + 1e-300)
    lp_err = float(np.max(np.abs(lg - lh) / (1.0 + np.abs(lh))))
    log(f"[modes {dtype}] LOO statistics of 4,096 rows against f64 on the host: code sums "
        f"equal; X y_mod max error {xy_err:.2e} of sum |x||y_mod|; log10 p max error "
        f"{lp_err:.2e} of 1 + |log10 p|")
    check(xy_err < KERNEL_TOL and lp_err < 1e-3, f"{dtype} LOO disagrees with f64")

    t0 = time.perf_counter()
    tcfg = dataclasses.replace(cfg, estimate_file=os.path.join(
        out_dir, f"main_{dtype}_eigen_it_1.bin"), test_iter_range=[1, test_runs])
    before = launches()
    rows_t = test_mode.run_test_linear(ds, tcfg)
    t_test = time.perf_counter() - t0
    passes = launches()[MODE_KERNELS[dtype][2]] - before[MODE_KERNELS[dtype][2]]
    check(len(rows_t) == test_runs and bool(np.all(np.isfinite(rows_t))),
          f"{dtype} test: bad rows")
    check(passes == 1, f"{dtype} test: {test_runs} estimates took {passes} passes, want 1")

    pred_est = os.path.join(out_dir, f"pred_{dtype}_it_1.bin")
    read_bin_slab(est, m).tofile(pred_est)
    t0 = time.perf_counter()
    z = predict.run_predict(ds, dataclasses.replace(cfg, estimate_file=pred_est))
    t_pred = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"pred_{dtype}_.yhat")) as f:
        lines = f.read().split()
    check(len(lines) == n and bool(np.all(np.isfinite(z))), f"{dtype} predict: bad .yhat")
    torch.cuda.synchronize()
    counts = launches()
    log(f"[modes {dtype}] test over {test_runs} estimates in {t_test:.3f}s (R2 "
        f"{np.round([r[0] for r in rows_t], 4).tolist()}); predict in {t_pred:.3f}s; kernel "
        f"launches of the modes {({k: c for k, c in counts.items() if c})}")
    for k in MODE_KERNELS[dtype]:
        check(k is None or counts[k] > 0, f"{dtype} modes: {k} never launched")
    return recs, ({name: counts[name]} if name is not None else {})


# ---------------------------------------------------------------------------
# phase 7: the Gibbs warm start

GIBBS_B, GIBBS_L = 256, 4
# the kernel against its plain version: the components equal, and x to 1e-6
# of its largest value (the f64 log and exp of CUDA's library and of the
# host's, then x rounded to the work dtype)
GIBBS_X_TOL = 1e-6
# calls in a sample of the wrapper's host time (queued, far below the queue's depth)
GIBBS_HOST_CALLS = 100
# card against CPU, one sweep from one state with the same draws: r0 and the
# passes sum in another order, so a draw whose u_j lies within that rounding
# of a cumulative weight may flip; at most this many of 16,384 components
# per sweep, and x to 1e-4 of its largest value where they agree (a flip
# moves the following markers of its block through c, by its own size
# times their correlation)
GIBBS_FLIPS, GIBBS_PARITY_TOL = 8, 1e-4
# card against CPU, a bf16 design's block Grams: f32 products of the upcast
# codes summed in another order (cuBLAS against the host's BLAS), held to
# |card - cpu| <= rtol |cpu| + atol, the f32 Gram bar of tests/test_torch_gibbs.py
GIBBS_GRAM_RTOL, GIBBS_GRAM_ATOL = 2e-5, 2e-6


def gibbs_inputs(dev, B: int, L: int, masked: int, seed: int, Gb=None, r0=None) -> tuple:
    """block_update's arguments on the card: a Gram of B random markers
    (or the given one), r0, x, u and z from the seed, `masked` markers with
    mmask 0, pi from a Dirichlet, the decade ladder, sigma_g 1.7, sigma_e
    0.4 (f32 work dtype)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if Gb is None:
        A = torch.randn((B, 300), device=dev, generator=g) / math.sqrt(300)
        Gb = A @ A.T
    if r0 is None:
        r0 = 2.0 * torch.randn(B, device=dev, generator=g)
    mm = torch.ones(B, device=dev)
    mm[torch.randperm(B, device=dev, generator=g)[:masked]] = 0.0
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    return (Gb, r0, 0.3 * torch.randn(B, device=dev, generator=g), mm,
            torch.rand(B, device=dev, generator=g), torch.randn(B, device=dev, generator=g),
            torch.as_tensor(rng.dirichlet(np.ones(L)), **f64),
            torch.as_tensor(gibbs.decade_cvars(L), **f64),
            torch.tensor(1.7, **f64), torch.tensor(0.4, **f64))


def gibbs_reference(src: str) -> Callable:
    """gibbs_block_update through an earlier version of csrc/gibbs_block.cu
    (the same C entry points), built from `src` with the port's nvcc flags:
    a callable with the wrapper's arguments, giving (xb, comp).  c goes to
    global scratch by that version's own rule (4 B + 32 L bytes of shared
    memory past the limit)."""
    tag = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    out = str(_build.BUILD_DIR / f"gibbs_block_reference-{tag}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       capture_output=True, text=True)
    check(r.returncode == 0,
          f"the reference gibbs kernel {src} did not build:\n{r.stdout}{r.stderr}")
    log(f"[gibbs] reference kernel {src} built in {time.perf_counter() - t0:.1f}s")
    lib = ctypes.CDLL(out)
    for name in ("gibbs_block_f32_launch", "gibbs_block_f64_launch"):
        getattr(lib, name).argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int]
                                       + [ctypes.c_void_p] * 4)

    def call(Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e):
        B, L = xb0.shape[0], pi.shape[0]
        xb = torch.empty_like(xb0)
        comp = torch.empty(B, dtype=torch.int32, device=Gb.device)
        scratch = (torch.empty(B, dtype=torch.float32, device=Gb.device)
                   if 32 * L + 4 * B > SMEM_BYTES else None)
        fn = getattr(lib, "gibbs_block_f64_launch" if xb0.dtype == torch.float64
                     else "gibbs_block_f32_launch")
        err = fn(*[t.data_ptr() for t in (Gb, r0, xb0, mmask_b, u, z, pi, cvars, sigma_g, sigma_e)],
                 B, L, xb.data_ptr(), comp.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        _build.check_launch(err, f"reference gibbs_block at B={B}, L={L}")
        return xb, comp
    return call


def check_gibbs_kernel(args: tuple, tag: str, timed: bool, ref: Callable | None = None) -> dict:
    """gibbs_block_update against its plain version on the same card
    tensors: the components equal, x within GIBBS_X_TOL of its largest
    value, masked markers at 0, bitwise repeatable; when timed, kernel and
    plain by CUDA events in turns (the kernel's samples are the mean of 5
    back-to-back calls), and the host's time a call.  With a reference kernel
    (`gibbs_reference`), x and the components bitwise equal to its, and when
    timed the two kernels in turns (reference, kernel, kernel, reference)."""
    B, L = args[2].shape[0], args[6].shape[0]
    x, k = gibbs_block_update(*args)
    px, pk = gibbs_block_update_plain(*args)
    torch.cuda.synchronize()
    if ref is not None:
        rx, rk = ref(*args)
        torch.cuda.synchronize()
        same = torch.equal(x, rx) and torch.equal(k, rk)
        log(f"[gibbs] kernel {tag} B={B} L={L}: bitwise equal to the reference kernel {same}")
        check(same, f"gibbs_block_update differs from the reference kernel at {tag} B={B} L={L}")
    err = float((x - px).abs().max())
    scale = float(px.abs().max())
    masked = args[3] == 0
    log(f"[gibbs] kernel {tag} B={B} L={L} ({int(masked.sum())} masked): components equal "
        f"{bool(torch.equal(k, pk))}, x max abs diff {err:.3g} of max |x| {scale:.4g} "
        f"(tolerance {GIBBS_X_TOL:g} of it); components drawn {torch.bincount(k, minlength=L).tolist()}")
    check(torch.equal(k, pk), f"gibbs_block_update components differ from plain at {tag}")
    check(err <= GIBBS_X_TOL * scale, f"gibbs_block_update x differs from plain at {tag}")
    check(bool((x[masked] == 0).all()) and bool((k[masked] == 0).all()),
          f"gibbs_block_update: masked markers not at 0 at {tag}")
    x2, k2 = gibbs_block_update(*args)
    check(torch.equal(x, x2) and torch.equal(k, k2), f"gibbs_block_update not repeatable at {tag}")
    rec = dict(max_abs_err=err)
    if timed:
        ms, plain_ms, t_kern, t_plain = in_turns(lambda: gibbs_block_update(*args),
                                                 lambda: gibbs_block_update_plain(*args))
        least_ms, least_by = bound("gibbs_block_update", args[0], L)
        log(f"[gibbs] kernel {tag}: {ms * 1e3:.1f} us a block, {ms * 1e6 / B:.0f} ns a marker "
            f"step (bound {least_ms * 1e3:.3f} us by {least_by}, {100 * least_ms / ms:.2f}% of "
            f"it); plain {plain_ms:.3f} ms; runs {t_kern} / {t_plain}")
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=least_ms, bound_by=least_by,
                   library_ms=None)
        # the host's time a call, enqueue only (its checks, the allocations
        # and the launch): its share of a sweep's host time a block
        host = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GIBBS_HOST_CALLS):
                gibbs_block_update(*args)
            host.append((time.perf_counter() - t0) * 1e6 / GIBBS_HOST_CALLS)
        torch.cuda.synchronize()
        log(f"[gibbs] kernel {tag}: host time a call (enqueue, no synchronise) "
            f"{np.median(host):.1f} us; runs {np.round(host, 1).tolist()}")
        if ref is not None:
            t_ref = [card_ms(lambda: ref(*args), calls=KERNEL_CALLS)]
            t_new = [card_ms(lambda: gibbs_block_update(*args), calls=KERNEL_CALLS)
                     for _ in range(2)]
            t_ref.append(card_ms(lambda: ref(*args), calls=KERNEL_CALLS))
            ref_ms, new_ms = float(np.median(t_ref)), float(np.median(t_new))
            log(f"[gibbs] kernel {tag}: reference {ref_ms * 1e3:.1f} us, this kernel "
                f"{new_ms * 1e3:.1f} us a block in turns ({ref_ms / new_ms:.2f}x); runs "
                f"reference {t_ref}, kernel {t_new}")
    return rec


# ragged (B, L, masked markers) of phase 7's kernel check: tails of the
# kernel's sub-blocks of 32 markers, one component a lane and lanes looping
# over L past 32
GIBBS_RAGGED = ((1, 2, 0), (33, 33, 2), (100, 6, 7), (257, 4, 9), (1500, 2, 30), (1500, 6, 0))


def phase_gibbs_kernel(main: MainPath, reference: str = "") -> dict:
    """The kernel at the main path's shape, B = 256 and L = 4, on two real
    blocks of the main path's quantized design (block 0, timed, and a middle
    one: their Grams, r0 = A_b^T y_resid of the cold start), then at the
    GIBBS_RAGGED shapes; with `reference`, an earlier gibbs_block.cu, each
    also bitwise against that kernel and block 0 timed against it in turns.
    Returns block 0's record with the largest error of all."""
    dm, y = main.dataset.dm, main.dataset.phen.y
    dev = dm.device
    ref = gibbs_reference(reference) if reference else None
    if ref is None:
        log("[gibbs] no reference kernel given (--gibbs-reference): checked against plain only")
    y_resid = torch.as_tensor(y - y.mean(), dtype=torch.float32, device=dev)
    rec = None
    for b in (0, dm.m_pad // GIBBS_B // 2):
        d = gibbs._block_dm(dm, b, GIBBS_B)
        Gb = gibbs._quantized_gram(d, torch.tensor(dm.n, dtype=torch.float32, device=dev))
        args = gibbs_inputs(dev, GIBBS_B, GIBBS_L, 0, SEED + b, Gb=Gb, r0=atx(d, y_resid))
        r = check_gibbs_kernel(args, f"north-star block {b}", timed=rec is None, ref=ref)
        rec = r if rec is None else {**rec, "max_abs_err": max(rec["max_abs_err"],
                                                                r["max_abs_err"])}
    for B, L, masked in GIBBS_RAGGED:
        r = check_gibbs_kernel(gibbs_inputs(dev, B, L, masked, SEED + B), "ragged", timed=False,
                               ref=ref)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
    return rec


def phase_gibbs_parity(dev, dtype: str, m: int = 16_384, n: int = 2_048, sweeps: int = 3) -> None:
    """Card against CPU at M x N (data_sim): the block Grams (quantized:
    bitwise; bf16: f32 products of the upcast codes, to f32 rounding),
    then `sweeps` sweeps, each from the card's state on both devices with
    the same draws (TorchDraws of one seed)."""
    t0 = time.perf_counter()
    fx = simulate_iid(n=n, m=m, lam=0.05, h2=0.6, seed=SEED)
    y = fx.y / np.std(fx.y, ddof=1)
    dms = {d: build_design(fx.X.T, compute_dtype=PARITY_DTYPES[dtype], device=d)
           for d in (dev, "cpu")}
    grams = {d: gibbs.build_block_grams(dm, block=GIBBS_B) for d, dm in dms.items()}
    gc, gh = grams[dev].cpu(), grams["cpu"]
    if dtype in DTYPES:
        check(torch.equal(gc, gh), f"gibbs {dtype}: card Grams differ")
    else:
        diff = (gc - gh).abs()
        log(f"[gibbs] {dtype} card vs cpu block Grams: max |diff| {float(diff.max()):.3g} of max "
            f"|G| {float(gh.abs().max()):.4g} (rtol {GIBBS_GRAM_RTOL:g}, atol {GIBBS_GRAM_ATOL:g})")
        check(bool((diff <= GIBBS_GRAM_RTOL * gh.abs() + GIBBS_GRAM_ATOL).all()),
              f"gibbs {dtype}: card Grams past f32 rounding")
    cvars = gibbs.decade_cvars(GIBBS_L)
    state = gibbs.init_state(dms["cpu"], y, GIBBS_L)
    flips, errs = [], []
    for i in range(sweeps):
        out = {}
        for d, dm in dms.items():
            out[d] = gibbs.gibbs_sweep(dm, grams[d], gibbs.GibbsState(*[t.to(d) for t in state]),
                                       torch.as_tensor(cvars).to(d), gibbs.TorchDraws(SEED + i),
                                       torch.as_tensor(y, dtype=torch.float32).to(d),
                                       block=GIBBS_B)
        (a, sa), (b, sb) = out[dev], out["cpu"]
        ac, ax_ = a.comp.cpu(), a.x.cpu()
        agree = ac == b.comp
        flips.append(int((~agree).sum()))
        errs.append(float((ax_[agree] - b.x[agree]).abs().max()) / float(b.x.abs().max()))
        check(flips[-1] <= GIBBS_FLIPS and errs[-1] <= GIBBS_PARITY_TOL,
              f"gibbs {dtype} sweep {i + 1}: card and cpu disagree ({flips[-1]} components, "
              f"x {errs[-1]:.3g})")
        if flips[-1] == 0:  # a flip changes the gamma and Dirichlet shapes
            hyper = np.abs(np.array([sa.sigma_g, sa.sigma_e]) / np.array(
                [sb.sigma_g, sb.sigma_e]) - 1.0)
            check(sa.m_incl == sb.m_incl and hyper.max() <= GIBBS_PARITY_TOL,
                  f"gibbs {dtype} sweep {i + 1}: card and cpu hyperparameters disagree")
        state = [t.cpu() for t in a]
    log(f"[gibbs] {dtype} card vs cpu at M={m} N={n}, {sweeps} sweeps from the card's state: "
        f"components differing {flips} (at most {GIBBS_FLIPS}), x max diff {np.round(errs, 9)} of "
        f"max |x| (tolerance {GIBBS_PARITY_TOL:g}); m_incl {sa.m_incl}; "
        f"{time.perf_counter() - t0:.1f}s")


GIBBS_PASSES = {"int8": ("atx_int8", "ax_batch_int8"), "int4": ("atx_packed4", "ax_batch_packed4"),
                "bf16": ("atx_bf16", "ax_batch_bf16")}


def check_gibbs_block_kernels(dm, dtype: str, y) -> None:
    """The sweep's two block passes at the sweep's own shapes: block 0 of
    dm (GIBBS_B rows at full width), atx at K = 1 on y (the first sweep's
    residual) and ax_batch at K = 1 on a random block vector, each against
    its plain version and the f64 product on the same inputs (check_kernel:
    KERNEL_TOL of sum |x||v|, bitwise repeatable)."""
    d0 = gibbs._block_dm(dm, 0, GIBBS_B)
    g = torch.Generator(device=dm.device).manual_seed(SEED + 9)
    atx_name, ax_name = GIBBS_PASSES[dtype]
    check_kernel(atx_name, d0.X, torch.as_tensor(y, dtype=torch.float32,
                                                 device=dm.device)[:, None], timed=False)
    check_kernel(ax_name, d0.X, torch.randn((GIBBS_B, 1), device=dm.device, generator=g),
                 timed=False)


def phase_gibbs_main(dtype: str, main: MainPath, out_dir: str, sweeps: int) -> dict:
    """run_gibbs at full width on the main path's planted design (B = 256,
    L = 4), the CSV, .bet and .grm in out_dir; first the block passes'
    kernels against their plain versions at a block's shape
    (check_gibbs_block_kernels), then launches counted from 0 just before
    the run and read just after, checked exactly: nb kernel launches and nb
    passes each way a sweep.  Prints the Gram build, the sweeps' seconds,
    peak memory, h2 and m_incl per sweep, then the host syncs of one more
    sweep (torch's sync debug mode).  Returns the launches."""
    dm, y = main.dataset.dm, main.dataset.phen.y
    dev = dm.device
    nb = dm.m_pad // GIBBS_B
    check_gibbs_block_kernels(dm, dtype, y)
    block = ""
    if dm.X.dtype in QUANTIZED:  # a block Gram's integer product, timed alone
        d0 = gibbs._block_dm(dm, 0, GIBBS_B)
        Xq = d0.X if d0.X.dtype == torch.int8 else gibbs.unpack_rows(d0.X, torch.int8)
        int_mm_ms = card_ms(lambda: gibbs._codes_product(Xq), reps=5, warmup=1,
                            calls=KERNEL_CALLS)
        n_dev = torch.tensor(float(dm.n), dtype=torch.float32, device=dev)
        block_ms = card_ms(lambda: gibbs._quantized_gram(d0, n_dev), reps=5, warmup=1,
                           calls=KERNEL_CALLS)
        block = f" (a block: torch._int_mm {int_mm_ms:.4f} ms, the whole Gram {block_ms:.4f} ms)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    res = run_gibbs(dm, y, iterations=sweeps, burnin=sweeps - 1, l_comp=GIBBS_L, block=GIBBS_B,
                    seed=SEED, out_dir=os.path.join(out_dir, f"gibbs_{dtype}"), out_name="g",
                    verbose=False)
    torch.cuda.synchronize()
    counts = launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rows = [line.split(",") for line in open(res.csv_path).read().splitlines()]
    h2 = [float(r[4]) for r in rows]
    m_incl = [int(r[5]) for r in rows]
    secs = list(res.sweep_seconds)
    log(f"[gibbs {dtype}] M={dm.m_pad} N={int(dm.n)}: {nb} block Grams (B={GIBBS_B}, "
        f"{nb * GIBBS_B * GIBBS_B * 4 / 2**30:.2f} GiB) in {res.gram_seconds:.3f}s{block}; "
        f"sweep seconds "
        f"{[round(t, 3) for t in secs]} (median of sweeps 2..{sweeps}: "
        f"{float(np.median(secs[1:])):.3f}s, {float(np.median(secs[1:])) * 1e9 / dm.m_pad:.0f} "
        f"ns a marker); peak memory {peak:.2f} GiB; h2 {np.round(h2, 4).tolist()}, m_incl "
        f"{m_incl}; kernel launches {({k: c for k, c in counts.items() if c})}")
    want = {"gibbs_block_update": sweeps * nb, **{k: sweeps * nb for k in GIBBS_PASSES[dtype]}}
    check({k: c for k, c in counts.items() if c} == want,
          f"gibbs {dtype}: launches {counts}, want {want}")
    check(all(np.isfinite(h2)) and all(0.0 < v < 1.0 for v in h2) and len(rows) == sweeps,
          f"gibbs {dtype}: h2 not finite in (0, 1)")
    for f in (res.bet_path, res.grm_path):
        check(os.path.getsize(f) > 0, f"gibbs {dtype}: {f} empty")
    check(bool(np.all(np.isfinite(res.x_mean_file))), f"gibbs {dtype}: posterior mean not finite")
    # the host syncs of one sweep: torch's sync debug mode warns at each
    grams = gibbs.build_block_grams(dm, block=GIBBS_B)
    state = gibbs.init_state(dm, y, GIBBS_L)
    cvars = torch.as_tensor(gibbs.decade_cvars(GIBBS_L)).to(dev)
    draws = gibbs.TorchDraws(SEED)
    y_dev = torch.as_tensor(y, dtype=torch.float32, device=dev)
    # where a sweep's time goes: the host's enqueue of the block loop (no
    # synchronise) against the synced wall; close to it means host-bound
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = gibbs.gibbs_sweep(dm, grams, state, cvars, gibbs.TorchDraws(SEED), y_dev,
                              block=GIBBS_B)
    wall = time.perf_counter() - t0
    enq = st.enqueue_s
    log(f"[gibbs {dtype}] one more sweep: the host enqueued its {nb} blocks in {enq:.4f}s "
        f"({enq * 1e6 / nb:.1f} us a block, no synchronise), wall {wall:.4f}s: enqueue "
        f"{100 * enq / wall:.1f}% of the wall")
    syncs = host_syncs(lambda: gibbs.gibbs_sweep(dm, grams, state, cvars, draws, y_dev,
                                                 block=GIBBS_B))
    log(f"[gibbs {dtype}] host syncs in one sweep of {nb} blocks (torch's sync debug mode): "
        f"{syncs}")
    check(syncs == 1, f"gibbs {dtype}: {syncs} host syncs in a sweep, want 1 (its fetch)")
    del grams, state
    torch.cuda.empty_cache()
    return counts


def phase_gibbs_workflow(dev, log_dir: str, n: int = 2_000, m: int = 8_000, sweeps: int = 40,
                         iters: int = 8) -> None:
    """The warm start through files, int8: the Gibbs CLI (`sweeps` sweeps,
    the second half kept), conf_gibbs_init over that window, pip on the
    .bet, and the CLI's eigen inference from the .conf.  Every file exists
    and is finite; the run's iteration-1 prior is the .conf's; the x1
    correlation rises."""
    with tempfile.TemporaryDirectory(prefix="vampomi_gibbs_") as d:
        fx = simulate_iid(n=n, m=m, lam=0.1, h2=0.8, seed=SEED)
        paths = write_fixture(fx, d, "ex")
        common = ["--meth-file", paths["bin"], "--phen-file", paths["phen"], "--N", str(n),
                  "--Mt", str(m), "--out-dir", d, "--device", str(dev)]
        t0 = time.perf_counter()
        with engine_log(log_dir, "gibbs_cli"):
            check(gibbs_cli.main(common + ["--out-name", "g", "--iterations", str(sweeps),
                                           "--burnin", str(sweeps // 2), "--compute-dtype",
                                           "int8"]) == 0, "gibbs cli returned non-zero")
            t_gibbs = time.perf_counter() - t0
            window = f"{sweeps // 2}:{sweeps}"
            conf = conf_gibbs_init.main(["-csv", os.path.join(d, "g.csv"), "-grm",
                                         os.path.join(d, "g.grm"), "-out_dir", d,
                                         "-iterations", window])
            pips = pip.main(["-bet", os.path.join(d, "g.bet"), "-iterations", window])
        rows = [line.split(",") for line in open(os.path.join(d, "g.csv")).read().splitlines()]
        vals = np.array([[float(v) for v in r] for r in rows])
        check(vals.shape == (sweeps, 12) and bool(np.all(np.isfinite(vals))), "gibbs csv bad")
        check(os.path.getsize(os.path.join(d, "g.bet")) == 4 + sweeps * (4 + 8 * m), "gibbs .bet")
        grm = [float(v) for v in open(os.path.join(d, "g.grm")).read().split()]
        check(len(grm) == 4 and all(np.isfinite(grm)), "gibbs .grm bad")
        pipf = np.fromfile(os.path.join(d, "g.pip"))
        check(pipf.shape == (m,) and bool(np.all(np.isfinite(pipf))) and np.array_equal(pipf, pips),
              "gibbs .pip bad")
        prior = cli.load_init_conf(conf)
        out = "warm"
        argv = common + ["--run-mode", "infere", "--true-signal-file", paths["ts"],
                         "--out-name", out, "--iterations", str(iters), "--stop-criteria-thr",
                         "0", "--init-conf", conf, "--lmmse-solver", "eigen",
                         "--compute-dtype", "int8"]
        t1 = time.perf_counter()
        with engine_log(log_dir, "gibbs_init_conf"):
            check(cli.main(argv) == 0, "cli --init-conf returned non-zero")
        t_vamp = time.perf_counter() - t1
        want = {f"{out}_{s}.csv" for s in ("metrics", "params", "prior")} | {f"{out}_trace.jsonl"}
        want |= {f"{out}_{k}it_{i}.bin" for k in ("", "r1_") for i in range(1, iters + 1)}
        have = {f for f in os.listdir(d) if f.startswith(out + "_")}
        check(have == want, f"cli --init-conf: files {sorted(have ^ want)} differ")
        for f in sorted(want):
            p = os.path.join(d, f)
            if f.endswith(".bin"):
                check(bool(np.all(np.isfinite(read_bin_slab(p, m)))), f"{f} not finite")
            elif f.endswith(".csv"):
                check(bool(np.all(np.isfinite(read_positional_csv(p)))), f"{f} not finite")
        first = read_positional_csv(os.path.join(d, f"{out}_prior.csv"))[0]
        L = len(prior["probs"])
        check(int(first[1]) == L and np.allclose(first[2:2 + L], prior["probs"], rtol=1e-9)
              and np.allclose(first[2 + L:2 + 2 * L], prior["vars"], rtol=1e-9, atol=0),
              f"cli --init-conf: iteration 1's prior {first} is not the .conf's {prior}")
        x1c = [r[2] for r in read_positional_csv(os.path.join(d, f"{out}_metrics.csv"))]
        log(f"[gibbs] workflow N={n} M={m}: gibbs cli {sweeps} sweeps {t_gibbs:.1f}s (h2 "
            f"{vals[-1, 4]:.4f}, m_incl {int(vals[-1, 5])}); .conf h2 {prior['h2']:.4f}, probs "
            f"{np.round(prior['probs'], 5).tolist()}; pip of {int((pipf > 0.5).sum())} markers > "
            f"0.5; --init-conf eigen run {t_vamp:.1f}s, x1 corr {np.round(x1c, 4).tolist()}")
        check(x1c[-1] > x1c[0], "cli --init-conf: x1 correlation did not rise")


# ---------------------------------------------------------------------------
# phase 10: ranks — the main path with the markers split over processes


ROOT = os.path.dirname(os.path.abspath(__file__))
RANK_CHUNK = 65_536  # rows of the north-star design made from one seed
# (label, solver, iterations, the solver that must run) of the runs of phase
# 10 (a): eigen writes the eigen cache, auto then loads it (warm: eigen)
RANK_RUNS = (("eigen", "eigen", 4, "eigen"), ("auto_warm", "auto", 4, "eigen"),
             ("spectral", "spectral", 2, "spectral"), ("cg", "cg", 2, "cg"))
NCCL_RUNS = (("eigen", "eigen", 4, "eigen"), ("cg", "cg", 2, "cg"))
# probit on the planted labels: eigen on the cache the linear eigen run
# wrote (warm), CG
PROBIT_RANK_RUNS = (("eigen", "eigen", 4, "eigen"), ("cg", "cg", 2, "cg"))
# the run modes on the one-process linear eigen run's dumps of iteration
# RANK_MODES_K (test over its iterations 1..RANK_MODES_K: one batched pass)
RANK_MODES = ("se", "loo", "loo_std", "test", "predict")
RANK_MODES_K = 4
# each mode's launches a rank, and its collectives (the one all_reduce of
# its pass over X; SE reads no X)
MODE_LAUNCHES = {"se": {}, "loo": {"row_moments_int8": 1, "atx_int8": 1, "ax_batch_int8": 1},
                 "loo_std": {"row_moments_int8": 1, "atx_int8": 1, "ax_batch_int8": 1},
                 "test": {"ax_batch_int8": 1}, "predict": {"ax_batch_int8": 1}}
MODE_COLLECTIVES = {"se": 0, "loo": 1, "loo_std": 1, "test": 1, "predict": 1}
# across rank counts, f32 sums over markers in another order: the JAX
# package's bar for an f32 work dtype across process counts
# (tests/test_multihost.py:186-190), and for CG the card-against-CPU one
# (PARITY_RTOL: it stops at rel-residual 1e-5 and may stop a step apart)
RANK_RTOL = {"eigen": 1e-4, "spectral": 1e-4, "cg": PARITY_RTOL["cg"]}
RANK_ATOL = 2e-6


def within(a: np.ndarray, b: np.ndarray, rtol: float, atol: float | None = None) -> bool:
    """|a - b| <= rtol |b| + atol elementwise; atol None: rtol times b's
    largest entry (an entry near 0 carries only the vector's absolute
    accuracy: at N = 2,000 the f32 sums in another order move r1's entries
    by up to 3e-6 of its 0.25, on the CPU)."""
    atol = rtol * float(np.abs(b).max()) if atol is None else atol
    return bool(a.shape == b.shape and np.all(np.abs(a - b) <= rtol * np.abs(b) + atol))


def rank_codes(lo: int, hi: int, dev) -> torch.Tensor:
    """Rows [lo, hi) of the int8 north-star design, made on the card: chunk
    c of RANK_CHUNK rows from its own seed, so a rank makes only its own
    rows and every rank count gives the same design."""
    X = torch.empty((hi - lo, NS_N), dtype=torch.int8, device=dev)
    for c in range(lo // RANK_CHUNK, (hi - 1) // RANK_CHUNK + 1):
        a, b = c * RANK_CHUNK, min((c + 1) * RANK_CHUNK, NS_M)
        chunk = random_codes(b - a, NS_N, torch.int8, SEED + 100 + c, dev)
        s, e = max(a, lo), min(b, hi)
        X[s - lo:e - lo] = chunk[s - a:e - a]
        del chunk
    return X


def rank_iteration_collectives(solver: str, k: int, steps: list[int]) -> list[int]:
    """The collectives of each iteration of a sharded linear run with the EM
    update off: an exact solver's alpha1, its ax_batch pass and the error
    measures (3); CG's alpha1, ax of x1, x2 and the probe (3), the probe's
    alpha2 and the error measures (2), the solve's start (its residual's
    pass and one batch) and 3 a CG step (⟨d, p⟩, the step's batch, the
    pass)."""
    return [3] * k if solver != "cg" else [8 + 3 * s for s in steps]


def probit_iteration_collectives(solver: str, k: int, steps: list[int]) -> list[int]:
    """The same for a probit run, whose EM update runs from iteration 2:
    an exact solver's alpha1, its ax_batch pass and the late sums (3); CG's
    alpha1, A x1, the solve's start (2), alpha2, A x2 and the late sums
    (7) and 3 a CG step; one more for the EM update."""
    base = [3] * k if solver != "cg" else [7 + 3 * s for s in steps]
    return [c + (i > 0) for i, c in enumerate(base)]


def probit_launches(solver: str, k: int, steps: list[int], rows: int) -> dict:
    """A probit run's launches on `rows` rows of the int8 design: exact,
    atx_int8 2 and ax_batch_int8 1 an iteration and the Gram's
    (gram_launches); CG, A^T p2 an iteration, ax of x1 and x2 and the
    initial residual's pass, then one pass each way a CG step."""
    if solver != "cg":
        return {"atx_int8": 2 * k, "ax_batch_int8": k, **gram_launches(solver, rows)}
    return {"atx_int8": k, "ax_batch_int8": sum(steps) + 3 * k, "atx_batch_int8": sum(steps) + k}


def _counted(shard, fn):
    """fn()'s result, its kernel launches (counted from 0) and the
    collectives it ran on `shard`, and its seconds."""
    reset_launches()
    c0 = shard.collectives() if shard is not None else 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (out, {n: c for n, c in launches().items() if c},
            (shard.collectives() - c0) if shard is not None else None, secs)


def _factor_reading(into: dict) -> Callable:
    """engine/linear.py build_lmmse_factor, and what the rank holds right
    after an eigen setup into `into`: U's shape and the bytes of its
    storage, and torch.cuda.memory_allocated."""
    build = linear_engine.build_lmmse_factor

    def reading(dm, cfg, solver, setup):
        solver, fac = build(dm, cfg, solver, setup)
        if solver == "eigen":
            torch.cuda.synchronize()
            into.update(u_shape=list(fac.U.shape), u_bytes=fac.U.untyped_storage().nbytes(),
                        after_setup_bytes=torch.cuda.memory_allocated(dm.device))
        return solver, fac
    return reading


def rank_tag_runs(spec: dict, tag: str, runs, dm, problem: dict) -> dict:
    """One group's (or one process's) runs of phase 10 (a) on its design dm:
    the linear `runs`, probit on the planted labels (PROBIT_RANK_RUNS), and
    the run modes on the one-process linear eigen run's dumps; each with its
    launches counted from 0, its collectives and its seconds."""
    from vampomi_tpu_torch import sharding

    shard = dm.shard
    dev = dm.device
    rank = 0 if shard is None else shard.rank
    out_dir = spec["out_dir"]
    cache = os.path.join(out_dir, f"{tag}_eigen.npz")
    y, beta = problem["y"], problem["beta"]
    common = dict(stop_criteria_thr=0.0, learn_vars=0, CG_max_iter=50, device=str(dev),
                  seed=SEED, eigen_cache=cache)
    lin = []
    for label, solver, k, _ in runs:
        name = f"{tag}_{label}"
        cfg = RunConfig(out_dir=out_dir, out_name=name, iterations=k, lmmse_solver=solver,
                        learn_prior_delay=k, **problem["prior"], **common)
        torch.cuda.reset_peak_memory_stats(dev)
        factor = {}
        with engine_log(spec["log_dir"], f"{name}_rank{rank}"), mock.patch.object(
                linear_engine, "build_lmmse_factor", _factor_reading(factor)):
            res, count, _, _ = _counted(shard, lambda: infere_linear(dm, y, cfg, true_signal=beta))
        lin.append(dict(label=label, solver=res.solver, gamw=float(res.gamw).hex(), **factor,
                        lam_sum=(float(res.setup["eigen_lam_sum"]).hex()
                                 if "eigen_lam_sum" in res.setup else None),
                        loaded="eigen_cache_load" in res.setup, seconds=res.iter_seconds,
                        collectives=res.iter_collectives, launches=count,
                        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                        x1_corr=[float(r[1]) for r in res.metrics_history]))
    prob = []
    for label, solver, k, _ in PROBIT_RANK_RUNS:
        name = f"{tag}_probit_{label}"
        cfg = RunConfig(out_dir=out_dir, out_name=name, model="bin_class", iterations=k,
                        lmmse_solver=solver, rho=0.3, gam1=1e-2, **problem["pprior"], **common)
        with engine_log(spec["log_dir"], f"{name}_rank{rank}"):
            res, count, _, _ = _counted(shard, lambda: infere_bin_class(
                dm, problem["y01"], cfg, true_signal=beta))
        prob.append(dict(label=label, solver=res.solver, gam1=float(res.gam1).hex(),
                         tau1=float(res.tau1).hex(),
                         lam_sum=(float(res.setup["eigen_lam_sum"]).hex()
                                  if "eigen_lam_sum" in res.setup else None),
                         loaded="eigen_cache_load" in res.setup, seconds=res.iter_seconds,
                         collectives=res.iter_collectives, launches=count,
                         metrics=[[float(v) for v in r] for r in res.metrics_history]))
    # the run modes, every group on the one-process eigen run's files
    src = os.path.join(out_dir, "r1_eigen")
    k = RANK_MODES_K
    pred = os.path.join(out_dir, f"{tag}_pred_it_{k}.bin")  # .yhat lands beside it
    if rank == 0:
        shutil.copyfile(f"{src}_it_{k}.bin", pred)
    sharding.barrier(shard)
    ds = Dataset(dm=dm, phen=Phenotype(y=y, intercept=0.0, scale=1.0), covariates=None,
                 qscale=np.ones(NS_M))  # codes: scale 1
    cfg = RunConfig(out_dir=out_dir, out_name=f"{tag}_modes", N=NS_N, Mt=NS_M, N_test=NS_N,
                    gam1=read_positional_csv(f"{src}_params.csv")[k - 1][2],
                    r1_file=f"{src}_r1_it_{k}.bin", estimate_file=f"{src}_it_{k}.bin",
                    device=str(dev))
    calls = {m: (lambda m=m: association.run_association_test(
        ds, dataclasses.replace(cfg, pval_method=m))) for m in ("se", "loo", "loo_std")}
    calls["test"] = lambda: test_mode.run_test_linear(ds, dataclasses.replace(
        cfg, estimate_file=f"{src}_it_1.bin", test_iter_range=[1, k]))
    calls["predict"] = lambda: predict.run_predict(ds, dataclasses.replace(
        cfg, estimate_file=pred))
    modes = {}
    for mode in RANK_MODES:
        _, count, coll, secs = _counted(shard, calls[mode])
        modes[mode] = dict(launches=count, collectives=coll, seconds=secs)
    return dict(rank=rank, slab=[0, NS_M] if shard is None else [shard.lo, shard.hi],
                runs=lin, probit=prob, modes=modes, all_reduce_ms=None,
                backend=None if shard is None else shard.backend)


def _all_reduce_ms(shard, dev) -> float:
    """One (N, 2) f32 all_reduce under the shard's backend: the median of 20
    after 3 warm-ups, the host clock around it and a synchronise."""
    import torch.distributed as dist

    t = torch.ones((NS_N, 2), device=dev)
    times = []
    for i in range(23):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        dist.all_reduce(t, group=shard.group)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(1e3 * (time.perf_counter() - ta))
    return float(np.median(times))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ranks_worker(spec_path: str) -> int:
    """One process of phase 10 (a): under VAMPOMI_DISTRIBUTED=1 a rank of
    torch.distributed.run's group on its slab, else one process without a
    group, which then joins a process group of its own as its one NCCL rank
    (world size 1) and runs spec["nccl"] on the same design again.  Builds
    its rows of the design, runs rank_tag_runs and writes each group's
    results to <out_dir>/<tag>_rank<r>.json."""
    import torch.distributed as dist

    from vampomi_tpu_torch import sharding

    with open(spec_path) as f:
        spec = json.load(f)
    distributed = os.environ.get("VAMPOMI_DISTRIBUTED") == "1"
    dev = resolve_device(sharding.init_from_env("cuda") if distributed else "cuda")
    shard = sharding.shard_for(NS_M, dev)
    lo, hi = (0, NS_M) if shard is None else (shard.lo, shard.hi)
    t0 = time.perf_counter()
    dm = design_from_codes(rank_codes(lo, hi, dev), shard=shard)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    with np.load(spec["problem"]) as z:
        problem = dict(y=z["y"], beta=z["beta"], y01=z["y01"],
                       prior=dict(probs=z["probs"].tolist(), vars=z["vars"].tolist(),
                                  h2=float(z["h2"])),
                       pprior=dict(probs=z["probs"].tolist(), vars=z["vars"].tolist()))
    results = {spec["tag"]: rank_tag_runs(spec, spec["tag"], spec["runs"], dm, problem)}
    if shard is not None:
        results[spec["tag"]]["all_reduce_ms"] = _all_reduce_ms(shard, dev)
    if spec.get("nccl"):  # the same process as one NCCL rank, on the same design
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        sharding.init_from_env("cuda")
        one = sharding.shard_for(NS_M, dev)
        results["rn"] = rank_tag_runs(spec, "rn", spec["nccl"], dm._replace(shard=one), problem)
        results["rn"]["all_reduce_ms"] = _all_reduce_ms(one, dev)
    if dist.is_initialized():
        dist.destroy_process_group()
    for tag, res in results.items():
        res["built_s"] = built
        res["rows"] = hi - lo
        with open(os.path.join(spec["out_dir"], f"{tag}_rank{res['rank']}.json"), "w") as f:
            json.dump(res, f)
    return 0


def torchrun(nproc: int, args: list[str], log_path: str) -> subprocess.Popen:
    """`python -m torch.distributed.run --standalone --nproc-per-node nproc
    ARGS` with VAMPOMI_DISTRIBUTED=1, its output to log_path; nproc 0: plain
    `python ARGS`, one process without a group."""
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             str(nproc)] if nproc else [sys.executable])
    env = dict(os.environ)
    if nproc:
        env["VAMPOMI_DISTRIBUTED"] = "1"
    else:
        env.pop("VAMPOMI_DISTRIBUTED", None)
    f = open(log_path, "w")
    p = subprocess.Popen(head + args, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    f.close()
    return p


def wait(p: subprocess.Popen, what: str, log_path: str, ok: bool = True) -> str:
    """Wait for p (at most 600 s, then kill it) and return its output; it
    must exit 0 when `ok`."""
    try:
        p.wait(timeout=600)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        fail(f"{what}: killed after 600 s")
    with open(log_path) as f:
        text = f.read()
    if ok:
        check(p.returncode == 0, f"{what}: exit {p.returncode}: {text[-3000:]}")
    return text


def rank_group(nproc: int, tag: str, runs, out_dir: str, log_dir: str, problem: str,
               nccl=None) -> dict:
    """Phase 10 (a)'s runs as `nproc` ranks (0: one process, no group, then
    as one NCCL rank the runs `nccl`); each group's results by tag, a list
    of its ranks'."""
    spec = os.path.join(out_dir, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump(dict(tag=tag, runs=runs, nccl=nccl, out_dir=out_dir, log_dir=log_dir,
                       problem=problem), f)
    log_path = os.path.join(log_dir, f"{tag}.log")
    t0 = time.perf_counter()
    wait(torchrun(nproc, [os.path.join(ROOT, "chip_smoke.py"), "--ranks-worker", spec],
                  log_path), f"ranks {tag}", log_path)
    took = time.perf_counter() - t0
    out = {}
    for t in [tag] + (["rn"] if nccl else []):
        out[t] = []
        for r in range(max(nproc, 1)):
            with open(os.path.join(out_dir, f"{t}_rank{r}.json")) as f:
                out[t].append(json.load(f))
    log(f"[ranks] {' and '.join(out)}: {max(nproc, 1)} process(es), backend "
        f"{', '.join(str(v[0]['backend']) for v in out.values())}, in {took:.1f}s (design "
        f"rows built in {[round(x['built_s'], 2) for x in out[tag]]} s)")
    return out


def check_rank_runs(tag: str, res: list, runs, out_dir: str) -> None:
    """Every rank ran the solver it must, holds the bits of rank 0, and
    launched each kernel and ran each collective exactly as often as its
    runs need (the CG steps from rank 0's trace): the linear runs, probit
    (eigen on the loaded cache) and the run modes."""
    for i, (label, _, k, expect) in enumerate(runs):
        steps = (_trace_steps(os.path.join(out_dir, f"{tag}_{label}_trace.jsonl"))
                 if expect == "cg" else [])
        for r in res:
            want = exact_launches("int8", expect, k, steps, r["rows"])
            run = r["runs"][i]
            where = f"ranks {tag} rank {r['rank']} {label}"
            check(run["solver"] == expect, f"{where}: ran {run['solver']}, want {expect}")
            check((run["gamw"], run["lam_sum"]) == (res[0]["runs"][i]["gamw"],
                                                    res[0]["runs"][i]["lam_sum"]),
                  f"{where}: gamw or the eigenvalues' sum differ from rank 0's")
            check(run["launches"] == want, f"{where}: launches {run['launches']}, want {want}")
            if r["backend"] is not None:
                want_c = rank_iteration_collectives(expect, k, steps)
                check(run["collectives"] == want_c,
                      f"{where}: collectives {run['collectives']}, want {want_c}")
            if expect == "eigen":  # the eigen run writes the cache, auto_warm loads it
                check(run["loaded"] == (label == "auto_warm"),
                      f"{where}: eigen cache {'loaded' if run['loaded'] else 'built'}")
    for i, (label, _, k, expect) in enumerate(PROBIT_RANK_RUNS):
        steps = (_trace_steps(os.path.join(out_dir, f"{tag}_probit_{label}_trace.jsonl"))
                 if expect == "cg" else [])
        for r in res:
            want = probit_launches(expect, k, steps, r["rows"])
            run = r["probit"][i]
            where = f"ranks {tag} rank {r['rank']} probit {label}"
            first = res[0]["probit"][i]
            check(run["solver"] == expect, f"{where}: ran {run['solver']}, want {expect}")
            check([run[key] for key in ("gam1", "tau1", "lam_sum")]
                  == [first[key] for key in ("gam1", "tau1", "lam_sum")],
                  f"{where}: gam1, tau1 or the eigenvalues' sum differ from rank 0's")
            check(run["launches"] == want, f"{where}: launches {run['launches']}, want {want}")
            check(run["loaded"] == (expect == "eigen"), f"{where}: the eigen cache not loaded")
            if r["backend"] is not None:
                want_c = probit_iteration_collectives(expect, k, steps)
                check(run["collectives"] == want_c,
                      f"{where}: collectives {run['collectives']}, want {want_c}")
    for r in res:
        for mode in RANK_MODES:
            got = r["modes"][mode]
            check(got["launches"] == MODE_LAUNCHES[mode],
                  f"ranks {tag} rank {r['rank']} {mode}: launches {got['launches']}, want "
                  f"{MODE_LAUNCHES[mode]}")
            if r["backend"] is not None:
                check(got["collectives"] == MODE_COLLECTIVES[mode],
                      f"ranks {tag} rank {r['rank']} {mode}: collectives {got['collectives']}, "
                      f"want {MODE_COLLECTIVES[mode]}")


def _rank_files(runs) -> list[str]:
    """The files of a group's runs, after its "<tag>_", that one NCCL rank
    must repeat byte for byte: the CSVs and dumps of its linear and probit
    runs and every mode's output."""
    names = []
    for prefix, rs in (("", runs), ("probit_", PROBIT_RANK_RUNS)):
        for label, _, k, _ in rs:
            names += [f"{prefix}{label}_{c}.csv" for c in ("metrics", "params", "prior")]
            names += [f"{prefix}{label}_{kind}it_{i}.bin" for kind in ("", "r1_")
                      for i in range(1, k + 1)]
    k = RANK_MODES_K
    names += [f"modes_it_{k}_pval_{m}.bin" for m in ("se", "loo", "loo_std")]
    return names + ["modes_test.csv", "pred_.yhat"]


def _mode_values(out_dir: str, tag: str, mode: str) -> np.ndarray:
    k = RANK_MODES_K
    if mode == "test":
        return np.asarray(read_positional_csv(os.path.join(out_dir, f"{tag}_modes_test.csv")))
    if mode == "predict":
        with open(os.path.join(out_dir, f"{tag}_pred_.yhat")) as f:
            return np.array([float(v) for v in f.read().split()])
    return np.fromfile(os.path.join(out_dir, f"{tag}_modes_it_{k}_pval_{mode}.bin"))


def rank_dump_diffs(out_dir: str, tag: str, ref: str) -> tuple[dict, dict, list]:
    """Group `tag`'s dumps of phase 10 (a)'s linear and probit runs against
    group `ref`'s: by run, the largest |diff|, the largest |diff| of each
    dump (x1 then r1, iteration by iteration) as a share of its bar
    RANK_RTOL |ref| + RANK_ATOL, and the dumps past it with their counts of
    markers past it."""
    worst, share, past = {}, {}, []
    for prefix, rs in (("", RANK_RUNS), ("probit_", PROBIT_RANK_RUNS)):
        for label, _, k, expect in rs:
            key = prefix + label
            share[key] = []
            for it in range(1, k + 1):
                for kind in ("", "r1_"):
                    a, b = (read_bin_slab(os.path.join(out_dir, f"{t}_{key}_{kind}it_{it}.bin"),
                                          NS_M) for t in (tag, ref))
                    diff, bar = np.abs(a - b), RANK_RTOL[expect] * np.abs(b) + RANK_ATOL
                    share[key].append(round(float(np.max(diff / bar)), 4))
                    if not within(a, b, RANK_RTOL[expect], RANK_ATOL):
                        j = int(np.argmax(diff / bar))
                        past.append(f"{key} {kind}it_{it} ({int(np.sum(diff > bar))} markers; "
                                    f"the worst, marker {j}: {a[j]!r} against {b[j]!r})")
                    worst[key] = max(worst.get(key, 0.0), float(np.max(diff)))
    return worst, share, past


def phase_ranks_main(dev: str, log_dir: str, out_dir: str) -> dict:
    """Phase 10 (a): the int8 north-star main path, probit on planted labels
    and the run modes as one process without a group, which then runs as
    one NCCL rank (world size 1), and as two gloo ranks sharing the card
    (524,288 markers and 5 GiB of X each)."""
    t0 = time.perf_counter()
    X = rank_codes(0, NS_M, dev)
    dm = design_from_codes(X)
    y, beta, prior = planted_problem(dm, NS_M // 1024)
    g = math.sqrt(NS_N) * ax(dm, torch.as_tensor(beta, dtype=torch.float32, device=dev))
    y01 = (g.double().cpu().numpy() + np.random.default_rng(SEED + 5).normal(size=NS_N) > 0)
    problem = os.path.join(out_dir, "ranks_problem.npz")
    np.savez(problem, y=y, beta=beta, y01=y01.astype(np.float64), probs=prior["probs"],
             vars=prior["vars"], h2=prior["h2"])
    del dm, X, g
    torch.cuda.empty_cache()
    log(f"[ranks] planted problem on the chunked design in {time.perf_counter() - t0:.1f}s "
        f"({int(y01.sum())} cases of {NS_N} for probit)")
    groups = rank_group(0, "r1", RANK_RUNS, out_dir, log_dir, problem, nccl=NCCL_RUNS)
    one, nccl = groups["r1"], groups["rn"]
    check_rank_runs("r1", one, RANK_RUNS, out_dir)
    check(nccl[0]["backend"] == "nccl", f"one rank ran {nccl[0]['backend']}, not nccl")
    check_rank_runs("rn", nccl, NCCL_RUNS, out_dir)
    names = _rank_files(NCCL_RUNS)
    for f in names:
        check(_bytes(os.path.join(out_dir, f"r1_{f}")) == _bytes(os.path.join(out_dir, f"rn_{f}")),
              f"ranks: one NCCL rank's {f} is not the run without a group's, byte for byte")
    log(f"[ranks] one NCCL rank: {len(names)} CSVs, dumps and mode files (linear, probit, SE, "
        f"LOO, loo_std, test, predict) byte-identical to the run without a group")
    two = rank_group(2, "r2", RANK_RUNS, out_dir, log_dir, problem)["r2"]
    check(two[0]["backend"] == "gloo", f"two ranks on one card ran {two[0]['backend']}, not gloo")
    check_rank_runs("r2", two, RANK_RUNS, out_dir)
    setup = {f"{tag}_rank{r['rank']}": {k: run[k] for k in ("u_shape", "u_bytes",
                                                         "after_setup_bytes")}
             for tag, res in (("1", one), ("1_nccl", nccl), ("2", two)) for r in res
             for run in r["runs"] if run["label"] == "eigen"}
    mib = lambda b: round(b / 2**20, 1)  # noqa: E731
    held = {k: (v["u_shape"], mib(v["u_bytes"]), mib(v["after_setup_bytes"]))
            for k, v in setup.items()}
    log(f"[ranks] right after the eigen run's setup (N = {NS_N}): U's shape, its storage's MiB "
        f"and torch.cuda.memory_allocated MiB, by process and rank {held}")
    worst, share, past = rank_dump_diffs(out_dir, "r2", "r1")
    log(f"[ranks] two gloo ranks against one process, the largest |diff| of each dump as a "
        f"share of its bar (rtol {RANK_RTOL}, atol {RANK_ATOL}; x1 then r1, iteration by "
        f"iteration): {share}")
    check(not past, f"ranks: two ranks' dumps past the bar of one process's: {past}")
    labels = {}
    for i, (label, *_) in enumerate(PROBIT_RANK_RUNS):
        a, b = (np.asarray(g[0]["probit"][i]["metrics"]) for g in (two, one))
        counts = [0, 1, 2, 3, 6, 7, 8, 9]
        labels[label] = float(np.abs(a[:, counts] - b[:, counts]).max())
        check(labels[label] <= PARITY_LABELS,
              f"ranks: two ranks' probit {label} confusion counts {labels[label]:g} samples off")
    modes_err = {}
    for mode in RANK_MODES:
        a, b = (_mode_values(out_dir, t, mode) for t in ("r2", "r1"))
        if mode == "se":
            ok = _bytes(os.path.join(out_dir, f"r2_modes_it_{RANK_MODES_K}_pval_se.bin")) == \
                _bytes(os.path.join(out_dir, f"r1_modes_it_{RANK_MODES_K}_pval_se.bin"))
            modes_err[mode] = 0.0 if ok else float(np.max(np.abs(a - b)))
        else:
            if mode.startswith("loo"):  # p underflows to 0 for the strongest markers
                a, b = -np.log10(a + 1e-300), -np.log10(b + 1e-300)
            ok = within(a, b, RANK_RTOL["eigen"])
            modes_err[mode] = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        check(ok and a.shape[0] == {"test": RANK_MODES_K, "predict": NS_N}.get(mode, NS_M),
              f"ranks: two ranks' {mode} output not within the bar of one process's")
    iteration_ms, probit_ms, mode_s = {}, {}, {}
    for tag, res in (("1", one), ("1_nccl", nccl), ("2", two)):
        iteration_ms[tag] = {run["label"]: 1e3 * float(np.median(run["seconds"][1:]))
                             for run in res[0]["runs"]}
        probit_ms[tag] = {run["label"]: 1e3 * float(np.median(run["seconds"][1:]))
                          for run in res[0]["probit"]}
        mode_s[tag] = {m: max(r["modes"][m]["seconds"] for r in res) for m in RANK_MODES}
    log(f"[ranks] eigen, median ms an iteration (its 2..k, outputs on): one process "
        f"{iteration_ms['1']['eigen']:.2f}, one NCCL rank {iteration_ms['1_nccl']['eigen']:.2f}, "
        f"two gloo ranks {iteration_ms['2']['eigen']:.2f}")
    peak = {f"{tag}_rank{r['rank']}": max(run["peak_gib"] for run in r["runs"])
            for tag, res in (("1", one), ("2", two)) for r in res}
    out = dict(all_reduce_ms={"gloo_2_ranks": two[0]["all_reduce_ms"],
                              "nccl_1_rank": nccl[0]["all_reduce_ms"]},
               iteration_ms=iteration_ms, probit_iteration_ms=probit_ms, mode_seconds=mode_s,
               peak_gib=peak, max_abs_diff_2_vs_1=worst, probit_label_diff_2_vs_1=labels,
               mode_rel_diff_2_vs_1=modes_err,
               launches_per_rank={run["label"]: run["launches"] for run in two[0]["runs"]},
               probit_launches_per_rank={run["label"]: run["launches"]
                                         for run in two[0]["probit"]},
               collectives_per_rank={run["label"]: run["collectives"] for run in two[0]["runs"]},
               probit_collectives_per_rank={run["label"]: run["collectives"]
                                            for run in two[0]["probit"]},
               x1_corr={run["label"]: run["x1_corr"] for run in two[0]["runs"]},
               eigen_setup=setup)
    log(f"[ranks] two gloo ranks sharing the card: within rtol {RANK_RTOL} atol {RANK_ATOL} of "
        f"one process (max abs diff {worst}; probit counts within {labels} samples; modes' "
        f"max abs diff over the largest entry {modes_err}, SE byte-identical); one (N, 2) "
        f"all_reduce "
        f"{two[0]['all_reduce_ms']:.3f} ms under gloo (2 ranks), {nccl[0]['all_reduce_ms']:.3f} "
        f"ms under NCCL (1 rank); median ms an iteration (its 2..k) {iteration_ms}, probit "
        f"{probit_ms}; mode seconds {mode_s}; peak GiB {peak}; done in "
        f"{time.perf_counter() - t0:.1f}s")
    return out


def phase_ranks_cli(dev: str, log_dir: str, n: int = 2_000, m: int = 8_002, iters: int = 8,
                    split: int = 4) -> dict:
    """Phase 10 (b): the CLI under torch.distributed.run with 3 ranks on the
    card (slabs of 2,668, 2,667 and 2,667 markers), each command once,
    against the one-process CLI: linear int8 and int4 with eigen and CG,
    --model bin_class int8 with eigen and CG and int4 with eigen; a 3-rank
    checkpoint at iteration `split` of each model resumed by 3 ranks (CSVs
    and dumps byte-identical to the straight 3-rank run) and by one process
    (within rtol); test, association_test (se, loo, loo_std) and predict on
    the one-process linear eigen run's dumps, test and predict with
    --model bin_class on the probit one's (one launch of 3 ranks for the
    seven, cli_ranks_worker); --profile-dir over 3 ranks (a trace a rank,
    the dumps those of the run without it)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vampomi_ranks_cli_") as d:
        fx = simulate_iid(n=n, m=m, lam=0.1, h2=0.8, seed=SEED)
        paths = write_fixture(fx, d, "ex")
        y01 = (fx.X @ fx.beta + np.random.default_rng(SEED + 10).normal(size=n) > 0)
        paths["binphen"] = os.path.join(d, "ex_bin.phen")
        with open(paths["binphen"], "w") as f:
            f.writelines(f"{i} {i} {int(v)}\n" for i, v in enumerate(y01))

        def argv(sub, model, dtype, solver, k, *extra):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
            hyper = (["--h2", "0.8"] if model == "linear" else ["--rho", "0.3", "--gam1", "1e-2"])
            return ["--run-mode", "infere", "--model", model, "--meth-file", paths["bin"],
                    "--phen-file", paths["phen"] if model == "linear" else paths["binphen"],
                    "--true-signal-file", paths["ts"], "--N", str(n), "--Mt", str(m),
                    "--out-dir", os.path.join(d, sub), "--out-name", "r", "--iterations", str(k),
                    "--stop-criteria-thr", "0", "--probs", "0.9,0.07,0.03", "--vars",
                    "0.0,0.001,0.01", "--device", dev, "--compute-dtype", dtype,
                    "--lmmse-solver", solver, "--seed", str(SEED), *hyper, *extra]

        def launch3(tag, args):
            """`args` under torch.distributed.run with 3 ranks, its output
            to <log_dir>/ranks_cli_<tag>.log; (process, log path)."""
            lp = os.path.join(log_dir, f"ranks_cli_{tag}.log")
            procs.append(torchrun(3, args, lp))
            return procs[-1], lp

        procs = []
        try:
            names = _ranks_cli_runs(d, paths, dev, log_dir, n, m, iters, split, argv, launch3)
        finally:  # nothing started here outlives a failed check
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    took = time.perf_counter() - t0
    log(f"[ranks] cli: each model's 3-rank checkpoint at iteration {split} resumed to {iters} "
        f"by 3 ranks ({names} files byte-identical to the straight runs) and by one process "
        f"(within rtol {RANK_RTOL['eigen']}); the run modes of both models over 3 ranks; "
        f"--profile-dir over 3 ranks: a trace a rank, the dumps byte for byte; {took:.1f}s")
    return dict(cli_seconds=took, resume_byte_identical_files=names)


# (model, dtype, solver) of phase 10 (b)'s straight runs; int8 eigen runs
# all the iterations (its checkpoint and its run modes go with it), the
# others as many as the checkpoint's first half
CLI_RANK_RUNS = (("linear", "int8", "eigen"), ("linear", "int8", "cg"),
                 ("linear", "int4", "eigen"), ("linear", "int4", "cg"),
                 ("bin_class", "int8", "eigen"), ("bin_class", "int8", "cg"),
                 ("bin_class", "int4", "eigen"))


def cli_ranks_worker(spec_path: str) -> int:
    """One rank of a launch of phase 10 (b) that runs several CLI commands
    (spec["argvs"], a list of argv lists) in one process group, each
    through the CLI's own parse_config and run-mode dispatch (cli._run) on
    the rank's slab: what `python -m vampomi_tpu_torch.cli` does for one
    command, but with one process start and one group for all of them; then
    the array API over the same group (spec["api"], ranks_api)."""
    import torch.distributed as dist

    from vampomi_tpu_torch import sharding

    with open(spec_path) as f:
        spec = json.load(f)
    argvs = spec["argvs"]
    dev = resolve_device(sharding.init_from_env(cli.parse_config(argvs[0]).device))
    try:
        for argv in argvs:
            cfg = cli.parse_config(argv)
            check(cli._run(cfg, dev, sharding.shard_for(cfg.Mt, dev)) == 0,
                  f"{argv[:4]}: non-zero exit")
        ranks_api(spec["api"], dev)
    finally:
        dist.destroy_process_group()
    return 0


def ranks_api(job: dict, dev) -> None:
    """api.py with shard="auto" in an initialised process group, on the CLI
    fixture's (Mt, N) f64 matrix: fit_linear (eigen, iterations - 1: its
    final r1 and gam1 are what the CLI's iteration `iterations` denoised,
    which the CLI's SE run reads), association_pvals (SE) of that fit,
    fit_probit (eigen, `iterations`) and predict_probit's probabilities on
    the same X; the int8 design, the CLI runs' seed and hyperparameters.
    Rank 0 writes the results to job["out"]."""
    import torch.distributed as dist

    from vampomi_tpu_torch import api, sharding
    from vampomi_tpu_torch.io.phen import read_phen

    n, m, iters = job["n"], job["m"], job["iters"]
    check(sharding.shard_for(m, dev) is not None, "ranks api: no process group to split over")
    X = np.fromfile(job["bin"]).reshape(m, n)
    kw = dict(marker_major=True, device=str(dev), quiet=True, stop_criteria_thr=0.0,
              probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], compute_dtype="int8",
              lmmse_solver="eigen", seed=SEED, true_signal=np.fromfile(job["ts"]))
    t0 = time.perf_counter()
    lin = api.fit_linear(X, read_phen(job["phen"], n, standardize=False).y, h2=0.8,
                         iterations=iters - 1, shard="auto", **kw)
    pv = api.association_pvals(lin, n, shard="auto")
    pfit = api.fit_probit(X, read_phen(job["binphen"], n, standardize=False).y, rho=0.3,
                          gam1=1e-2, iterations=iters, shard="auto", **kw)
    proba = api.predict_probit(pfit, X, marker_major=True, device=str(dev), compute_dtype="int8",
                               return_proba=True, shard="auto")
    if dist.get_rank() == 0:
        np.savez(job["out"], x1=lin.x1_hat_scaled, pvals=pv, px1=pfit.x1_hat_scaled,
                 proba=proba, solvers=np.array([lin.solver, pfit.solver]),
                 world=dist.get_world_size(), seconds=time.perf_counter() - t0)


def _ranks_cli_runs(d: str, paths: dict, dev: str, log_dir: str, n: int, m: int, iters: int,
                    split: int, argv, launch3) -> int:
    """The runs and checks of phase_ranks_cli in the fixture's directory d;
    returns the number of files the two 3-rank resumes repeat byte for
    byte.  The 3-rank commands of a wave start together and the one-process
    runs go on here meanwhile."""
    def cli3(sub, *args):  # one CLI command over 3 ranks
        return launch3(sub, ["-m", "vampomi_tpu_torch.cli", *args])

    runs = [(f"{mo}_{dt}_{s}", mo, dt, s, iters if (dt, s) == ("int8", "eigen") else split)
            for mo, dt, s in CLI_RANK_RUNS]
    started = [cli3(f"r3_{t}", *argv(f"r3_{t}", mo, dt, s, k)) for t, mo, dt, s, k in runs]
    parts = {}
    for model in ("linear", "bin_class"):
        ck = os.path.join(d, f"part_{model}", "ck.npz")
        parts[model] = (ck, cli3(f"part_{model}", *argv(f"part_{model}", model, "int8", "eigen",
                                                        split, "--checkpoint-file", ck)))
    profiled, lp_profiled = cli3("profile", *argv("profile", "linear", "int8", "eigen", 2,
                                                  "--profile-dir", os.path.join(d, "prof")))
    t0 = time.perf_counter()
    for t, mo, dt, s, k in runs:
        with engine_log(log_dir, f"ranks_cli_r1_{t}"):
            check(cli.main(argv(f"r1_{t}", mo, dt, s, k)) == 0, f"ranks cli one process {t}")
    walls = {"wave1_one_process": time.perf_counter() - t0}
    for (t, *_), (p, lp) in zip(runs, started):
        wait(p, f"ranks cli 3 ranks {t}", lp)
    for model, (_, (p, lp)) in parts.items():
        wait(p, f"ranks cli {model} checkpoint run", lp)
    wait(profiled, "ranks cli --profile-dir", lp_profiled)
    walls["wave1"] = time.perf_counter() - t0
    # --profile-dir over 3 ranks: a Chrome trace a rank, and the dumps of
    # the run's 2 iterations those of the 3-rank int8 eigen run, byte for byte
    traces = sorted(os.listdir(os.path.join(d, "prof")))
    check([t.split(".")[0] for t in traces] == ["rank0", "rank1", "rank2"],
          f"ranks cli: --profile-dir over 3 ranks wrote {traces}")
    for t in traces:
        with open(os.path.join(d, "prof", t)) as f:
            check(bool(json.load(f)["traceEvents"]), f"ranks cli: trace {t} is empty")
    for it in (1, 2):
        for kind in ("", "r1_"):
            f = f"r_{kind}it_{it}.bin"
            check(_bytes(os.path.join(d, "profile", f))
                  == _bytes(os.path.join(d, "r3_linear_int8_eigen", f)),
                  f"ranks cli: {f} differs with --profile-dir over 3 ranks")
    for t, mo, dt, s, k in runs:
        for it in range(1, k + 1):
            for kind in ("", "r1_"):
                path = os.path.join(d, f"r3_{t}", f"r_{kind}it_{it}.bin")
                a = read_bin_slab(path, m)
                b = read_bin_slab(os.path.join(d, f"r1_{t}", f"r_{kind}it_{it}.bin"), m)
                check(os.path.getsize(path) == 8 * m and within(a, b, RANK_RTOL[s]),
                      f"ranks cli {t}: 3 ranks' {kind}it_{it} not within rtol of one")
        if mo == "bin_class":
            a, b = (np.asarray(read_positional_csv(os.path.join(d, f"{w}_{t}", "r_metrics.csv")))
                    for w in ("r3", "r1"))
            counts = [1, 2, 3, 4, 7, 8, 9, 10]  # after the iteration column
            check(a.shape == b.shape == (k, 13)
                  and np.abs(a[:, counts] - b[:, counts]).max() <= PARITY_LABELS,
                  f"ranks cli {t}: 3 ranks' confusion counts not within {PARITY_LABELS}")
    log(f"[ranks] cli: 3 ranks (slabs 2,668 / 2,667 / 2,667) against one process, linear int8 "
        f"and int4 with eigen and CG, probit int8 with eigen and CG and int4 with eigen: every "
        f"dump full length and within rtol {RANK_RTOL} (atol: rtol times the dump's largest "
        f"entry), probit counts within {PARITY_LABELS}")

    # wave 2: each checkpoint resumed by 3 ranks and by one process; the run
    # modes of both models on the one-process eigen runs' dumps
    resumed = {}
    for model, (ck, _) in parts.items():
        check(load_checkpoint(ck)["iteration"] == split, f"ranks cli {model}: checkpoint iteration")
        shutil.copyfile(ck, os.path.join(d, f"one_{model}.npz"))
        resumed[model] = cli3(f"part_{model}", *argv(f"part_{model}", model, "int8", "eigen",
                                                     iters, "--resume-file", ck))
    lin, pb = (os.path.join(d, f"r1_{mo}_int8_eigen", "r") for mo in ("linear", "bin_class"))
    gam1 = read_positional_csv(f"{lin}_params.csv")[iters - 1][2]

    def mode_argv(sub, mode):
        out = os.path.join(d, sub)
        os.makedirs(out, exist_ok=True)
        train = ["--meth-file", paths["bin"], "--phen-file", paths["phen"], "--N", str(n)]
        test = ["--meth-file-test", paths["bin"], "--N-test", str(n)]
        common = ["--Mt", str(m), "--out-dir", out, "--out-name", "m", "--compute-dtype", "int8",
                  "--device", dev]
        if mode in ("se", "loo", "loo_std"):
            src = (["--r1-file", f"{lin}_r1_it_{iters}.bin", "--gam1", repr(gam1)]
                   if mode == "se" else ["--estimate-file", f"{lin}_it_{iters}.bin"])
            return ["--run-mode", "association_test", "--pval-method", mode, *train, *src,
                    *common]
        model = "bin_class" if mode.endswith("_probit") else "linear"
        phen = paths["binphen"] if model == "bin_class" else paths["phen"]
        est = pb if model == "bin_class" else lin
        if mode.startswith("test"):
            src = ["--estimate-file", f"{est}_it_1.bin", "--test-iter-range", f"1,{iters}"]
        else:  # predict writes <prefix>.yhat beside its estimate
            shutil.copyfile(f"{est}_it_{iters}.bin", os.path.join(out, f"y_it_{iters}.bin"))
            src = ["--estimate-file", os.path.join(out, f"y_it_{iters}.bin")]
        return ["--run-mode", mode.split("_")[0], "--model", model, *test, "--phen-file-test",
                phen, *src, *common]

    modes = ("se", "loo", "loo_std", "test", "predict", "test_probit", "predict_probit")
    t0 = time.perf_counter()
    # the seven mode commands in one launch of 3 ranks (cli_ranks_worker):
    # a launch costs more than the commands it runs at this size
    spec = os.path.join(d, "modes3.json")
    api_out = os.path.join(d, "api3.npz")
    with open(spec, "w") as f:
        json.dump(dict(argvs=[mode_argv(f"m3_{mode}", mode) for mode in modes],
                       api=dict(bin=paths["bin"], phen=paths["phen"], binphen=paths["binphen"],
                                ts=paths["ts"], n=n, m=m, iters=iters, out=api_out)), f)
    modes3 = launch3("m3", [os.path.join(ROOT, "chip_smoke.py"), "--cli-ranks", spec])
    for mode in modes:
        with engine_log(log_dir, f"ranks_cli_m1_{mode}"):
            check(cli.main(mode_argv(f"m1_{mode}", mode)) == 0, f"ranks cli one process {mode}")
    for model in parts:
        with engine_log(log_dir, f"ranks_cli_one_resumed_{model}"):
            check(cli.main(argv(f"one_{model}", model, "int8", "eigen", iters, "--resume-file",
                                os.path.join(d, f"one_{model}.npz"))) == 0,
                  f"ranks cli: one process resuming the 3-rank {model} checkpoint")
    walls["wave2_one_process"] = time.perf_counter() - t0
    wait(modes3[0], "ranks cli 3 ranks, the run modes", modes3[1])
    for model, (p, lp) in resumed.items():
        wait(p, f"ranks cli 3 ranks resuming {model}", lp)
    walls["wave2"] = time.perf_counter() - t0
    log(f"[ranks] cli: walls {({k: round(v, 1) for k, v in walls.items()})} (wave 1: 10 launches "
        f"of 3 ranks; wave 2: 3)")
    same = 0
    for model in parts:
        names = [f"r_{c}.csv" for c in ("metrics", "params", "prior")]
        names += [f"r_{kind}it_{i}.bin" for kind in ("", "r1_") for i in range(1, iters + 1)]
        straight = os.path.join(d, f"r3_{model}_int8_eigen")
        for f in names:
            check(_bytes(os.path.join(d, f"part_{model}", f)) == _bytes(os.path.join(straight, f)),
                  f"ranks cli {model}: the 3-rank resume's {f} is not the straight run's, "
                  "byte for byte")
        same += len(names)
        for it in range(split + 1, iters + 1):
            for kind in ("", "r1_"):
                a = read_bin_slab(os.path.join(d, f"one_{model}", f"r_{kind}it_{it}.bin"), m)
                b = read_bin_slab(os.path.join(straight, f"r_{kind}it_{it}.bin"), m)
                check(within(a, b, RANK_RTOL["eigen"]),
                      f"ranks cli {model}: one process's resume {kind}it_{it} past rtol")
    for mode in modes:
        a, b = (os.path.join(d, f"{w}_{mode}") for w in ("m3", "m1"))
        if mode in ("se", "loo", "loo_std"):
            f = f"m_it_{iters}_pval_{mode}.bin"
            va, vb = (read_bin_slab(os.path.join(x, f), m) for x in (a, b))
            ok = (_bytes(os.path.join(a, f)) == _bytes(os.path.join(b, f)) if mode == "se"
                  else within(-np.log10(va + 1e-300), -np.log10(vb + 1e-300),
                              RANK_RTOL["eigen"]))
        elif mode == "test":
            va, vb = (np.asarray(read_positional_csv(os.path.join(x, "m_test.csv")))
                      for x in (a, b))
            ok = va.shape == (iters, 3) and within(va, vb, RANK_RTOL["eigen"])
        elif mode == "test_probit":
            va, vb = (_csv_raw(os.path.join(x, "m_test.csv")) for x in (a, b))
            ok = va.shape == vb.shape == (iters, 6) and np.abs(
                va[:, 1:5] - vb[:, 1:5]).max() <= PARITY_LABELS
        else:
            va, vb = (np.loadtxt(os.path.join(x, "y_.yhat")) for x in (a, b))
            ok = va.shape == (n,) and within(va, vb, RANK_RTOL["eigen"])
        check(ok, f"ranks cli {mode}: 3 ranks' output not within the bar of one process's")
    log(f"[ranks] cli: the run modes over 3 ranks against one process: SE byte-identical, LOO "
        f"and loo_std -log10 p, test (linear) and .yhat within rtol {RANK_RTOL['eigen']}, "
        f"probit test counts within {PARITY_LABELS}")
    # the array API over the same 3 ranks against the one-process CLI's files
    rtol = RANK_RTOL["eigen"]
    with np.load(api_out) as z:
        got = {k: z[k] for k in z.files}
    lin_x1 = read_bin_slab(f"{lin}_it_{iters - 1}.bin", m)
    pb_x1 = read_bin_slab(f"{pb}_it_{iters}.bin", m)
    se = read_bin_slab(os.path.join(d, "m1_se", f"m_it_{iters}_pval_se.bin"), m)
    zhat = np.loadtxt(os.path.join(d, "m1_predict_probit", "y_.yhat"))
    want_p = normal_cdf(torch.as_tensor(zhat)).numpy()  # Phi of the CLI's scores, as api's
    errs = {k: float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
            for k, a, b in (("x1", got["x1"], lin_x1), ("probit_x1", got["px1"], pb_x1),
                            ("proba", got["proba"], want_p))}
    lp, lq = -np.log10(got["pvals"] + 1e-300), -np.log10(se + 1e-300)
    errs["se_log10p"] = float(np.max(np.abs(lp - lq)) / np.max(np.abs(lq)))
    # each output's largest |diff| as a share of phase 10 (a)'s bar; the
    # estimates are held to it, the probabilities and -log10 p to rtol
    # times their largest entry, as the CLI's modes over 3 ranks above
    shares = {k: round(float(np.max(np.abs(a - b) / (rtol * np.abs(b) + RANK_ATOL))), 4)
              for k, a, b in (("x1", got["x1"], lin_x1), ("probit_x1", got["px1"], pb_x1),
                              ("proba", got["proba"], want_p), ("se_log10p", lp, lq))}
    check(int(got["world"]) == 3 and list(got["solvers"]) == ["eigen", "eigen"],
          f"ranks api: {got['world']} ranks, solvers {got['solvers']}")
    check(within(got["x1"], lin_x1, rtol, RANK_ATOL) and within(got["px1"], pb_x1, rtol, RANK_ATOL)
          and within(got["proba"], want_p, rtol) and within(lp, lq, rtol),
          f"ranks api: shard='auto' over 3 ranks not within rtol {rtol} of the one-process CLI "
          f"({errs}; shares of rtol |ref| + atol {RANK_ATOL:g}: {shares})")
    log(f"[ranks] api: fit_linear, association_pvals, fit_probit and predict_probit with "
        f"shard='auto' over 3 ranks in {float(got['seconds']):.1f}s, within rtol {rtol} of the "
        f"one-process CLI's dumps (atol {RANK_ATOL:g}), SE p-values (-log10) and probit scores "
        f"(atol: rtol times the largest entry); max |diff| over the largest entry {errs}; each "
        f"largest |diff| as a share of rtol {rtol} |ref| + atol {RANK_ATOL:g}: {shares}")
    return same


# ---------------------------------------------------------------------------
# phase 11: the user's workflow through real files

FILES_N, FILES_M = NS_N, NS_M // 4      # a quarter of the north star's markers
FILES_ROWS = 8_192                      # rows of the f64 file made from one seed
FILES_ITERS = 4
FILES_RSS_GIB = 8.0                     # the CLI process's peak RSS bound
FILES_SLAB = 1_000                      # rows of each slab held against build_design
FILES_THREADS_GIB = 1.0                 # f64 GiB of the file streamed at each thread count
FILES_THREADS = (1, 2, 4, 6, 8)         # ingest threads tried on that slab
FILES_FREE_GIB = 25.0                   # free disk the full-size file needs
ZARR_N, ZARR_M = 2_000, 4_096           # one per-chromosome store (samples, markers)


def files_dir(m: int) -> tuple[str, int, str]:
    """A directory on the disk with the most free space, and the marker
    count that fits there: with less than FILES_FREE_GIB free, M halved
    until the file and 5 GiB beside it fit; with the cut named, and the
    free space of each candidate disk and the host's memory logged."""
    cands = [tempfile.gettempdir(), ROOT]
    free = {c: shutil.disk_usage(c).free / 2**30 for c in cands}
    best = max(cands, key=free.get)
    cut = ""
    while free[best] < FILES_FREE_GIB and 8 * m * FILES_N / 2**30 + 5.0 > free[best] \
            and m > FILES_ROWS:
        m //= 2
        cut = f"M cut to {m:,} for {free[best]:.1f} GiB free"
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: int(ln.split()[1]) / 2**20 for ln in f}
    log(f"[files] disk free (GiB): {', '.join(f'{c} {g:.1f}' for c, g in free.items())}; host "
        f"memory {mem['MemTotal']:.1f} GiB, {mem['MemAvailable']:.1f} available; "
        f"{cut or 'no cut'}")
    return tempfile.mkdtemp(prefix="vampomi_files_", dir=best), m, cut


def _cached_gib() -> float:
    with open("/proc/meminfo") as f:
        return next(int(ln.split()[1]) for ln in f if ln.startswith("Cached:")) / 2**20


def write_meth_file(path: str, m: int, dev) -> tuple[float, float]:
    """The f64 marker-major file of m methylation-like rows x FILES_N:
    values in [0, 1], each marker uniform in its own range [lo, lo + w),
    chunk c of FILES_ROWS rows made on the card from its own seed, copied
    to the host and written by the native runtime while the next is made.
    Returns (seconds, GiB the page cache grew by)."""
    from concurrent.futures import ThreadPoolExecutor

    from vampomi_tpu_torch.io import native

    t0, cached0 = time.perf_counter(), _cached_gib()
    with open(path, "wb"):
        pass
    with ThreadPoolExecutor(1) as pool:
        pending = []
        for lo in range(0, m, FILES_ROWS):
            rows = min(m, lo + FILES_ROWS) - lo
            g = torch.Generator(device=dev).manual_seed(SEED + 200 + lo // FILES_ROWS)
            band = torch.rand((rows, 2), dtype=torch.float64, device=dev, generator=g)
            u = torch.rand((rows, FILES_N), dtype=torch.float64, device=dev, generator=g)
            x = (0.6 * band[:, :1] + (0.05 + 0.35 * band[:, 1:]) * u).cpu().numpy()
            if len(pending) == 2:
                pending.pop(0).result()
            pending.append(pool.submit(native.write_from, path, x, 8 * lo * FILES_N))
        for f in pending:
            f.result()
    return time.perf_counter() - t0, _cached_gib() - cached0


def planted_files(path: str, m: int, d: str) -> dict:
    """The .phen and true signal of a planted problem on the file, as
    phase 5 plants it (one causal marker per 1,024, h2 = 0.8): y = A beta
    + e with A the file's standardized rows (f64, from the causal rows
    alone), scaled as read_phen standardizes it; the prior at the truth."""
    from vampomi_tpu_torch.io.bin_io import read_meth_bin

    n, causal, h2 = FILES_N, m // 1024, 0.8
    idx = np.sort(np.random.default_rng(SEED + 3).choice(m, causal, replace=False))
    beta = np.zeros(m)
    beta[idx] = np.random.default_rng(SEED).normal(0.0, math.sqrt(h2 / causal), causal)
    g = np.zeros(n)
    for j in idx:
        x = read_meth_bin(path, n, 1, int(j))[0]
        g += beta[j] * (x - x.mean()) / x.std(ddof=1)
    y = g + np.random.default_rng(SEED + 1).normal(0.0, math.sqrt(1.0 - h2), n)
    paths = {"bin": path, "phen": os.path.join(d, "f.phen"), "ts": os.path.join(d, "f_ts.bin")}
    with open(paths["phen"], "w") as f:
        f.writelines(f"{i} {i} {v!r}\n" for i, v in enumerate(y.tolist()))
    beta.tofile(paths["ts"])
    paths["prior"] = dict(probs=f"{1.0 - causal / m!r},{causal / m!r}",
                          vars=f"0.0,{h2 / causal!r}")
    return paths


def files_worker(spec_path: str) -> int:
    """The process of phase 11 (a) that runs the CLI's commands of
    spec["argvs"] one after another through the CLI's entry point
    (cli.main: its parse and run-mode dispatch), so that its peak RSS is
    theirs alone.  Each command's dataset load is timed, the first one's
    design is kept on three slabs of rows for the parent, and each
    command's kernel launches are counted from 0."""
    import vampomi_tpu_torch.dataset as dataset

    with open(spec_path) as f:
        spec = json.load(f)
    real, loads = dataset.load_dataset, []
    # the CPU when the phase is rehearsed at a toy size without a card
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def load(*a, **k):
        sync()
        t0 = time.perf_counter()
        ds = real(*a, **k)
        sync()
        loads.append(time.perf_counter() - t0)
        steps[f"load{len(loads)}"] = rss()
        if len(loads) == 1:
            slabs = {}
            for i, (lo, hi) in enumerate(spec["slabs"]):
                slabs[f"X{i}"] = ds.dm.X[lo:hi].cpu().numpy()
                for key in ("mave", "msig"):
                    slabs[f"{key}{i}"] = getattr(ds.dm, key)[lo:hi].cpu().numpy()
                slabs[f"qscale{i}"] = ds.qscale[lo:hi]
            np.savez(spec["slabs_out"], **slabs)
        return ds

    dataset.load_dataset = load
    # this process's own peak RSS: VmHWM of the address space its exec
    # made (getrusage's ru_maxrss keeps the high-water mark of the parent's
    # pages that the fork copied, GiBs at this point of the script), and
    # the largest VmRSS a 20 Hz sampler saw, for a kernel without VmHWM
    sampled = [0]
    done = threading.Event()

    def sample():
        while not done.wait(0.05):
            sampled[0] = max(sampled[0], _status_kib("VmRSS") or 0)

    threading.Thread(target=sample, daemon=True).start()

    def rss() -> float:  # GiB
        sampled[0] = max(sampled[0], _status_kib("VmRSS") or 0)
        return max(sampled[0], _status_kib("VmHWM") or 0) / 2**20

    steps = {"imports": rss()}
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
        steps["cuda_context"] = rss()
    counts = []
    for i, argv in enumerate(spec["argvs"]):
        if argv[0] == "GAM1_FROM":  # --gam1 of the params CSV's row at an iteration
            gam1 = read_positional_csv(argv[1])[int(argv[2]) - 1][2]
            argv = [repr(gam1) if a == "GAM1" else a for a in argv[3:]]
        reset_launches()
        with engine_log(spec["log_dir"], f"files_{i}_{argv[1]}"):
            check(cli.main(argv) == 0, f"files: {argv[:2]} returned non-zero")
        sync()
        counts.append({k: c for k, c in launches().items() if c})
        steps[f"{i}_{argv[1]}"] = rss()
    done.set()
    with open(spec["result"], "w") as f:
        json.dump(dict(loads=loads, launches=counts, rss=steps,
                       rss_from="VmHWM" if _status_kib("VmHWM") else "VmRSS sampled at 20 Hz"),
                  f)
    return 0


def _status_kib(key: str) -> int | None:
    """A kB field of /proc/self/status (None where the kernel has none)."""
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith(key + ":"):
                return int(ln.split()[1])
    return None


def run_measured(args: list[str], log_path: str, deadline: float) -> tuple[int, float]:
    """`python ARGS` from the repository's root, its output to log_path:
    (exit code, wall seconds).  Killed past `deadline` seconds."""
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        p = subprocess.Popen([sys.executable, *args], cwd=ROOT, stdout=f,
                             stderr=subprocess.STDOUT)
    try:
        p.wait(timeout=deadline)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        fail(f"{args[:3]}: killed after {deadline:.0f} s (log {log_path})")
    return p.returncode, time.perf_counter() - t0


def phase_files(dev: str, log_dir: str) -> dict:
    """Phase 11: (a) the CLI through an f64 file of FILES_N x FILES_M
    written chunk by chunk, (b) the production input path from
    per-chromosome zarr stores, (c) --profile-dir on phase 4's run."""
    d, m, cut = files_dir(FILES_M)
    try:
        rec = files_workflow(dev, d, m, log_dir)
        rec["cut"] = cut or "none"
        rec.update(files_zarr(dev, d, log_dir))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec.update(files_profile(dev, log_dir))
    return rec


def files_workflow(dev: str, d: str, m: int, log_dir: str) -> dict:
    """Phase 11 (a): the f64 file, its planted .phen and true signal; the
    CLI's int8 eigen run (FILES_ITERS iterations, dumps on), test on the
    same file and association_test --pval-method se, one after another in
    one process (files_worker) whose peak RSS must stay under
    FILES_RSS_GIB; then scripts.p_vals on the run's r1 and params CSV
    (byte for byte the SE mode's file).  The CLI's design on three slabs
    (the first rows, the middle, the ragged last) against build_design of
    the same rows bitwise; the launches of atx_int8 and ax_batch_int8
    exact; the ingest's rate beside the plain numpy reader's on one chunk;
    the ingest's rate at each of FILES_THREADS threads on a slab of
    FILES_THREADS_GIB; an M-vector dump written by the runtime's pwrite
    against a bytes copy and os.pwrite (the JAX package's numpy path);
    the int8 codes the fused f32 ingest would change on one slab."""
    from vampomi_tpu_torch import dataset
    from vampomi_tpu_torch.io import native
    from vampomi_tpu_torch.io.bin_io import read_meth_bin, read_meth_bin_plain
    from vampomi_tpu_torch.ops.operator import quantize_markers
    from vampomi_tpu_torch.scripts import p_vals

    n, k = FILES_N, FILES_ITERS
    path = os.path.join(d, "f.bin")
    free = shutil.disk_usage(d).free / 2**30
    write_s, cached = write_meth_file(path, m, dev)
    gib = os.path.getsize(path) / 2**30
    paths = planted_files(path, m, d)
    log(f"[files] {m:,} x {n:,} f64 file ({gib:.2f} GiB; {free:.1f} GiB free in {d}) written "
        f"in {write_s:.1f}s ({gib / write_s:.2f} GiB/s); /proc/meminfo's Cached grew by "
        f"{cached:.1f} GiB meanwhile")
    out = os.path.join(d, "out")
    os.makedirs(out)
    common = ["--Mt", str(m), "--out-dir", out, "--compute-dtype", "int8", "--device", dev]
    infere = ["--run-mode", "infere", "--meth-file", path, "--phen-file", paths["phen"],
              "--true-signal-file", paths["ts"], "--N", str(n), "--out-name", "f",
              "--iterations", str(k), "--stop-criteria-thr", "0", "--h2", "0.8", "--learn-vars",
              "0", "--learn-prior-delay", str(k), "--probs", paths["prior"]["probs"],
              "--vars", paths["prior"]["vars"], "--lmmse-solver", "eigen", "--seed", str(SEED)]
    test = ["--run-mode", "test", "--meth-file-test", path, "--phen-file-test", paths["phen"],
            "--N-test", str(n), "--estimate-file", os.path.join(out, "f_it_1.bin"),
            "--test-iter-range", f"1,{k}", "--out-name", "f"]
    se = ["--run-mode", "association_test", "--pval-method", "se", "--meth-file", path,
          "--phen-file", paths["phen"], "--N", str(n), "--r1-file",
          os.path.join(out, f"f_r1_it_{k}.bin"), "--gam1", "GAM1", "--out-name", "se"]
    slabs = [(0, FILES_SLAB), (m // 2 - FILES_SLAB // 2, m // 2 + FILES_SLAB // 2),
             (m - FILES_SLAB, m)]
    spec = dict(argvs=[infere + common, test + common, se + common], slabs=slabs,
                slabs_out=os.path.join(d, "slabs.npz"), result=os.path.join(d, "res.json"),
                log_dir=log_dir)
    # the SE mode reads gam1 from the run's params CSV: the worker runs it
    # after the run, so it substitutes the value there
    spec["argvs"][2] = ["GAM1_FROM", os.path.join(out, "f_params.csv"), str(k)] + spec["argvs"][2]
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    rc, wall = run_measured([os.path.join(ROOT, "chip_smoke.py"), "--files-worker",
                             os.path.join(d, "spec.json")],
                            os.path.join(log_dir, "files_worker.log"), 600)
    check(rc == 0, f"files: the CLI worker exited {rc} (log files_worker.log)")
    with open(spec["result"]) as f:
        res = json.load(f)
    rss = max(res["rss"].values())
    check(rss < FILES_RSS_GIB, f"files: the CLI process peaked at {rss:.2f} GiB RSS, "
                               f"bound {FILES_RSS_GIB}")
    # the launches: an exact eigen run's, test's one pass of its k estimates,
    # SE none (a wrapper counts kernel launches, so none off the card, where
    # the phase is rehearsed)
    want = [exact_launches("int8", "eigen", k, [], m), {"ax_batch_int8": 1}, {}]
    if not dev.startswith("cuda"):
        want = [{}, {}, {}]
    check(res["launches"] == want, f"files: infere, test and SE launched {res['launches']}, "
                                   f"want {want}")
    # the CLI's design on three slabs against build_design of the same rows
    with np.load(spec["slabs_out"]) as z:
        for i, (lo, hi) in enumerate(slabs):
            q = {}
            want_dm = build_design(read_meth_bin(path, n, hi - lo, lo), torch.int8, "cpu",
                                   quant_out=q)
            same = (np.array_equal(z[f"X{i}"], want_dm.X.numpy())
                    and z[f"qscale{i}"].tobytes() == q["scale"].tobytes()
                    and all(z[f"{key}{i}"].tobytes() == getattr(want_dm, key).numpy().tobytes()
                            for key in ("mave", "msig")))
            check(same, f"files: the CLI's design differs from build_design on rows [{lo}, {hi})")
    # outputs: finite dumps and CSVs; the x1 correlation recovers signal
    metrics = np.asarray(read_positional_csv(os.path.join(out, "f_metrics.csv")))
    check(metrics.shape[0] == k and np.all(np.isfinite(metrics)), "files: bad metrics CSV")
    x1c = metrics[:, 2]
    for i in range(1, k + 1):
        for kind in ("", "r1_"):
            check(bool(np.all(np.isfinite(read_bin_slab(os.path.join(out, f"f_{kind}it_{i}.bin"),
                                                         m)))), f"files: {kind}it_{i} not finite")
    check(x1c.max() > 0.3, f"files: x1 correlation {x1c} never passed 0.3")
    rows_t = np.asarray(read_positional_csv(os.path.join(out, "f_test.csv")))
    check(rows_t.shape == (k, 3) and np.all(np.isfinite(rows_t)), "files: bad test CSV")
    # scripts.p_vals on the run's r1 and params CSV: the SE mode's bytes
    with contextlib.redirect_stdout(open(os.path.join(log_dir, "files_p_vals.log"), "w")):
        p_vals.main(["--out-name", "pv", "--csv-params", os.path.join(out, "f_params.csv"),
                     "--r1-file", os.path.join(out, f"f_r1_it_{k}.bin"), "--it", str(k),
                     "--M", str(m), "--N", str(n)])
    check(_bytes(os.path.join(out, "pv.bin")) == _bytes(os.path.join(out, f"se_it_{k}_pval_se.bin")),
          "files: scripts.p_vals' file differs from the SE mode's")
    # the ingest against the plain numpy reader, on one chunk
    rows = max(1, dataset.CHUNK_BYTES // (8 * n))
    lo = m // 3
    t0 = time.perf_counter()
    a = read_meth_bin(path, n, rows, lo)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = np.array(read_meth_bin_plain(path, n, rows, lo))
    t_plain = time.perf_counter() - t0
    check(np.array_equal(a, b), "files: the runtime's read differs from numpy's")
    t_rows = min(m, int(FILES_THREADS_GIB * 2**30) // (8 * n))
    by_threads = ingest_by_threads(path, n, t_rows, dev)
    dump_ms = dump_write_ms(os.path.join(d, "dump"))
    # the codes the fused f32 ingest (JAX's with its extension) would change
    lo = slabs[1][0]
    x32 = np.empty((FILES_SLAB, n), dtype=np.float32)
    native.read_f64_as_f32(path, x32, 8 * lo * n)
    ties = int((quantize_markers(x32)[0] != quantize_markers(read_meth_bin(path, n, FILES_SLAB,
                                                                           lo))[0]).sum())
    secs = [json.loads(ln)["seconds"] for ln in open(os.path.join(out, "f_trace.jsonl"))]
    ingest = [round(t, 2) for t in res["loads"]]
    rate = [round(8 * m * n / t / 1e9, 3) for t in res["loads"]]
    chunk_mb = 8 * rows * n / 1e6
    log(f"[files] CLI infere, test and association_test in one process: {wall:.1f}s, peak RSS "
        f"{rss:.2f} GiB (bound {FILES_RSS_GIB}); ingest seconds {ingest} ({rate} GB/s of "
        f"file); one chunk of {rows} rows ({chunk_mb:.1f} MB): runtime {1e3 * t_native:.1f} ms "
        f"({chunk_mb / 1e3 / t_native:.2f} GB/s), numpy {1e3 * t_plain:.1f} ms "
        f"({chunk_mb / 1e3 / t_plain:.2f} GB/s); the ingest of its first {t_rows:,} rows "
        f"({8 * t_rows * n / 2**30:.2f} GiB) at each thread count (GB/s of file) {by_threads}; an M = {NS_M:,} f64 dump written in "
        f"{dump_ms['runtime']:.2f} ms by the runtime's pwrite, {dump_ms['bytes_pwrite']:.2f} ms "
        f"by a bytes copy and os.pwrite (medians of 5 in turns); iteration seconds "
        f"{[round(t, 4) for t in secs]}; x1 corr {np.round(x1c, 4).tolist()}; "
        f"test R2 {np.round(rows_t[:, 1], 4).tolist()}; launches {res['launches']}; the three "
        f"slabs bitwise build_design's; p_vals' file the SE mode's bytes; f32-tie codes of "
        f"{FILES_SLAB} x {n} on rows [{lo}, {lo + FILES_SLAB}): {ties}; peak RSS (GiB, "
        f"{res['rss_from']}) after each step {({key: round(v, 2) for key, v in res['rss'].items()})}")
    return dict(files_m=m, files_gib=gib, write_s=write_s, cli_s=wall, peak_rss_gib=rss,
                rss_steps=res["rss"], rss_from=res["rss_from"], ingest_s=res["loads"],
                ingest_gbps=rate, ingest_gbps_by_threads=by_threads,
                chunk_native_ms=1e3 * t_native, chunk_plain_ms=1e3 * t_plain,
                dump_write_ms=dump_ms, iter_s=secs, f32_tie_codes=ties)


def ingest_by_threads(path: str, n: int, rows: int, dev: str) -> dict:
    """GB/s of file of the streamed int8 ingest of the file's first `rows`
    markers with dataset.INGEST_THREADS set to each of FILES_THREADS in
    turn (restored after), the design checked equal to the first's."""
    from vampomi_tpu_torch import dataset

    sync = torch.cuda.synchronize if dev.startswith("cuda") else (lambda: None)
    keep, first, rate = dataset.INGEST_THREADS, None, {}
    try:
        for t in FILES_THREADS:
            dataset.INGEST_THREADS = t
            sync()
            t0 = time.perf_counter()
            dm, _ = dataset.stream_design(path, n, rows, 0, torch.int8, torch.device(dev))
            sync()
            rate[t] = round(8 * rows * n / (time.perf_counter() - t0) / 1e9, 3)
            if first is None:
                first = dm.X
            else:
                check(torch.equal(dm.X, first), f"files: the ingest at {t} threads differs")
    finally:
        dataset.INGEST_THREADS = keep
    return rate


def dump_write_ms(path: str, reps: int = 5) -> dict:
    """ms to write an f64 M-vector of the north star (NS_M markers) by
    write_bin_slab (the runtime's pwrite from the array's memory) and by a
    bytes copy and os.pwrite (the JAX package's numpy path), in turns:
    medians of `reps`; the two files checked equal."""
    from vampomi_tpu_torch.io.bin_io import write_bin_slab

    vec = np.random.default_rng(SEED).normal(size=NS_M)

    def bytes_pwrite(p, v):
        fd = os.open(p, os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            os.pwrite(fd, np.ascontiguousarray(v, dtype="<f8").tobytes(), 0)
        finally:
            os.close(fd)

    ms = {"runtime": [], "bytes_pwrite": []}
    for _ in range(reps):
        for key, write in (("runtime", write_bin_slab), ("bytes_pwrite", bytes_pwrite)):
            t0 = time.perf_counter()
            write(f"{path}.{key}", vec)
            ms[key].append(1e3 * (time.perf_counter() - t0))
    check(_bytes(f"{path}.runtime") == _bytes(f"{path}.bytes_pwrite"),
          "files: the dump writers' files differ")
    return {key: float(np.median(v)) for key, v in ms.items()}


def files_zarr(dev: str, d: str, log_dir: str) -> dict:
    """Phase 11 (b): two per-chromosome stores of ZARR_N x ZARR_M written by
    the port's zarr_lite, one zlib and one of Blosc/LZ4 frames; sim_top_iid
    on them (its train .bin must be the stores' rows, masked and
    transposed); then the CLI (int8, eigen) on its train split and test on
    its test split."""
    from vampomi_tpu_torch.io.blosc_lite import blosc_compress_lz4
    from vampomi_tpu_torch.io.bin_io import read_meth_bin
    from vampomi_tpu_torch.io.zarr_lite import open_array, save_array

    t0 = time.perf_counter()
    stores, out = os.path.join(d, "stores"), os.path.join(d, "sim")
    os.makedirs(stores)
    os.makedirs(out)
    rng = np.random.default_rng(SEED + 300)
    chroms = [rng.random((ZARR_N, ZARR_M)) for _ in range(2)]
    save_array(os.path.join(stores, "chr01"), chroms[0], chunks=(ZARR_N, 1024), compressor="zlib")
    p = os.path.join(stores, "chr02")
    os.makedirs(p)
    with open(os.path.join(p, ".zarray"), "w") as f:
        json.dump(dict(zarr_format=2, shape=[ZARR_N, ZARR_M], chunks=[ZARR_N, 1024], dtype="<f8",
                       compressor={"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                                   "blocksize": 0},
                       fill_value=0.0, order="C", filters=None), f)
    for c in range(ZARR_M // 1024):
        block = np.ascontiguousarray(chroms[1][:, c * 1024:(c + 1) * 1024]).astype("<f8")
        with open(os.path.join(p, f"0.{c}"), "wb") as f:
            f.write(blosc_compress_lz4(block.tobytes(), typesize=8))
    X = np.concatenate([np.asarray(open_array(os.path.join(stores, s))) for s in ("chr01", "chr02")],
                       axis=1)
    check(np.array_equal(X, np.concatenate(chroms, axis=1)), "zarr: the stores do not read back")
    m = 2 * ZARR_M
    rc, wall = run_measured(["-m", "vampomi_tpu_torch.sim.sim_top_iid", "--zarr", stores,
                                "--out", out, "--dataset", "z", "-M", str(m), "-N", str(ZARR_N),
                                "--seed", str(SEED)], os.path.join(log_dir, "files_sim.log"), 300)
    check(rc == 0, "zarr: sim_top_iid exited non-zero (log files_sim.log)")
    name = "h2_80_lam_1_run_0"
    msk = np.loadtxt(os.path.join(out, f"z_sim_{name}.msk")).astype(bool)
    n_tr, n_te = int(msk.sum()), int((~msk).sum())
    train = os.path.join(out, f"z_train_sim_{name}")
    test = os.path.join(out, f"z_test_sim_{name}")
    check(np.array_equal(read_meth_bin(train + ".bin", n_tr, m), X[msk].T),
          "zarr: sim_top_iid's train .bin is not the stores' rows, masked and transposed")
    runs = os.path.join(out, "runs")
    os.makedirs(runs)
    common = ["--Mt", str(m), "--out-dir", runs, "--compute-dtype", "int8", "--device", dev]
    with engine_log(log_dir, "files_zarr_infere"):
        check(cli.main(["--run-mode", "infere", "--meth-file", train + ".bin", "--phen-file",
                        train + ".phen", "--true-signal-file",
                        os.path.join(out, f"z_sim_{name}_beta_true.bin"), "--N", str(n_tr),
                        "--out-name", "z", "--iterations", "4", "--stop-criteria-thr", "0",
                        "--h2", "0.8", "--probs", "0.9,0.07,0.03", "--vars", "0.0,0.001,0.01",
                        "--lmmse-solver", "eigen"] + common) == 0, "zarr: CLI infere")
    with engine_log(log_dir, "files_zarr_test"):
        check(cli.main(["--run-mode", "test", "--meth-file-test", test + ".bin",
                        "--phen-file-test", test + ".phen", "--N-test", str(n_te),
                        "--estimate-file", os.path.join(runs, "z_it_1.bin"),
                        "--test-iter-range", "1,4", "--out-name", "z"] + common) == 0,
              "zarr: CLI test")
    x1 = [r[2] for r in read_positional_csv(os.path.join(runs, "z_metrics.csv"))]
    rows_t = np.asarray(read_positional_csv(os.path.join(runs, "z_test.csv")))
    check(len(x1) == 4 and np.all(np.isfinite(x1)) and rows_t.shape == (4, 3)
          and np.all(np.isfinite(rows_t)), "zarr: bad CSVs")
    took = time.perf_counter() - t0
    log(f"[files] zarr: 2 stores of {ZARR_N:,} x {ZARR_M:,} (zlib, blosc-lz4) -> sim_top_iid "
        f"({wall:.1f}s; train {n_tr} x {m}, test {n_te}; the train .bin the stores' rows) -> CLI "
        f"int8 eigen on the train split (x1 corr {np.round(x1, 4).tolist()}) and test on the "
        f"test split (R2 {np.round(rows_t[:, 1], 4).tolist()}); {took:.1f}s")
    return dict(zarr_s=took)


def profile_trace(trace_dir: str) -> tuple[list, int, int]:
    """The events of the one Chrome trace --profile-dir wrote into
    trace_dir, and the launches it names of atx_int8.cu's kernel and of
    ax_batch_int8.cu's (xtw.cuh on int8 codes)."""
    traces = os.listdir(trace_dir)
    check(len(traces) == 1 and traces[0].startswith("rank0.")
          and traces[0].endswith(".pt.trace.json"), f"profile: traces {traces}")
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    return (events, sum("atx_int8_kernel" in k for k in kern),
            sum("xtw_kernel" in k and "ByteCodes<1>" in k for k in kern))


def device_busy(events: list) -> tuple[float, float]:
    """(ms the card ran a kernel, copy or set in the trace, ms from its
    first event to its last): the union of the device's intervals, so
    overlapping streams count once."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    timed = [e for e in events if e.get("ph") == "X"]
    span = max(e["ts"] + e.get("dur", 0) for e in timed) - min(e["ts"] for e in timed)
    return busy / 1e3, span / 1e3


def _without_walls(rec: dict) -> dict:
    """A _trace.jsonl record without its walls, which differ from run to
    run: `seconds` goes, and of `phases` only the counted "passes" stay."""
    rec = {key: v for key, v in rec.items() if key != "seconds"}
    rec["phases"] = {"passes": rec["phases"]["passes"]}
    return rec


def files_profile(dev: str, log_dir: str, n: int = 2_000, m: int = 8_000, iters: int = 8) -> dict:
    """Phase 11 (c): phase 4's int8 eigen CLI run (its fixture, seed and
    flags) here, then with --profile-dir in a subprocess with a deadline:
    the trace parses as JSON and names the kernels of atx_int8.cu and
    ax_batch_int8.cu (xtw.cuh on int8 codes), and every output file is the
    run's without the flag, byte for byte (the trace.jsonl telemetry
    without its walls: its counted passes stay); the card's busy share of
    the trace."""
    with tempfile.TemporaryDirectory(prefix="vampomi_prof_") as d:
        fx = simulate_iid(n=n, m=m, lam=0.1, h2=0.8, seed=SEED)
        paths = write_fixture(fx, d, "ex")
        for sub in ("plain", "prof"):
            os.makedirs(os.path.join(d, sub))

        def argv(sub):
            return ["--run-mode", "infere", "--model", "linear", "--meth-file", paths["bin"],
                    "--phen-file", paths["phen"], "--true-signal-file", paths["ts"], "--N",
                    str(n), "--Mt", str(m), "--out-dir", os.path.join(d, sub), "--out-name", "r",
                    "--iterations", str(iters), "--stop-criteria-thr", "0", "--h2", "0.8",
                    "--probs", "0.9,0.07,0.03", "--vars", "0.0,0.001,0.01", "--device", dev,
                    "--compute-dtype", "int8", "--lmmse-solver", "eigen"]

        t0 = time.perf_counter()
        with engine_log(log_dir, "files_profile_plain"):
            check(cli.main(argv("plain")) == 0, "profile: the run without the flag")
        plain_s = time.perf_counter() - t0
        trace_dir = os.path.join(d, "trace")
        rc, prof_s = run_measured(["-m", "vampomi_tpu_torch.cli", *argv("prof"),
                                      "--profile-dir", trace_dir],
                                     os.path.join(log_dir, "files_profile.log"), 300)
        check(rc == 0, "profile: --profile-dir exited non-zero (log files_profile.log)")
        events, atx, xtw = profile_trace(trace_dir)
        busy_ms, span_ms = device_busy(events)
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        want = (iters + 1, iters) if dev.startswith("cuda") else (0, 0)  # no card: no kernels
        check((atx, xtw) == want and any(e.get("name", "").startswith("aten::") for e in events),
              f"profile: the trace holds {atx} atx_int8 and {xtw} int8 xtw kernels, want {want}")
        files = sorted(os.listdir(os.path.join(d, "plain")))
        check(files == sorted(os.listdir(os.path.join(d, "prof"))), "profile: other files")
        for f in files:
            a, b = (_bytes(os.path.join(d, s, f)) for s in ("plain", "prof"))
            if f.endswith("_trace.jsonl"):
                a, b = ([_without_walls(json.loads(ln)) for ln in x.decode().splitlines()]
                        for x in (a, b))
            check(a == b, f"profile: {f} differs with --profile-dir")
        size = sum(os.path.getsize(os.path.join(trace_dir, t)) for t in os.listdir(trace_dir)) / 1e6
        it_ms = [1e3 * float(np.median([json.loads(ln)["seconds"] for ln in open(
            os.path.join(d, sub, "r_trace.jsonl"))][1:])) for sub in ("plain", "prof")]
    log(f"[files] --profile-dir on phase 4's int8 eigen run ({iters} iterations): {prof_s:.1f}s "
        f"in a subprocess (its start and CUDA context included) against {plain_s:.1f}s in this "
        f"process without it; an iteration {it_ms[1]:.2f} ms profiled against {it_ms[0]:.2f} ms "
        f"(medians of iterations 2..{iters}); trace {size:.1f} MB, "
        f"{len(events)} events, {len(kernels)} kernel names, atx_int8 {atx} and the int8 xtw "
        f"{xtw} launches; the card busy {busy_ms:.1f} of the trace's {span_ms:.1f} ms; "
        f"{len(files)} output files byte for byte the run's without the flag")
    return dict(profile_s=prof_s, profile_plain_s=plain_s, profile_iter_ms=it_ms[1],
                plain_iter_ms=it_ms[0], trace_mb=size, busy_ms=busy_ms, span_ms=span_ms)


def main_dumps(out_dir: str, dtype: str, solver: str, k: int) -> tuple[str, str, float]:
    """The last iteration's estimate and r1 dumps of a main-path run, and the
    gam1 its params CSV pairs with that r1."""
    base = os.path.join(out_dir, f"main_{dtype}_{solver}")
    gam1 = read_positional_csv(f"{base}_params.csv")[k - 1][2]
    return f"{base}_it_{k}.bin", f"{base}_r1_it_{k}.bin", gam1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log-dir", default="",
                   help="keep the engine's logs here (default: a temporary "
                        "directory, removed at the end)")
    p.add_argument("--gibbs-reference", default="", metavar="CU",
                   help="an earlier gibbs_block.cu to hold the Gibbs kernel against in "
                        "phase 7: bitwise, and timed in turns")
    p.add_argument("--ranks-worker", default="", metavar="SPEC", help=argparse.SUPPRESS)
    p.add_argument("--cli-ranks", default="", metavar="SPEC", help=argparse.SUPPRESS)
    p.add_argument("--files-worker", default="", metavar="SPEC", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.files_worker:  # the CLI process of phase 11 (a)
        return files_worker(args.files_worker)
    if args.ranks_worker:  # one process of phase 10, started by phase 10
        return ranks_worker(args.ranks_worker)
    if args.cli_ranks:  # one rank of phase 10 (b)'s run modes
        return cli_ranks_worker(args.cli_ranks)
    t_start = time.perf_counter()
    dev = phase_device()
    smi = card_info(torch.device(dev))["nvidia_smi"]
    timing = {}

    @contextlib.contextmanager
    def timed(name: str):
        """Add the block's wall seconds to timing[name]."""
        t = time.perf_counter()
        yield
        timing[name] = round(timing.get(name, 0.0) + time.perf_counter() - t, 1)

    with tempfile.TemporaryDirectory(prefix="vampomi_smoke_") as out_dir:
        log_dir = args.log_dir or out_dir
        os.makedirs(log_dir, exist_ok=True)
        t0 = time.perf_counter()
        with timed("1_build"):
            phase_build()
        with timed("2_kernel"):
            X8, X4, recs = phase_kernel(dev)
        with timed("2b_probe"):
            probe_recs, probe_counts = phase_probe(dev, X8, X4)
        recs.update(probe_recs)
        with timed("2c_gram"):
            recs["gram_tc"] = phase_gram(dev)
        with timed("3_parity"):
            for dtype in DTYPES:
                phase_parity(dev, dtype, log_dir, out_dir)
                phase_parity(dev, dtype, log_dir, out_dir, model="bin_class")
            phase_parity(dev, "int8", log_dir, out_dir, model="bin_class", c=2,
                         iters={"spectral": 3, "cg": 2})
            phase_parity(dev, "int8", log_dir, out_dir, c=2, iters={"eigen": 3})
            phase_parity(dev, "bf16", log_dir, out_dir)
        with timed("4_cli"):
            phase_cli(dev, log_dir)
            phase_cli_probit(dev, log_dir)
        with timed("4b_resume"):
            phase_resume(dev, log_dir)
        with timed("7_gibbs"):
            for dtype in PARITY_DTYPES:
                phase_gibbs_parity(dev, dtype)
            phase_gibbs_workflow(dev, log_dir)
        with timed("5_main_int8"):
            main8 = phase_main("int8", lambda: design_from_codes(X8), log_dir, out_dir,
                               x1_min=0.4, runs=MAIN_RUNS_INT8,
                               cache=os.path.join(out_dir, "eigen_int8.npz"),
                               checkpoint_cost=True)
        counts = dict(main8.launches)
        with timed("5b_modes"):
            mode_recs, mode_counts = phase_modes(
                "int8", main8, out_dir, *main_dumps(out_dir, "int8", "auto", 4), test_runs=5)
        recs.update(mode_recs)
        counts.update(mode_counts)
        with timed("5c_probit"):
            probit_counts = phase_probit_main(main8, log_dir, out_dir)
        for name in ("atx_int8", "ax_batch_int8", "atx_batch_int8", "gram_tc"):  # both paths
            counts[name] += probit_counts[name]
        with timed("7_gibbs"):
            recs["gibbs_block_update"] = phase_gibbs_kernel(main8, args.gibbs_reference)
            gibbs_counts = phase_gibbs_main("int8", main8, out_dir, sweeps=3)
        for name in ("gibbs_block_update", "atx_int8", "ax_batch_int8"):  # and the sampler's
            counts[name] = counts.get(name, 0) + gibbs_counts[name]
        del X8, main8
        torch.cuda.empty_cache()  # the int8 X goes before the int4 path
        with timed("6_int4"):
            main4 = phase_main("int4", lambda: design_from_packed(X4), log_dir, out_dir,
                               x1_min=X1_MIN_INT4)
            counts.update({name: c for name, c in main4.launches.items()
                           if name in ("atx_packed4", "ax_batch_packed4", "atx_batch_packed4")})
            counts["gram_tc"] += main4.launches["gram_tc"]
            mode_recs, mode_counts = phase_modes(
                "int4", main4, out_dir, *main_dumps(out_dir, "int4", "eigen", 5), test_runs=5)
        recs.update(mode_recs)
        counts.update(mode_counts)
        with timed("7_gibbs"):
            gibbs_counts = phase_gibbs_main("int4", main4, out_dir, sweeps=2)
        for name in ("gibbs_block_update", "atx_packed4", "ax_batch_packed4"):
            counts[name] += gibbs_counts[name]
        del X4, main4
        torch.cuda.empty_cache()  # the packed X goes before the bf16 path
        with timed("8_bf16"):
            main16 = phase_main("bf16", lambda: bf16_design(dev), log_dir, out_dir, x1_min=0.4,
                                runs=MAIN_RUNS_BF16)
            counts.update({name: c for name, c in main16.launches.items()
                           if name.endswith("bf16")})
            counts["gram_tc"] += main16.launches["gram_tc"]
            phase_modes("bf16", main16, out_dir, *main_dumps(out_dir, "bf16", "auto", 4),
                        test_runs=4)
        with timed("7_gibbs"):
            gibbs_counts = phase_gibbs_main("bf16", main16, out_dir, sweeps=2)
        for name in ("gibbs_block_update", "atx_bf16", "ax_batch_bf16"):
            counts[name] += gibbs_counts[name]
        del main16
        torch.cuda.empty_cache()
        with timed("9_doctor"):
            phase_doctor()
        with timed("11_files"):
            files = phase_files(dev, log_dir)
        with timed("10a_ranks"):
            ranks = phase_ranks_main(dev, log_dir, out_dir)
        with timed("10b_ranks_cli"):
            ranks.update(phase_ranks_cli(dev, log_dir))
        counts.update(probe_counts)
        for name, c in counts.items():
            check(c > 0, f"{name} was never launched on its own path")
        timing["total"] = round(time.perf_counter() - t_start, 1)
        log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    kernels = [dict(name=name, route="cuda", source=k.source, replaces=k.replaces,
                    launches=counts[name],
                    **{key: recs[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                        "bound_ms", "bound_by", "library_ms")})
               for name, k in KERNELS.items()]
    print("[timing] " + json.dumps(timing), flush=True)
    print(json.dumps({"ranks": dict(card=smi, **ranks)}))
    print(json.dumps({"files": dict(card=smi, **files)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
