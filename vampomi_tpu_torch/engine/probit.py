"""Probit (binary classification) GLM-VAMP engine (port of
vampomi_tpu/engine/probit.py; reference `vamp::infere_bin_class`,
src/vamp_probit.cpp:19-467).  Four half-steps an iteration over the pair
(x, z = A x):

  1. denoise x with the spike+mixture prior (g1/g1d, as in the linear model),
     with rho-damping applied to BOTH x1_hat and alpha1 for it > 1
     (src/vamp_probit.cpp:160-165);
  2. denoise z with the probit-likelihood posterior (g1_bin_class) and form
     the extrinsic pair (p2, tau2) (src/vamp_probit.cpp:213-253);
  3. LMMSE x: (tau2 A^T A + gam2 I) x = tau2 A^T p2 + gam2 r2, by CG from a
     zero start every iteration (src/vamp_probit.cpp:300-311) with the
     Hutchinson Onsager alpha2, or exactly (spectral, eigen) with alpha2 in
     closed form;
  4. LMMSE z: z2 = A x2, beta2 = (Mt/N)(1 - alpha2), extrinsic (p1, tau1)
     (src/vamp_probit.cpp:352-376).

X passes an iteration: the exact solvers read X three times (atx of p2, one
two-column ax_batch for z1_pred and A v, atx of S^{-1} A v); z2 is the
push-through q.  CG reads it for atx of p2, ax of x1, two a step, and ax of
x2.

As in the linear engine, the phases run eagerly and each iteration's O(1)
outputs reach the host in ONE batched copy, which is also the iteration's
synchronisation point.  Inside the loop's `solve` span the phase times
`denoise` (g1, g1d, alpha1), `zdenoise` (the z-denoisers, beta1, p2, tau2),
`dense` (an exact solver's N x N step), `zlmmse` (beta2, p1, tau1) and
`confusion` (both classification halves) as host walls
(utils/telemetry.py span); each pass over X has its `xpass` span.

Faithful quirks: eta1 uses the UNdamped alpha1 (src/vamp_probit.cpp:130)
while r2 uses the damped x1_hat; g1 runs with the PREVIOUS iteration's prior
(EM runs after the phase, on the r1 it consumed, src/vamp_probit.cpp:113,139
— not on --learn-prior-delay's schedule); beta1 >= N is clamped to N - 1;
the prior CSV row stores the internally-scaled (×N) variances
(src/vamp_probit.cpp:427-428); the params CSV has 8 values under the 6-name
linear header (src/vamp.cpp:72-77 + vamp_probit.cpp:22).

Random draws come from one CPU torch.Generator seeded with --seed: the
initial p1 ~ N(0, 1)^N first (src/vamp_probit.cpp:53), then one Rademacher
probe an iteration under every solver, as the JAX engine splits its key
(the linear engine's `_ProbeStream`: an exact solver's probes are owed, and
drawn only before a checkpoint reads the generator's state).  One seed
gives the same draws on the CPU and on a card.  Checkpoint/resume and the
eigen cache work as in the linear engine (engine/checkpoint.py,
ops/eigen.py); the probit state adds r2, p1, p2 and the covariate offsets.
The JAX engine's compile-ahead threads are a TPU workaround with no
counterpart.

Sharded over markers (`dm.shard`, sharding.py), each rank runs this loop on
its slab, as the linear engine does.  The sums over markers meet the other
ranks in as few all_reduces as the data flow allows: an exact iteration
makes three (alpha1, which the LMMSE step needs; the two-column ax_batch
pass; the error measures and the NMSE at its end) and, from iteration 2,
one more for the EM update; a CG iteration makes seven (alpha1; A x1 for
the metrics; the solve's first pass and first batch; alpha2's probe dot;
z2 = A x2; the late sums) and three a CG step, plus the EM update's.  The
N-vectors (p1, p2, z, the labels, the covariate offsets) are replicated,
and every branch reads a replicated value.  Rank 0 fits the covariates and
broadcasts them, and alone writes the CSVs, the trace and the checkpoint
(the full vectors, gathered on the main thread); each rank writes its slab
of the dumps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import RunConfig
from ..glm.probit import g1_bin_class, g1d_bin_class
from ..io.bin_io import HostCopy, HostStager
from ..ops.cg import cg_solve
from ..ops.operator import Consts, DesignMatrix, atx, ax, ax_batch, f64
from ..prior.mixture import MixturePrior, g1, g1d, init_prior
from ..sharding import all_reduce_, all_reduce_many, broadcast_, gather_m, is_writer, local_rows
from ..utils.async_writer import AsyncWriter
from ..utils.mathx import normal_cdf
from ..utils.telemetry import span
from .checkpoint import load_resume
from .linear import (
    _clamp, _draw_probe, _em_phase, _log, _m_global, _nmse_from, _nmse_sums, _ProbeStream,
    build_lmmse_factor, checkpoint_iteration, choose_lmmse_solver, dump_iteration,
    fit_covariates, flush_timed, open_csvs, restore_generator, restore_prior, restore_vectors,
    trace_of, warn_em_stability,
)
from .metrics import confusion_counts, signal_from_sums, signal_sums


class ProbitResult(NamedTuple):
    x1_hat_scaled: np.ndarray   # (Mt,) estimate in file units (x1_hat/sqrt(N))
    iterations_run: int
    gam1: float
    tau1: float
    cov_eff: np.ndarray | None
    probs: np.ndarray
    vars: np.ndarray            # internal (×N) scale
    metrics_history: list
    # final denoiser-input extrinsic in file units (r1/sqrt(N)); see
    # engine/linear.py LinearResult for the (r1, gam1) pairing
    r1_scaled: np.ndarray | None = None
    iter_seconds: list | None = None
    # wall seconds of the once-per-run setup, and the eigen residual:
    # {"cov", "gram", "eigh", "eigen_resid"} as far as the run needed them,
    # and "dump.flush" with the outputs on (LinearResult's)
    setup: dict | None = None
    # the LMMSE solver that ran: auto resolved, after the eigen fallbacks
    solver: str | None = None
    # collectives each iteration ran (sharded runs; sharding.Shard.counts)
    iter_collectives: list | None = None
    # each iteration's {span: host seconds}, "passes" and the counters,
    # the outputs' among them (LinearResult's)
    iter_phases: list | None = None
    # each iteration's params row [alpha1, beta1, gam1, tau1, alpha2, beta2,
    # gam2, tau2], as the params CSV writes it
    params_history: list | None = None


def _probit_phase(
    dm: DesignMatrix,
    y,                # 0/1 labels (N,)
    m_cov,            # covariate offsets Z @ cov_eff (N,)
    r1, r2, p1, p2,
    gam1, tau1, alpha1_prev,
    prior: MixturePrior,
    x1_hat_prev,
    damp: bool,       # apply rho-damping (it > 1)
    rho, probit_var,
    bern,             # Rademacher probe, +-1/sqrt(Mt) (CG only; else None)
    true_signal_scaled,   # sqrt(N) * beta
    cg_max_iter, cg_err_tol,
    fac=None,         # GramFactor (spectral), EigenFactor (eigen) or None (CG)
    debug: bool = False,  # --verbosity 1 per-CG-iteration prints
    consts: Consts | None = None,  # the fit's numbers on the device
) -> dict:
    """One probit GLM-VAMP iteration (JAX engine/probit.py:76-231).  M/N
    vectors in the work dtype; scalars f64.  With a factor the LMMSE step is
    exact, its N x N step `fac.solve`; without one, CG."""
    wd = dm.wd
    dev = dm.device
    consts = consts or Consts(dev)
    c = lambda s: consts(s, wd)  # noqa: E731 — scalar → work dtype
    gam1 = f64(gam1, dev)
    tau1 = f64(tau1, dev)
    alpha1_prev = f64(alpha1_prev, dev)
    r1, r2, p1, p2 = (t.to(wd) for t in (r1, r2, p1, p2))
    y = y.to(wd)
    m_cov = m_cov.to(wd)
    x1_hat_prev = x1_hat_prev.to(wd)
    ts = true_signal_scaled.to(wd)
    inv_sqrt_n = c(1.0 / math.sqrt(dm.n))

    # ---------- denoise x (src/vamp_probit.cpp:97-165) ----------
    with span("denoise"):
        x1_new = g1(r1, gam1, prior)
        g1d_sum = all_reduce_((g1d(r1, gam1, prior) * dm.mmask).sum(), dm.shard)
        alpha1_new = g1d_sum.to(torch.float64) / dm.mt
        eta1 = gam1 / alpha1_new  # uses UNdamped alpha1 (line 130)
        if damp:
            x1_hat = c(rho) * x1_new + c(1.0 - rho) * x1_hat_prev
            alpha1 = rho * alpha1_new + (1.0 - rho) * alpha1_prev
        else:
            x1_hat, alpha1 = x1_new, alpha1_new

        gam2 = _clamp(eta1 - gam1)
        r2_new = (c(eta1) * x1_hat - c(gam1) * r1) / c(gam2)

    # ---------- denoise z (src/vamp_probit.cpp:200-253) ----------
    with span("zdenoise"):
        z1_hat = g1_bin_class(p1, c(tau1), y, m_cov, c(probit_var))
        beta1 = g1d_bin_class(p1, c(tau1), y, m_cov, c(probit_var)).sum().to(torch.float64)
        beta1 = torch.where(beta1 >= dm.n, dm.n - 1.0, beta1) / dm.n
        p2_new = (z1_hat - c(beta1) * p1) / c(1.0 - beta1)
        tau2 = tau1 * (1.0 - beta1) / beta1

    # ---------- LMMSE x (src/vamp_probit.cpp:291-346) ----------
    v = c(tau2) * atx(dm, p2_new) + c(gam2) * r2_new
    cg_iters = 0
    if fac is not None:
        # z1_pred (the denoising metrics, src/vamp_probit.cpp:269-287) shares
        # the A-pass with A v; z2_hat = A x2_hat is the push-through
        # q = S^{-1} A v, S = gam2 I + tau2 K: the factor's N x N step, as
        # in the linear engine, then the third pass, A^T q
        Z = ax_batch(dm, torch.stack([x1_hat * inv_sqrt_n, v], dim=1))
        z1_pred = Z[:, 0]
        av = Z[:, 1]
        with span("dense"):
            q, tr_qinv, _ = fac.solve(av, tau2, gam2, dm.mt)
        x2_hat = (v - c(tau2) * atx(dm, q)) / c(gam2)
        z2_hat = q
        alpha2 = gam2 * tr_qinv / dm.mt
    else:
        z1_pred = ax(dm, x1_hat * inv_sqrt_n)
        V = torch.stack([v, bern.to(wd)], dim=1)
        res = cg_solve(
            dm, V, torch.zeros_like(V), tau2, gam2,  # from zero every iteration
            max_iter=int(cg_max_iter), tol=float(cg_err_tol),
            onsager_cols=torch.tensor([False, True], device=dev),
            debug=debug,
        )
        x2_hat = res.mu[:, 0]
        invq_bern = res.mu[:, 1]
        alpha2 = gam2 * all_reduce_(torch.dot(bern.to(wd), invq_bern), dm.shard).to(
            torch.float64)
        z2_hat = ax(dm, x2_hat)
        cg_iters = res.iters

    # metrics, denoising half (src/vamp_probit.cpp:269-287)
    with span("confusion"):
        y1_hat = (normal_cdf(z1_pred) >= 0.5).to(wd)
        tp1, tn1, fp1, fn1 = confusion_counts(y, y1_hat)
        acc1 = (tp1 + tn1).to(torch.float64) / dm.n

    # the error measures over markers, summed over the ranks in one
    # all_reduce: nothing inside the iteration reads them
    s1, s2, nm = all_reduce_many(
        [signal_sums(x1_hat, ts, consts(dm.n)), signal_sums(x2_hat, ts, consts(dm.n)),
         _nmse_sums(x1_hat, x1_hat_prev)], dm.shard)
    x1_corr, x2_corr = signal_from_sums(s1)[0], signal_from_sums(s2)[0]

    r1_new = (x2_hat - c(alpha2) * r2_new) / c(1.0 - alpha2)
    gam1_new = _clamp(gam2 * (1.0 - alpha2) / alpha2)

    # ---------- LMMSE z (src/vamp_probit.cpp:351-376) ----------
    with span("zlmmse"):
        beta2 = dm.mt / dm.n * (1.0 - alpha2)
        p1_new = (z2_hat - c(beta2) * p2_new) / c(1.0 - beta2)
        tau1_new = _clamp(tau2 * (1.0 - beta2) / beta2)

    # metrics, LMMSE half (src/vamp_probit.cpp:402-420); the reference
    # recomputes Ax at x2/sqrt(N) — algebraically z2_hat * inv_sqrt_n
    with span("confusion"):
        y2_hat = (normal_cdf(z2_hat * inv_sqrt_n) >= 0.5).to(wd)
        tp2, tn2, fp2, fn2 = confusion_counts(y, y2_hat)
        acc2 = (tp2 + tn2).to(torch.float64) / dm.n

    counts = [t.to(torch.float64) for t in (tp1, tn1, fp1, fn1, tp2, tn2, fp2, fn2)]
    metrics = torch.stack(counts[:4] + [acc1, x1_corr] + counts[4:] + [acc2, x2_corr])
    params = torch.stack([alpha1, beta1, gam1, tau1, alpha2, beta2, gam2, tau2])

    return dict(
        nmse=_nmse_from(nm),
        x1_hat=x1_hat, alpha1=alpha1, gam2=gam2, r2=r2_new,
        x2_hat=x2_hat, alpha2=alpha2, r1=r1_new, gam1=gam1_new,
        p1=p1_new, p2=p2_new, tau1=tau1_new, tau2=tau2,
        z1_hat=z1_hat, metrics=metrics, params=params, cg_iters=cg_iters,
    )


def _draw_p1(gen: torch.Generator, n: int, wd: torch.dtype, dev: torch.device) -> torch.Tensor:
    """The initial z-extrinsic p1 ~ N(0, 1)^N (src/vamp_probit.cpp:53):
    drawn in f64 from the run's CPU generator, then cast and copied to the
    run's device, so one seed gives the same p1 on the CPU and on a card."""
    return torch.randn(n, generator=gen, dtype=torch.float64).to(device=dev, dtype=wd)


def infere_bin_class(
    dm: DesignMatrix,
    y: np.ndarray,
    cfg: RunConfig,
    true_signal: np.ndarray | None = None,
    x1hat_init: np.ndarray | None = None,
    covariates: np.ndarray | None = None,
    write_outputs: bool = True,
) -> ProbitResult:
    """Run probit GLM-VAMP.  `y` (0/1), `true_signal`, `x1hat_init` and the
    (N, C) z-scored `covariates` are host arrays in file units (the global
    Mt markers; a sharded `dm` takes its slab of them); `dm` is the design
    operator on the run's device."""
    M_pad = dm.m_pad
    Mt = int(dm.mt)
    N = int(dm.n)
    sqrt_n = float(np.sqrt(N))
    wd = dm.wd
    dev = dm.device
    shard = dm.shard
    lo = 0 if shard is None else shard.lo

    def pad_m(vec):
        out = np.zeros(M_pad, dtype=np.float64)
        if vec is not None:
            vec = local_rows(vec, shard)
            out[: len(vec)] = vec
        return torch.as_tensor(out).to(device=dev, dtype=wd)

    ts_scaled = pad_m(np.asarray(true_signal) * sqrt_n if true_signal is not None else None)
    x1_hat = pad_m(np.asarray(x1hat_init) / sqrt_n if x1hat_init is not None else None)
    r1 = torch.zeros(M_pad, dtype=wd, device=dev)   # src/vamp_probit.cpp:55
    r2 = torch.zeros(M_pad, dtype=wd, device=dev)
    alpha1 = f64(0.0, dev)

    y_t = torch.as_tensor(np.asarray(y, dtype=np.float64)).to(device=dev, dtype=wd)
    prior = init_prior(cfg.probs, cfg.vars, N, device=dev)
    gam1 = f64(float(cfg.gam1), dev)
    tau1 = gam1  # src/vamp_probit.cpp:35
    rho = float(cfg.rho)
    probit_var = float(cfg.probit_var)

    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(cfg.seed))
    p1 = _draw_p1(gen, N, wd, dev)  # src/vamp_probit.cpp:53
    p2 = torch.zeros(N, dtype=wd, device=dev)

    setup = {}
    cov_eff = None
    m_cov = torch.zeros(N, dtype=wd, device=dev)
    if cfg.C > 0 and covariates is not None and covariates.shape[1] > 0:
        with span("cov", into=setup):
            cov_eff = fit_covariates(y, covariates, cfg, shard)
            m_cov = broadcast_(torch.as_tensor(covariates @ cov_eff).to(device=dev, dtype=wd),
                               shard)

    solver = choose_lmmse_solver(cfg, Mt, N, shard)
    warn_em_stability(cfg, Mt, N)

    # exact-state resume (vampomi_tpu/engine/probit.py:353-378)
    it_start = 1
    if cfg.resume_file:
        ck = load_resume(cfg.resume_file, model="bin_class", solver=solver,
                         mt=Mt, n=N, m_pad=_m_global(dm))
        x1_hat, r1, r2 = restore_vectors(ck, ("x1_hat", "r1", "r2"), dev, wd, shard)
        p1, p2 = restore_vectors(ck, ("p1", "p2"), dev, wd)
        if "m_cov" in ck["arrays"]:
            (m_cov,) = restore_vectors(ck, ("m_cov",), dev, wd)
        sc = ck["scalars"]
        gam1, tau1, alpha1 = f64(sc["gam1"], dev), f64(sc["tau1"], dev), f64(sc["alpha1"], dev)
        prior = restore_prior(ck, dev)
        restore_generator(gen, ck, cfg.resume_file)
        it_start = ck["iteration"] + 1
        _log(f"...resumed exact state from {cfg.resume_file} at iteration {it_start}")

    if write_outputs:
        out_metrics, out_params, out_prior = open_csvs(cfg)
    solver, fac = build_lmmse_factor(dm, cfg, solver, setup)
    probes = _ProbeStream(gen, dm, _draw_probe)
    consts = Consts(dev)  # the numbers the iterations read on the device

    writer = AsyncWriter()
    stager = HostStager(dev)
    io_phases = {}  # the IO thread's spans of each iteration's dump
    tracer = trace_of(dm, cfg, write_outputs, probes, writer)

    metrics_history = []
    params_history = []
    iter_collectives = [] if shard is not None else None
    it_done = 0
    L = prior.L

    try:
        for it in range(it_start, cfg.iterations + 1):
            tracer.start()
            coll0 = shard.collectives() if shard is not None else 0
            _log(f"\n********************\niteration = {it}\n********************")

            x1_prev = x1_hat
            r1_in = r1  # the r1 this iteration denoises; dumped to _r1_it_<k>.bin
            bern = None
            if fac is None:
                with span("probe"):
                    bern = probes.draw()
            with span("solve"):
                out = _probit_phase(
                    dm, y_t, m_cov, r1, r2, p1, p2,
                    gam1, tau1, alpha1, prior, x1_prev,
                    it > 1, rho, probit_var,
                    bern, ts_scaled,
                    cfg.CG_max_iter, cfg.CG_err_tol,
                    fac=fac, debug=cfg.verbosity == 1, consts=consts,
                )
            if fac is not None:
                with span("probe"):
                    probes.skip()

            # EM prior update for the NEXT iteration (g1 above used the old
            # prior; the reference calls updatePrior after the denoiser,
            # src/vamp_probit.cpp:139)
            with span("em"):
                if it > 1:
                    prior = _em_phase(
                        dm, r1_in, gam1, prior, cfg.EM_max_iter, cfg.EM_err_thr,
                        bool(cfg.learn_vars), cfg.merge_vars_thr,
                        cfg.em_signal_budget(N), debug=cfg.verbosity == 1,
                        consts=consts,
                    )

            x1_hat = out["x1_hat"]
            alpha1 = out["alpha1"]
            r1, r2 = out["r1"], out["r2"]
            p1, p2 = out["p1"], out["p2"]
            gam1, tau1 = out["gam1"], out["tau1"]

            # ONE batched host copy of every O(1) output; it also waits for
            # the iteration's device work
            with span("fetch"):
                host = torch.cat([
                    torch.stack([out["nmse"], gam1, tau1]),
                    out["params"], out["metrics"], prior.probs, prior.vars,
                    prior.active.to(torch.float64),
                ]).cpu().numpy()
            with span("report"):
                nmse, gam1_h, tau1_h = host[:3].tolist()
                params = host[3:11]
                metrics = host[11:23]
                probs_h, vars_h = host[23:23 + L], host[23 + L:23 + 2 * L]
                act = host[23 + 2 * L:] > 0.5
                cg_iters = int(out["cg_iters"])

                if write_outputs:
                    with span("dump.stage"):
                        writer.submit(dump_iteration, cfg, Mt, sqrt_n, it,
                                      stager.copy((x1_hat, r1_in)), lo,
                                      io_phases.setdefault(it, {}))

                metrics_history.append(metrics)
                params_history.append(params)
                if write_outputs:
                    with span("csv"):
                        out_params.write_row(it, params.tolist())
                        out_metrics.write_row(it, metrics.tolist())
                        pr = probs_h[act]
                        vr = vars_h[act]  # internal ×N scale (src/vamp_probit.cpp:428)
                        out_prior.write_row(it, [float(len(pr))] + pr.tolist() + vr.tolist())

                _log(f"params [a1,b1,g1,t1,a2,b2,g2,t2] = {params}")
                _log(f"acc1 = {metrics[4]:.4f}, acc2 = {metrics[10]:.4f}, "
                     f"x1_corr = {metrics[5]:.4f}, CG iters = {cg_iters}")

                if cfg.checkpoint_file:  # vampomi_tpu/engine/probit.py:563-572
                    names = ("x1_hat", "r1", "r2", "p1", "p2", "m_cov")
                    vecs = (x1_hat, r1, r2, p1, p2, m_cov)
                    # a sharded run gathers the M-vectors here, on the main
                    # thread (a collective never runs on the IO thread); the
                    # N-vectors are replicated and taken as they are
                    copy = (stager.copy(vecs) if shard is None
                            else HostCopy([gather_m(v, shard) for v in vecs[:3]]
                                          + [v.cpu() for v in vecs[3:]]))
                    if is_writer():
                        writer.submit(
                            checkpoint_iteration, cfg, "bin_class", dm, it, copy, names, {},
                            dict(gam1=gam1_h, tau1=tau1_h, gam2=params[6], alpha1=params[0]),
                            dict(probs=probs_h, vars=vars_h, active=act), probes.state(),
                        )
                if shard is not None:
                    iter_collectives.append(shard.collectives() - coll0)
            _log(tracer.line(tracer.stop(it, cg_iters, gam1=gam1_h, tau1=tau1_h)))
            it_done = it

            _log(f"x1_hat NMSE = {nmse if np.isfinite(nmse) else 'n/a (zero previous iterate)'}")
            if it > 1 and nmse < cfg.stop_criteria_thr:
                _log("...stopping criteria fulfilled")
                break
    finally:
        tracer.close()
        flush_timed(writer, setup, write_outputs)  # artifacts durably on disk even on error paths
    tracer.fold(io_phases)

    act = prior.active.cpu().numpy()
    return ProbitResult(
        x1_hat_scaled=gather_m(x1_hat, shard).numpy().astype(np.float64)[:Mt] / sqrt_n,
        iterations_run=it_done,
        gam1=float(gam1),
        tau1=float(tau1),
        cov_eff=cov_eff,
        probs=prior.probs.cpu().numpy()[act],
        vars=prior.vars.cpu().numpy()[act],
        metrics_history=metrics_history,
        r1_scaled=gather_m(r1, shard).numpy().astype(np.float64)[:Mt] / sqrt_n,
        iter_seconds=[r.seconds for r in tracer.records],
        setup=setup,
        solver=solver,
        iter_collectives=iter_collectives,
        iter_phases=[r.phases for r in tracer.records],
        params_history=params_history,
    )
