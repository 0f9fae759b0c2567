"""One rank of a multi-rank test run of the port (tests/torch_ranks.py).

    python tests/rank_worker.py RANK WORLD STORE JOBS.json

WORLD 0 runs the jobs as one process without a process group; otherwise the
rank joins a gloo group of WORLD ranks through the file store STORE and runs
each job on its slab of the markers.  Each job is one `infere_linear` or,
with model "bin_class", `infere_bin_class` run (`run_job`); with kind
"collectives", a check of the sharding helpers (`collectives_job`); with
kind "modes", the run modes on given estimate files (`modes_job`); with kind
"api", the array API with shard="auto" (`api_job`).  Its result is printed
as a line "JOB {json}".
"""

import hashlib
import json
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from vampomi_tpu_torch import api, convert, sharding  # noqa: E402
from vampomi_tpu_torch.config import RunConfig  # noqa: E402
from vampomi_tpu_torch.dataset import load_dataset  # noqa: E402
from vampomi_tpu_torch.engine import checkpoint  # noqa: E402
from vampomi_tpu_torch.engine import probit as probit_engine  # noqa: E402
from vampomi_tpu_torch.engine.linear import infere_linear  # noqa: E402
from vampomi_tpu_torch.io.phen import read_phen  # noqa: E402
from vampomi_tpu_torch.modes import association, predict, test_mode  # noqa: E402
from vampomi_tpu_torch.ops.eigen import build_eigen_cached  # noqa: E402
from vampomi_tpu_torch.ops.spectral import build_spectral  # noqa: E402

PRIOR = dict(h2=0.8, probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2])
PROBIT = dict(probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], rho=0.3, gam1=1e-2)
WROTE: list[str] = []  # every file this rank wrote through atomic_savez


def _recording_savez(save):
    def wrapped(path, **payload):
        WROTE.append(path)
        return save(path, **payload)
    return wrapped


checkpoint.atomic_savez = _recording_savez(checkpoint.atomic_savez)


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def run_job(job: dict, shard) -> dict:
    """One run.  Keys: name, out_dir, meth, phen, n, mt, dtype, solver,
    iterations; optional model ("linear" or "bin_class"), ts (true signal
    file), cache, checkpoint, resume, design (an .npz of a JAX design's
    arrays, read through convert.design_from_arrays instead of `meth`), lam
    (rebuild the factor through the cache after the run and report its lam's
    sum), cov (a covariate file of 2 columns), p1 (an .npy of the probit
    engine's initial p1, in place of its own draw)."""
    n, mt = job["n"], job["mt"]
    model = job.get("model", "linear")
    dtype = RunConfig(compute_dtype=job["dtype"]).resolved_compute_dtype()
    qscale = covs = None
    c = 2 if job.get("cov") else 0
    if job.get("design"):
        with np.load(job["design"]) as z:
            dm = convert.design_from_arrays(dict(z), "cpu", shard=shard)
        y = read_phen(job["phen"], n, standardize=model == "linear").y
    else:
        ds = load_dataset(job["meth"], job["phen"], n, mt, model, dtype, "cpu",
                          cov_file=job.get("cov", ""), c=c, shard=shard)
        dm, y, qscale, covs = ds.dm, ds.phen.y, ds.qscale, ds.covariates
    cfg = RunConfig(out_dir=job["out_dir"], out_name=job["name"], iterations=job["iterations"],
                    stop_criteria_thr=0.0, seed=7, trace=0, device="cpu", model=model, C=c,
                    lmmse_solver=job["solver"], compute_dtype=job["dtype"],
                    eigen_cache=job.get("cache", ""), checkpoint_file=job.get("checkpoint", ""),
                    resume_file=job.get("resume", ""),
                    **(PRIOR if model == "linear" else PROBIT))
    ts = np.fromfile(job["ts"]) if job.get("ts") else None
    WROTE.clear()
    if model == "linear":
        res = infere_linear(dm, y, cfg, true_signal=ts)
    else:
        draw = probit_engine._draw_p1
        if job.get("p1"):
            p1 = np.load(job["p1"])
            probit_engine._draw_p1 = lambda gen, n_, wd, dev: torch.as_tensor(p1).to(dev, wd)
        try:
            res = probit_engine.infere_bin_class(dm, y, cfg, true_signal=ts, covariates=covs)
        finally:
            probit_engine._draw_p1 = draw
    out = dict(name=job["name"], solver=res.solver,
               gamw=float(res.gamw).hex() if model == "linear" else None,
               gam1=float(res.gam1).hex(),
               tau1=float(res.tau1).hex() if model != "linear" else None,
               cov_eff=(None if model == "linear" or res.cov_eff is None
                        else [float(v).hex() for v in res.cov_eff]),
               metrics=[[float(v) for v in row] for row in res.metrics_history],
               lam_sum=(float(res.setup["eigen_lam_sum"]).hex()
                        if "eigen_lam_sum" in (res.setup or {}) else None),
               collectives=res.iter_collectives,
               counts=dict(shard.counts) if shard is not None else None,
               slab=[shard.lo, shard.hi] if shard is not None else [0, mt], m_pad=dm.m_pad,
               loaded="eigen_cache_load" in (res.setup or {}),
               wrote=sorted(os.path.basename(p) for p in WROTE),
               x1=_digest(res.x1_hat_scaled),
               qscale=None if qscale is None else _digest(qscale),
               qscale_len=None if qscale is None else len(qscale))
    if job.get("lam"):
        ef, _ = build_eigen_cached(build_spectral(dm), job["cache"], seed=7, shard=shard)
        out["lam_sum"] = float(ef.lam.sum()).hex()
    return out


def modes_job(job: dict, shard) -> dict:
    """The run modes on given files, as the CLI runs them.  Keys: name,
    out_dir, meth, phen, binphen, n, mt, dtype, est (the linear estimates'
    file of iteration 1: both models' test runs 1..iters, LOO takes iters),
    iters, r1, gam1, pred and ppred (linear and probit predict's estimate
    files: <prefix>.yhat lands beside each).  Returns the collectives each
    mode ran, by mode."""
    n, mt = job["n"], job["mt"]
    dtype = RunConfig(compute_dtype=job["dtype"]).resolved_compute_dtype()
    base = RunConfig(out_dir=job["out_dir"], N=n, Mt=mt, N_test=n, gam1=job["gam1"],
                     r1_file=job["r1"], estimate_file=job["est"],
                     test_iter_range=[1, job["iters"]], device="cpu")
    est_last = job["est"].replace("_it_1.bin", f"_it_{job['iters']}.bin")
    counts = {}

    def counted(mode, fn, *args):
        c0 = dict(shard.counts) if shard is not None else None
        fn(*args)
        if shard is not None:
            counts[mode] = {k: v - c0[k] for k, v in shard.counts.items() if v != c0[k]}

    lin = load_dataset(job["meth"], job["phen"], n, mt, "linear", dtype, "cpu", shard=shard)
    for method in ("se", "loo", "loo_std"):
        cfg = replace(base, out_name=f"{job['name']}_assoc", pval_method=method,
                      estimate_file=est_last)
        counted(method, association.run_association_test, lin, cfg)
    counted("test", test_mode.run_test_linear, lin, replace(base, out_name=f"{job['name']}_lin"))
    counted("predict", predict.run_predict, lin, replace(base, estimate_file=job["pred"]))
    pb = load_dataset(job["meth"], job["binphen"], n, mt, "bin_class", dtype, "cpu", shard=shard)
    counted("test_probit", test_mode.run_test_probit, pb,
            replace(base, out_name=f"{job['name']}_pb"))
    counted("predict_probit", predict.run_predict, pb, replace(base, estimate_file=job["ppred"]))
    return dict(name=job["name"], counts=counts)


def api_job(job: dict, shard) -> dict:
    """api.fit_probit, predict_probit (probabilities) and association_pvals
    with shard="auto" (the group's slabs, or one process without one) on
    the (Mt, N) f64 matrix of `meth` and the 0/1 labels of `phen`; without
    a group also with shard=None, whose bits must be the same."""
    n, mt = job["n"], job["mt"]
    X = np.fromfile(job["meth"]).reshape(mt, n)
    y = read_phen(job["phen"], n, standardize=False).y
    kw = dict(marker_major=True, device="cpu", quiet=True, iterations=3, lmmse_solver="eigen",
              stop_criteria_thr=0.0, seed=7, **PROBIT)

    def run(sh):
        fit = api.fit_probit(X, y, shard=sh, **kw)
        proba = api.predict_probit(fit, X, marker_major=True, device="cpu", return_proba=True,
                                   shard=sh)
        pv = api.association_pvals(fit, n, shard=sh)
        return dict(x1=fit.x1_hat_scaled.tolist(), proba=proba.tolist(), pvals=pv.tolist(),
                    digest=_digest(np.concatenate([fit.x1_hat_scaled, proba, pv])))

    out = dict(name=job["name"], auto=run("auto"))
    if shard is None:
        out["none"] = run(None)
    return out


def collectives_job(job: dict, shard) -> dict:
    """The helpers' values on this rank: each rank's slab of `values` (hex
    floats, -0.0 among them) gathered, the rank numbers summed by
    all_reduce_many with a second vector, rank 0's numbers broadcast, and a
    barrier; with the counts."""
    vals = np.array([float.fromhex(v) for v in job["values"]])
    got = sharding.gather_m(torch.as_tensor(sharding.local_rows(vals, shard)), shard)
    r = torch.tensor([float(shard.rank)], dtype=torch.float64)
    a, b = sharding.all_reduce_many([r, 2 * r], shard)
    sharding.barrier(shard)
    return dict(gathered=[float(v).hex() for v in got.tolist()], sums=[float(a), float(b)],
                from0=sharding.broadcast_from0([shard.rank + 0.5, shard.rank == 0], shard),
                counts=dict(shard.counts))


def main() -> int:
    rank, world, store, spec = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    with open(spec) as f:
        jobs = json.load(f)
    if world > 0:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
    try:
        for job in jobs:
            shard = sharding.shard_for(job["mt"], torch.device("cpu")) if world > 0 else None
            run = {"collectives": collectives_job, "modes": modes_job,
                   "api": api_job}.get(job.get("kind"), run_job)
            print("JOB " + json.dumps(run(job, shard)), flush=True)
    finally:
        if world > 0:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
