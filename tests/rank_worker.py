"""One rank of a multi-rank test run of the port (tests/torch_ranks.py).

    python tests/rank_worker.py RANK WORLD STORE JOBS.json

WORLD 0 runs the jobs as one process without a process group; otherwise the
rank joins a gloo group of WORLD ranks through the file store STORE and runs
each job on its slab of the markers.  Each job is one `infere_linear` run
(`run_job`) or, with kind "collectives", a check of the sharding helpers
(`collectives_job`); its result is printed as a line "JOB {json}".
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from vampomi_tpu_torch import convert, sharding  # noqa: E402
from vampomi_tpu_torch.config import RunConfig  # noqa: E402
from vampomi_tpu_torch.dataset import load_dataset  # noqa: E402
from vampomi_tpu_torch.engine import checkpoint  # noqa: E402
from vampomi_tpu_torch.engine.linear import infere_linear  # noqa: E402
from vampomi_tpu_torch.io.phen import read_phen  # noqa: E402
from vampomi_tpu_torch.ops.eigen import build_eigen_cached  # noqa: E402
from vampomi_tpu_torch.ops.spectral import build_spectral  # noqa: E402

PRIOR = dict(h2=0.8, probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2])
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
    iterations; optional ts (true signal file), cache, checkpoint, resume,
    design (an .npz of a JAX design's arrays, read through
    convert.design_from_arrays instead of `meth`), lam (rebuild the factor
    through the cache after the run and report its lam's sum)."""
    n, mt = job["n"], job["mt"]
    dtype = RunConfig(compute_dtype=job["dtype"]).resolved_compute_dtype()
    qscale = None
    if job.get("design"):
        with np.load(job["design"]) as z:
            dm = convert.design_from_arrays(dict(z), "cpu", shard=shard)
        y = read_phen(job["phen"], n, standardize=True).y
    else:
        ds = load_dataset(job["meth"], job["phen"], n, mt, "linear", dtype, "cpu", shard=shard)
        dm, y, qscale = ds.dm, ds.phen.y, ds.qscale
    cfg = RunConfig(out_dir=job["out_dir"], out_name=job["name"], iterations=job["iterations"],
                    stop_criteria_thr=0.0, seed=7, trace=0, device="cpu",
                    lmmse_solver=job["solver"], compute_dtype=job["dtype"],
                    eigen_cache=job.get("cache", ""), checkpoint_file=job.get("checkpoint", ""),
                    resume_file=job.get("resume", ""), **PRIOR)
    ts = np.fromfile(job["ts"]) if job.get("ts") else None
    WROTE.clear()
    res = infere_linear(dm, y, cfg, true_signal=ts)
    out = dict(name=job["name"], solver=res.solver, gamw=float(res.gamw).hex(),
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
            run = collectives_job if job.get("kind") == "collectives" else run_job
            print("JOB " + json.dumps(run(job, shard)), flush=True)
    finally:
        if world > 0:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
