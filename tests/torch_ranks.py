"""Launch the port's rank processes for the multi-rank tests, on the CPU.

`launch(work, world, jobs)` starts `world` processes of `rank_worker.py`
(world 0: one process, no process group), each joining a gloo group through
a file store under `work` (no port to lose), and returns each rank's list of
results, one dict a job.  A job is a dict of `rank_worker.run_job`'s keys.
Every launch has its own timeout; a rank that fails fails the test with its
output's tail.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import uuid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "rank_worker.py")
TIMEOUT = 120


def env() -> dict:
    """The parent's environment without JAX's settings, one thread a rank."""
    out = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return out


def launch(work: str, world: int, jobs: list[dict], timeout: int = TIMEOUT) -> list[list[dict]]:
    """Run `jobs` in order on `world` ranks (0: one process without a group);
    returns [rank][job] result dicts."""
    tag = uuid.uuid4().hex[:8]
    spec = os.path.join(work, f"jobs_{tag}.json")
    with open(spec, "w") as f:
        json.dump(jobs, f)
    store = os.path.join(work, f"store_{tag}")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), store, spec],
                              cwd=REPO, env=env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(max(world, 1))]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [[json.loads(line[4:]) for line in o.splitlines() if line.startswith("JOB ")]
            for o in outs]
