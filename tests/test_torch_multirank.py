"""The port's sharded linear engine over several gloo ranks on the CPU,
against the JAX package's sharded engine and the port's one-process run.

Each launch starts one process a rank (tests/torch_ranks.py,
tests/rank_worker.py); the JAX package runs in this process on the
conftest's 8-device CPU mesh.  Data: data_sim N = 120 x M = 160 at seed 4
(tests/test_multihost.py's fixture) and the same at Mt = 161, which pads to
168 on the mesh and splits raggedly over 4 ranks.

Tolerances: f64 across rank counts and packages differs only by the order
of the sums over markers, 1e-10 relative; int8 works in f32, and there the
JAX package's own bar across process counts holds, rtol 1e-4 and atol 2e-6
(tests/test_multihost.py:186-190).  The ranks of one run hold the same bits.
The CLI runs both models over ranks (tests/test_torch_multirank_modes.py
holds probit and the run modes to JAX and to one process).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_ranks import REPO, TIMEOUT, env, launch
from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.dataset import load_dataset as jload
from vampomi_tpu.engine.linear import infere_linear as jinfere
from vampomi_tpu.sharding import make_mesh
from vampomi_tpu_torch.sim.data_sim import main as sim_main

N = 120
PRIOR = dict(h2=0.8, probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2])
F64 = 1e-10
I8_RTOL, I8_ATOL = 1e-4, 2e-6


def _dump(d, name, k, kind="it"):
    return np.fromfile(os.path.join(d, f"{name}_{kind}_{k}.bin"))


def _close(got, want, rtol=F64, atol=None):
    atol = rtol * np.abs(want).max() if atol is None else atol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _same_across_ranks(results):
    """Every rank's results, job by job: gamw and x1 bitwise equal."""
    for jobs in zip(*results):
        assert len({(j["gamw"], j["x1"]) for j in jobs}) == 1, jobs


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("multirank"))
    for mt in (160, 161):
        sim_main(["--out-dir", d, "--out-name", f"ex{mt}", "-N", str(N), "-M", str(mt),
                  "--seed", "4"])
    return d


def _job(work, name, mt=160, solver="eigen", iterations=3, dtype="float64", out="", **kw):
    out_dir = os.path.join(work, out) if out else work
    os.makedirs(out_dir, exist_ok=True)
    return dict(name=name, out_dir=out_dir, meth=f"{work}/ex{mt}.bin", phen=f"{work}/ex{mt}.phen",
                ts=f"{work}/ex{mt}_ts.bin", n=N, mt=mt, dtype=dtype, solver=solver,
                iterations=iterations, **kw)


@pytest.fixture(scope="module")
def jax_ref(work):
    """The JAX package on its 8-device mesh, f64: eigen and spectral 3
    iterations at Mt = 160; at Mt = 161 (padded to 168) eigen 5 iterations
    straight and 3 with a checkpoint, and its design's arrays."""
    mesh = make_mesh()
    out = {}
    for mt, solver, its, ck in ((160, "eigen", 3, ""), (160, "spectral", 3, ""),
                                (161, "eigen", 5, ""), (161, "eigen", 3, "jx161.npz")):
        ds = jload(f"{work}/ex{mt}.bin", f"{work}/ex{mt}.phen", N, mt, "linear", mesh,
                   jnp.float64)
        name = f"jx{mt}_{solver}" + ("_ck" if ck else "")
        cfg = JConfig(out_dir=work, out_name=name, iterations=its, stop_criteria_thr=0.0,
                      seed=7, trace=0, lmmse_solver=solver,
                      checkpoint_file=os.path.join(work, ck) if ck else "", **PRIOR)
        out[name] = jinfere(ds.dm, ds.phen.y, cfg, true_signal=np.fromfile(f"{work}/ex{mt}_ts.bin"))
        if mt == 161 and not ck:
            dm = ds.dm
            assert dm.m_pad == 168
            np.savez(os.path.join(work, "jx161_design.npz"),
                     **{k: np.asarray(getattr(dm, k))
                        for k in ("X", "mave", "msig", "mmask", "inv_sqrt_n", "n", "mt")})
    return out


@pytest.fixture(scope="module")
def two_ranks(work, jax_ref):
    """2 ranks, f64: eigen, spectral and CG 3 iterations; CG 4 iterations
    with a checkpoint, 6 straight, and the checkpoint resumed to 6 in the
    checkpoint run's directory; the JAX design and checkpoint at Mt = 161
    resumed under eigen to 5.  Then the same CG run and the 2-rank
    checkpoint's resume on one process."""
    ck = os.path.join(work, "ck2.npz")
    jobs = [_job(work, "e"), _job(work, "s", solver="spectral"), _job(work, "c", solver="cg"),
            _job(work, "ck", solver="cg", iterations=4, out="ck_run", checkpoint=ck),
            _job(work, "ck", solver="cg", iterations=6, out="straight"),
            _job(work, "ck", solver="cg", iterations=6, out="ck_run", resume=ck),
            _job(work, "jr", mt=161, iterations=5, out="jr", design=f"{work}/jx161_design.npz",
                 resume=f"{work}/jx161.npz")]
    ranks = launch(work, 2, jobs)
    one = launch(work, 0, [_job(work, "c1", solver="cg"),
                           _job(work, "ck", solver="cg", iterations=6, out="ck_one", resume=ck)])
    return ranks, one[0]


@pytest.fixture(scope="module")
def four_ranks(work):
    """4 ranks at the ragged Mt = 161, int8 eigen with one shared eigen
    cache: the first run writes it, the second loads it; one process runs
    the first without a cache."""
    cache = os.path.join(work, "c4.npz")
    ranks = launch(work, 4, [_job(work, "q1", mt=161, dtype="int8", cache=cache),
                             _job(work, "q2", mt=161, dtype="int8", cache=cache, lam=True)])
    one = launch(work, 0, [_job(work, "q0", mt=161, dtype="int8")])
    return ranks, one[0][0]


@pytest.mark.parametrize("solver", ["eigen", "spectral"])
def test_two_ranks_f64_match_the_jax_mesh(work, jax_ref, two_ranks, solver):
    ranks, _ = two_ranks
    tag = {"eigen": "e", "spectral": "s"}[solver]
    res = [r[0 if solver == "eigen" else 1] for r in ranks]
    assert [r["slab"] for r in res] == [[0, 80], [80, 160]]
    assert all(r["solver"] == solver for r in res)
    want = jax_ref[f"jx160_{solver}"]
    assert abs(float.fromhex(res[0]["gamw"]) - want.gamw) / want.gamw < F64
    for kind in ("it", "r1_it"):
        got, ref = _dump(work, tag, 3, kind), _dump(work, f"jx160_{solver}", 3, kind)
        assert got.shape == (160,)
        _close(got, ref)


def test_ranks_hold_the_same_bits(two_ranks, four_ranks):
    _same_across_ranks(two_ranks[0])
    _same_across_ranks(four_ranks[0])


def test_two_ranks_cg_matches_one_process(work, two_ranks):
    """The probe of every iteration is the one-process draw, sliced, so CG
    takes the same steps."""
    ranks, one = two_ranks
    assert abs(float.fromhex(ranks[0][2]["gamw"]) / float.fromhex(one[0]["gamw"]) - 1) < F64
    for k in (1, 2, 3):
        for kind in ("it", "r1_it"):
            _close(_dump(work, "c", k, kind), _dump(work, "c1", k, kind))


def test_collectives_of_an_iteration_are_exact(two_ranks):
    """An eigen iteration: alpha1, the two-column ax_batch pass and the error
    measures (3), and the EM update from iteration 2 on (learn_prior_delay
    1): [3, 4, 4]; the setup's Gram (1) and the factor's broadcasts (verdict,
    U, lam: 3), and the result's two gathers.  A CG iteration: 8 and 3 a CG
    step."""
    ranks, _ = two_ranks
    for r in ranks:
        e, cg = r[0], r[2]
        assert e["collectives"] == [3, 4, 4]
        assert e["counts"] == {"all_reduce": 1 + 11, "all_gather": 2, "broadcast": 3}
        assert all((c - 8 - (i > 0)) % 3 == 0 and c > 8 for i, c in enumerate(cg["collectives"]))
        assert cg["counts"]["broadcast"] == 0


def test_checkpoint_resumes_on_two_ranks_byte_identical(work, two_ranks):
    ranks, _ = two_ranks
    assert all(r[3]["wrote"] == (["ck2.npz"] * 4 if r[3]["slab"][0] == 0 else [])
               for r in ranks)
    for f in ("ck_metrics.csv", "ck_params.csv", "ck_prior.csv"):
        with open(os.path.join(work, "ck_run", f), "rb") as a, \
                open(os.path.join(work, "straight", f), "rb") as b:
            assert a.read() == b.read(), f
    for k in range(1, 7):
        for kind in ("it", "r1_it"):
            assert (_dump(os.path.join(work, "ck_run"), "ck", k, kind).tobytes()
                    == _dump(os.path.join(work, "straight"), "ck", k, kind).tobytes())


def test_two_rank_checkpoint_resumes_on_one_process(work, two_ranks):
    for k in (5, 6):
        for kind in ("it", "r1_it"):
            _close(_dump(os.path.join(work, "ck_one"), "ck", k, kind),
                   _dump(os.path.join(work, "straight"), "ck", k, kind))


def test_jax_mesh_design_and_checkpoint_resume_on_ranks(work, jax_ref, two_ranks):
    """The JAX design padded to 168 on its mesh, cut into the ranks' slabs
    of the 161 real markers, resumes the JAX checkpoint of iteration 3 and
    lands on the JAX straight run's iterations 4 and 5."""
    ranks, _ = two_ranks
    assert [r[6]["slab"] for r in ranks] == [[0, 81], [81, 161]]
    assert [r[6]["m_pad"] for r in ranks] == [81, 80]
    want = jax_ref["jx161_eigen"]
    assert abs(float.fromhex(ranks[0][6]["gamw"]) - want.gamw) / want.gamw < F64
    for k in (4, 5):
        for kind in ("it", "r1_it"):
            got = _dump(os.path.join(work, "jr"), "jr", k, kind)
            assert got.shape == (161,)
            _close(got, _dump(work, "jx161_eigen", k, kind))


def test_four_ranks_int8_shared_cache(work, four_ranks):
    ranks, one = four_ranks
    assert [r[0]["slab"] for r in ranks] == [[0, 41], [41, 81], [81, 121], [121, 161]]
    # qscale is global and the same on every rank
    assert all(r[0]["qscale_len"] == 161 for r in ranks)
    assert len({r[0]["qscale"] for r in ranks}) == 1
    assert ranks[0][0]["qscale"] == one["qscale"]
    # rank 0 alone writes the cache; every rank then runs on the loaded factor
    assert [r[0]["wrote"] for r in ranks] == [["c4.npz"], [], [], []]
    assert all(not r[0]["loaded"] for r in ranks)
    assert all(r[1]["loaded"] and r[1]["wrote"] == [] for r in ranks)
    assert len({r[1]["lam_sum"] for r in ranks}) == 1
    assert ranks[0][1]["gamw"] == ranks[0][0]["gamw"]
    g = float.fromhex(ranks[0][0]["gamw"])
    assert abs(g / float.fromhex(one["gamw"]) - 1) < I8_RTOL
    for name in ("q1", "q2"):
        for kind in ("it", "r1_it"):
            np.testing.assert_allclose(_dump(work, name, 3, kind), _dump(work, "q0", 3, kind),
                                       rtol=I8_RTOL, atol=I8_ATOL)


def _torchrun(work, out_name, *extra):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "vampomi_tpu_torch.cli", "--device", "cpu", "--meth-file",
           f"{work}/ex160.bin", "--phen-file", f"{work}/ex160.phen", "--N", str(N), "--Mt",
           "160", "--out-dir", work, "--out-name", out_name, "--iterations", "3",
           "--h2", "0.8", "--probs", "0.9,0.07,0.03", "--vars", "0.0,0.001,0.01", *extra]
    return subprocess.run(cmd, cwd=REPO, env=dict(env(), VAMPOMI_DISTRIBUTED="1"),
                          capture_output=True, text=True, timeout=TIMEOUT)


def test_cli_under_torchrun_writes_full_files(work):
    p = _torchrun(work, "cli2", "--lmmse-solver", "eigen", "--compute-dtype", "int8",
                  "--true-signal-file", f"{work}/ex160_ts.bin")
    assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    assert "backend gloo" in p.stdout
    for k in (1, 2, 3):
        for kind in ("it", "r1_it"):
            d = _dump(work, "cli2", k, kind)
            assert d.shape == (160,) and np.all(np.isfinite(d))
    rows = open(os.path.join(work, "cli2_params.csv"), "rb").read().replace(b"\0", b"")
    assert len(rows.decode().strip().splitlines()) == 4  # the header and 3 rows


def test_cli_runs_probit_over_ranks(work):
    """--model bin_class over 2 ranks: 0/1 labels of the fixture's phenotype;
    rank 0 writes the CSVs (8 values a params row), each rank its slab of
    every dump, all full length and finite."""
    rows = [line.split() for line in open(f"{work}/ex160.phen").read().splitlines()]
    with open(f"{work}/ex160_01.phen", "w") as f:
        f.writelines(f"{a} {b} {int(float(v) > 0)}\n" for a, b, v in rows)
    p = _torchrun(work, "pb2", "--model", "bin_class", "--phen-file", f"{work}/ex160_01.phen",
                  "--rho", "0.3", "--gam1", "1e-2", "--lmmse-solver", "eigen")
    assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    for k in (1, 2, 3):
        for kind in ("it", "r1_it"):
            d = _dump(work, "pb2", k, kind)
            assert d.shape == (160,) and np.all(np.isfinite(d))
    text = open(os.path.join(work, "pb2_params.csv"), "rb").read().replace(b"\0", b"").decode()
    rows = [r.split(",") for r in text.strip().splitlines()[1:]]
    assert [len(r) for r in rows] == [9, 9, 9]
