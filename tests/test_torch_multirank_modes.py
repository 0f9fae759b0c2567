"""The port's probit engine, run modes and array API over several gloo ranks
on the CPU, against the JAX package on its 8-device mesh and the port's one
process.

Three launches (tests/torch_ranks.py, tests/rank_worker.py): two f64 ranks,
two int8 ranks at the ragged Mt = 161, and one process without a group; the
JAX package runs in this process on the conftest's mesh.  Data: data_sim
N = 120 x M = 160 and 161 at seed 4 (tests/test_multihost.py's fixture),
0/1 labels 1[y > 0] of its phenotype, two covariates and estimate and r1
files made from a numpy seed.

Tolerances: f64 probit across packages is tests/test_torch_probit.py's bar
(rtol 1e-6, atol 1e-9 of the largest entry: two eigh implementations);
across rank counts f64 differs only by the order of the sums over markers
(1e-10), and a mode's outputs by that order too (1e-8 against JAX, whose
mesh pads the markers); int8 works in f32, and there the JAX package's bar
across process counts holds (rtol 1e-4, atol 2e-6 of a dump; CG 1e-3;
labels within 3 samples).  SE p-values are a function of each marker's r1
alone: the same bytes for every rank count.  The ranks of one run hold the
same bits.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_probit import _jax_draws
from tests.torch_ranks import launch
from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.dataset import load_dataset as jload
from vampomi_tpu.engine.probit import infere_bin_class as jprobit
from vampomi_tpu.modes import association as jassoc
from vampomi_tpu.modes.predict import run_predict as jpredict
from vampomi_tpu.modes.test_mode import run_test_linear as jtest_linear
from vampomi_tpu.modes.test_mode import run_test_probit as jtest_probit
from vampomi_tpu.sharding import make_mesh
from vampomi_tpu_torch.sim.data_sim import main as sim_main

N = 120
ITERS = 3
EST_ITERS = 4  # estimate files w_it_1..4 for the modes
PROBIT = dict(probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], rho=0.3, gam1=1e-2)
GAM1 = 4.7
F64, JAX_MODES, JAX_PROBIT = 1e-10, 1e-8, 1e-6
I8_RTOL, I8_ATOL, CG_RTOL, LABELS = 1e-4, 2e-6, 1e-3, 3
MODE_DIRS = ("m2", "m1", "jx", "q2", "q1")


def _dump(d, name, k, kind="it"):
    return np.fromfile(os.path.join(d, f"{name}_{kind}_{k}.bin"))


def _close(got, want, rtol, atol=None):
    atol = rtol * np.abs(want).max() if atol is None else atol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _csv(path):
    """Rows of a positional CSV, with or without a header."""
    text = open(path, "rb").read().replace(b"\0", b"").decode()
    return np.array([[float(v) for v in line.split(",")] for line in text.splitlines()
                     if line.strip() and not line.startswith("iteration")])


def _yhat(path):
    with open(path) as f:
        return np.array([float(v) for v in f.read().split()])


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("multirank_modes"))
    rng = np.random.default_rng(17)
    for mt in (160, 161):
        sim_main(["--out-dir", d, "--out-name", f"ex{mt}", "-N", str(N), "-M", str(mt),
                  "--seed", "4"])
        rows = [line.split() for line in open(f"{d}/ex{mt}.phen").read().splitlines()]
        with open(f"{d}/ex{mt}_01.phen", "w") as f:
            f.writelines(f"{a} {b} {int(float(v) > 0)}\n" for a, b, v in rows)
        beta = np.fromfile(f"{d}/ex{mt}_ts.bin")
        for k in range(1, EST_ITERS + 1):
            (beta * k / EST_ITERS + rng.normal(0.0, 1e-3, mt)).tofile(f"{d}/w{mt}_it_{k}.bin")
        (beta * 2.0 + rng.normal(0.0, 0.05, mt)).tofile(f"{d}/w{mt}_r1_it_{EST_ITERS}.bin")
        for sub in MODE_DIRS:  # predict writes <prefix>.yhat beside its estimate
            os.makedirs(f"{d}/{sub}", exist_ok=True)
            for pre in ("y", "yp"):
                shutil.copyfile(f"{d}/w{mt}_it_{EST_ITERS}.bin",
                                f"{d}/{sub}/{pre}{mt}_it_{EST_ITERS}.bin")
    z = np.random.default_rng(1).normal(size=(N, 2))
    with open(f"{d}/ex.cov", "w") as f:
        f.write("ID FID c1 c2\n")
        f.writelines(f"{i} {i} {a!r} {b!r}\n" for i, (a, b) in enumerate(z.tolist()))
    np.save(f"{d}/p1.npy", _jax_draws(7, N, 160, ITERS, jnp.float64)[0])
    return d


def _probit(work, name, mt=160, solver="eigen", iterations=ITERS, dtype="float64", out="",
            **kw):
    out_dir = os.path.join(work, out) if out else work
    os.makedirs(out_dir, exist_ok=True)
    return dict(name=name, out_dir=out_dir, model="bin_class", meth=f"{work}/ex{mt}.bin",
                phen=f"{work}/ex{mt}_01.phen", ts=f"{work}/ex{mt}_ts.bin", n=N, mt=mt,
                dtype=dtype, solver=solver, iterations=iterations, **kw)


def _modes(work, sub, mt=160, dtype="float64"):
    d = os.path.join(work, sub)
    return dict(kind="modes", name=sub, out_dir=d, meth=f"{work}/ex{mt}.bin",
                phen=f"{work}/ex{mt}.phen", binphen=f"{work}/ex{mt}_01.phen", n=N, mt=mt,
                dtype=dtype, est=f"{work}/w{mt}_it_1.bin", iters=EST_ITERS,
                r1=f"{work}/w{mt}_r1_it_{EST_ITERS}.bin", gam1=GAM1,
                pred=f"{d}/y{mt}_it_{EST_ITERS}.bin", ppred=f"{d}/yp{mt}_it_{EST_ITERS}.bin")


def _api(work, mt=160):
    return dict(kind="api", name="api", meth=f"{work}/ex{mt}.bin",
                phen=f"{work}/ex{mt}_01.phen", n=N, mt=mt)


@pytest.fixture(scope="module")
def jax_ref(work):
    """The JAX package on its 8-device mesh, f64: probit eigen and spectral
    3 iterations at Mt = 160; at Mt = 161 (padded to 168) eigen 5 iterations
    straight and 3 with a checkpoint, and its design's arrays; the run modes
    at Mt = 160 in the directory jx."""
    mesh = make_mesh()
    out = {}
    for mt, solver, its, ck in ((160, "eigen", ITERS, ""), (160, "spectral", ITERS, ""),
                                (161, "eigen", 5, ""), (161, "eigen", ITERS, "jp161.npz")):
        ds = jload(f"{work}/ex{mt}.bin", f"{work}/ex{mt}_01.phen", N, mt, "bin_class", mesh,
                   jnp.float64)
        name = f"jp{mt}_{solver}" + ("_ck" if ck else "")
        cfg = JConfig(out_dir=work, out_name=name, model="bin_class", iterations=its,
                      stop_criteria_thr=0.0, seed=7, trace=0, lmmse_solver=solver,
                      checkpoint_file=os.path.join(work, ck) if ck else "", **PROBIT)
        out[name] = jprobit(ds.dm, ds.phen.y, cfg, true_signal=np.fromfile(f"{work}/ex{mt}_ts.bin"))
        if mt == 161 and not ck:
            assert ds.dm.m_pad == 168
            np.savez(os.path.join(work, "jp161_design.npz"),
                     **{k: np.asarray(getattr(ds.dm, k))
                        for k in ("X", "mave", "msig", "mmask", "inv_sqrt_n", "n", "mt")})
    job = _modes(work, "jx")
    lin = jload(job["meth"], job["phen"], N, 160, "linear", mesh, jnp.float64)
    pb = jload(job["meth"], job["binphen"], N, 160, "bin_class", mesh, jnp.float64)
    base = JConfig(out_dir=job["out_dir"], meth_file="x", N=N, Mt=160, N_test=N, gam1=GAM1,
                   r1_file=job["r1"], estimate_file=job["est"], test_iter_range=[1, EST_ITERS])
    last = job["est"].replace("_it_1.bin", f"_it_{EST_ITERS}.bin")
    for method in ("se", "loo", "loo_std"):
        jassoc.run_association_test(lin, dataclasses.replace(
            base, out_name="jx_assoc", pval_method=method, estimate_file=last))
    jtest_linear(lin, dataclasses.replace(base, out_name="jx_lin"))
    out["z"] = np.asarray(jpredict(lin, dataclasses.replace(base, estimate_file=job["pred"])))
    jtest_probit(pb, dataclasses.replace(base, out_name="jx_pb"))
    out["zp"] = np.asarray(jpredict(pb, dataclasses.replace(base, estimate_file=job["ppred"])))
    return out


@pytest.fixture(scope="module")
def f64_ranks(work, jax_ref):
    """2 f64 ranks: probit eigen and spectral on JAX's p1, CG, eigen with
    C = 2 covariates; the JAX mesh design and checkpoint at Mt = 161 resumed
    under eigen to 5; the run modes in m2; the array API."""
    p1 = f"{work}/p1.npy"
    jobs = [_probit(work, "pe", p1=p1), _probit(work, "ps", solver="spectral", p1=p1),
            _probit(work, "pc", solver="cg"), _probit(work, "pv", cov=f"{work}/ex.cov"),
            _probit(work, "jr", mt=161, iterations=5, out="jr",
                    design=f"{work}/jp161_design.npz", resume=f"{work}/jp161.npz"),
            _modes(work, "m2"), _api(work)]
    return launch(work, 2, jobs)


@pytest.fixture(scope="module")
def int8_ranks(work):
    """2 int8 ranks at the ragged Mt = 161: probit eigen and CG, the run
    modes in q2."""
    return launch(work, 2, [_probit(work, "qe", mt=161, dtype="int8"),
                            _probit(work, "qc", mt=161, dtype="int8", solver="cg",
                                    iterations=2),
                            _modes(work, "q2", mt=161, dtype="int8")])


@pytest.fixture(scope="module")
def one(work):
    """One process without a group: the runs the ranks are held to."""
    res = launch(work, 0, [
        _probit(work, "pc1", solver="cg"), _probit(work, "pv1", cov=f"{work}/ex.cov"),
        _probit(work, "qe1", mt=161, dtype="int8"),
        _probit(work, "qc1", mt=161, dtype="int8", solver="cg", iterations=2),
        _modes(work, "m1"), _modes(work, "q1", mt=161, dtype="int8"), _api(work)])[0]
    return {r["name"]: r for r in res}


def _named(ranks):
    """[rank] -> {job name: result}."""
    return [{r["name"]: r for r in rank} for rank in ranks]


@pytest.mark.parametrize("solver", ["eigen", "spectral"])
def test_two_rank_probit_matches_the_jax_mesh(work, jax_ref, f64_ranks, solver):
    tag = {"eigen": "pe", "spectral": "ps"}[solver]
    res = [r[tag] for r in _named(f64_ranks)]
    assert [r["slab"] for r in res] == [[0, 80], [80, 160]]
    assert all(r["solver"] == solver for r in res)
    want = jax_ref[f"jp160_{solver}"]
    got = float.fromhex(res[0]["gam1"]), float.fromhex(res[0]["tau1"])
    np.testing.assert_allclose(got, [want.gam1, want.tau1], rtol=JAX_PROBIT)
    np.testing.assert_allclose(res[0]["metrics"], np.asarray(want.metrics_history),
                               rtol=JAX_PROBIT, atol=1e-12)
    for k in range(1, ITERS + 1):
        for kind in ("it", "r1_it"):
            got, ref = _dump(work, tag, k, kind), _dump(work, f"jp160_{solver}", k, kind)
            assert got.shape == (160,)
            _close(got, ref, JAX_PROBIT, 1e-9 * np.abs(ref).max())


def test_probit_ranks_hold_the_same_bits_and_run_exact_collectives(f64_ranks, int8_ranks):
    """gam1, tau1, the eigenvalues' sum and the estimate bitwise equal on
    every rank.  An exact iteration: alpha1, the ax_batch pass and the late
    sums (3), and the EM update from iteration 2 (4); setup: the Gram (1),
    the factor's three broadcasts, the covariates' two, the int8 scales'
    gather, the result's two gathers.  A CG iteration: 7, the EM update and
    3 a CG step."""
    for ranks in (f64_ranks, int8_ranks):
        for jobs in zip(*ranks):
            if "gam1" in jobs[0]:
                assert len({(j["gam1"], j["tau1"], j["lam_sum"], j["x1"]) for j in jobs}) == 1
    f64, i8 = _named(f64_ranks), _named(int8_ranks)
    for r in f64:
        for tag, bcast in (("pe", 3), ("ps", 0), ("pv", 5)):
            assert r[tag]["collectives"] == [3, 4, 4], tag
            assert r[tag]["counts"] == {"all_reduce": 1 + 11, "all_gather": 2,
                                        "broadcast": bcast}, tag
        assert r["jr"]["collectives"] == [4, 4]
        cg = r["pc"]["collectives"]
        assert all((c - 7 - (i > 0)) % 3 == 0 and c > 7 for i, c in enumerate(cg))
        assert r["pc"]["counts"]["broadcast"] == 0
    for r in i8:
        assert r["qe"]["collectives"] == [3, 4, 4]
        assert r["qe"]["counts"] == {"all_reduce": 12, "all_gather": 3, "broadcast": 3}
        assert [r["qe"]["slab"], r["qe"]["m_pad"]] in ([[0, 81], 81], [[81, 161], 80])


def test_two_rank_probit_cg_and_covariates_match_one_process(work, f64_ranks, one):
    """CG draws each probe at the global Mt and slices it, so the ranks take
    one process's steps; the covariates are fitted on rank 0 and broadcast."""
    r0 = _named(f64_ranks)[0]
    for tag in ("pc", "pv"):
        want = one[f"{tag}1"]
        assert abs(float.fromhex(r0[tag]["gam1"]) / float.fromhex(want["gam1"]) - 1) < F64
        _close(np.asarray(r0[tag]["metrics"]), np.asarray(want["metrics"]), F64)
        for k in range(1, ITERS + 1):
            for kind in ("it", "r1_it"):
                _close(_dump(work, tag, k, kind), _dump(work, f"{tag}1", k, kind), F64)
    assert r0["pv"]["cov_eff"] == one["pv1"]["cov_eff"]
    assert r0["pc"]["cov_eff"] is None


def test_jax_mesh_probit_checkpoint_resumes_on_two_ranks(work, jax_ref, f64_ranks):
    """The JAX probit design padded to 168 on its mesh, cut into the ranks'
    slabs of the 161 real markers, resumes the JAX checkpoint of iteration
    3 (x1, r1, r2 cut to Mt; p1, p2 and the covariate offsets as they are)
    and lands on the JAX straight run's iterations 4 and 5."""
    res = [r["jr"] for r in _named(f64_ranks)]
    assert [r["slab"] for r in res] == [[0, 81], [81, 161]]
    assert [r["m_pad"] for r in res] == [81, 80]
    want = jax_ref["jp161_eigen"]
    np.testing.assert_allclose([float.fromhex(res[0]["gam1"]), float.fromhex(res[0]["tau1"])],
                               [want.gam1, want.tau1], rtol=JAX_PROBIT)
    for k in (4, 5):
        for kind in ("it", "r1_it"):
            got, ref = _dump(os.path.join(work, "jr"), "jr", k, kind), _dump(
                work, "jp161_eigen", k, kind)
            assert got.shape == (161,)
            _close(got, ref, JAX_PROBIT, 1e-9 * np.abs(ref).max())


def test_int8_probit_ranks_match_one_process(work, int8_ranks, one):
    r0 = _named(int8_ranks)[0]
    for tag, rtol in (("qe", I8_RTOL), ("qc", CG_RTOL)):
        want, got = np.asarray(one[f"{tag}1"]["metrics"]), np.asarray(r0[tag]["metrics"])
        counts = [0, 1, 2, 3, 6, 7, 8, 9]
        assert np.abs(got[:, counts] - want[:, counts]).max() <= LABELS
        rest = [j for j in range(12) if j not in counts + [4, 10]]
        _close(got[:, rest], want[:, rest], rtol, 1e-5)
        for k in range(1, len(want) + 1):
            for kind in ("it", "r1_it"):
                got_d, want_d = _dump(work, tag, k, kind), _dump(work, f"{tag}1", k, kind)
                assert got_d.shape == (161,)
                _close(got_d, want_d, rtol, I8_ATOL if tag == "qe" else None)


MODES = ("se", "loo", "loo_std", "test", "predict", "test_probit", "predict_probit")


def _mode_out(work, sub, mode, mt):
    d = os.path.join(work, sub)
    if mode in ("se", "loo", "loo_std"):
        return np.fromfile(os.path.join(d, f"{sub}_assoc_it_{EST_ITERS}_pval_{mode}.bin"))
    if mode in ("test", "test_probit"):
        return _csv(os.path.join(d, f"{sub}_{'lin' if mode == 'test' else 'pb'}_test.csv"))
    return _yhat(os.path.join(d, f"{'y' if mode == 'predict' else 'yp'}{mt}_.yhat"))


@pytest.mark.parametrize("mode", MODES)
def test_f64_modes_on_two_ranks_match_the_jax_mesh_and_one_process(work, jax_ref, f64_ranks,
                                                                  one, mode):
    """Every file full length.  SE: byte-identical to one process and to
    JAX; the rest within 1e-8 of JAX and 1e-10 of one process (the .yhat
    text holds 6 digits: the same text, or numbers within its rounding)."""
    got, alone, jx = (_mode_out(work, s, mode, 160) for s in ("m2", "m1", "jx"))
    assert got.shape == alone.shape == jx.shape
    assert len(got) == {"test": EST_ITERS, "test_probit": EST_ITERS, "predict": N,
                        "predict_probit": N}.get(mode, 160)
    if mode == "se":
        assert got.tobytes() == alone.tobytes() == jx.tobytes()
    elif mode.startswith("predict"):
        np.testing.assert_allclose(got, alone, rtol=1e-5)
        np.testing.assert_allclose(got, jx, rtol=1e-5)
    elif mode == "test_probit":
        np.testing.assert_array_equal(got[:, 1:5], alone[:, 1:5])  # the confusion counts
        np.testing.assert_array_equal(got[:, 1:5], jx[:, 1:5])
    else:
        np.testing.assert_allclose(got, alone, rtol=F64, atol=0)
        np.testing.assert_allclose(got, jx, rtol=JAX_MODES, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_int8_modes_on_two_ranks_match_one_process(work, int8_ranks, one, mode):
    """The phase-10 bars: SE byte-identical (elementwise in r1), LOO and
    loo_std -log10 p, the test CSV and .yhat within rtol 1e-4 (atol 1e-4 of
    the largest entry: a p-value near 1 carries only the vector's absolute
    accuracy in -log10 p), probit test counts within 3."""
    got, alone = (_mode_out(work, s, mode, 161) for s in ("q2", "q1"))
    assert got.shape == alone.shape
    if mode == "se":
        assert got.tobytes() == alone.tobytes()
    elif mode.startswith("loo"):
        _close(-np.log10(got), -np.log10(alone), I8_RTOL)
    elif mode == "test_probit":
        assert np.abs(got[:, 1:5] - alone[:, 1:5]).max() <= LABELS
    else:
        _close(got, alone, I8_RTOL)


def test_mode_collectives_are_exact(f64_ranks, int8_ranks):
    """SE none; LOO, test (4 estimates: one batched pass) and predict one
    all_reduce each, that of their one pass over X."""
    one_pass = {"all_reduce": 1}
    want = {"se": {}, **{m: one_pass for m in MODES[1:]}}
    for ranks in (_named(f64_ranks), _named(int8_ranks)):
        for r in ranks:
            counts = next(v for k, v in r.items() if k in ("m2", "q2"))["counts"]
            assert counts == want


def test_api_shard_auto_over_ranks_matches_one_process(f64_ranks, one):
    """fit_probit, predict_probit and association_pvals with shard="auto"
    on two ranks: the same gathered results on both, within 1e-10 of one
    process."""
    res = [r["api"]["auto"] for r in _named(f64_ranks)]
    assert res[0]["digest"] == res[1]["digest"]
    want = one["api"]["auto"]
    for key in ("x1", "proba", "pvals"):
        _close(np.asarray(res[0][key]), np.asarray(want[key]), F64)
    assert len(res[0]["x1"]) == len(res[0]["pvals"]) == 160 and len(res[0]["proba"]) == N
    pv = np.asarray(res[0]["pvals"])
    assert np.all((pv >= 0) & (pv <= 1))


def test_api_without_a_group_is_one_process(one):
    """shard="auto" without a process group is shard=None, bit for bit."""
    assert one["api"]["auto"]["digest"] == one["api"]["none"]["digest"]
