"""The port's marker sharding (vampomi_tpu_torch/sharding.py) piece by
piece: the work split against the JAX package's, the backend rule, the
collective helpers over gloo ranks (tests/torch_ranks.py), the slabs of a
design and of an artifact file against one process's, the JAX package's
padded mesh designs and checkpoints cut to the port's slabs, the CLI's
refusals, and the one-process engines and run modes unchanged by all of
it."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_ranks import REPO, env, launch
from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.dataset import load_dataset as jload
from vampomi_tpu.engine.linear import infere_linear as jinfere
from vampomi_tpu.sharding import divide_work as jdivide_work
from vampomi_tpu.sharding import make_mesh
from vampomi_tpu_torch import cli, convert, sharding
from vampomi_tpu_torch.io.bin_io import write_marker_file
from vampomi_tpu_torch.ops.operator import (
    PACKED4_DTYPE, build_design, design_from_codes, design_from_packed,
)
from vampomi_tpu_torch.sim.data_sim import main as sim_main

PRIOR = dict(h2=0.8, probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2])


def _shards(mt, world):
    """Every rank's Shard of mt markers, made without a process group (the
    helpers that do not communicate take them as they are)."""
    return [sharding.Shard(rank=r, world=world, lo=lo, hi=lo + m, mt=mt,
                           device=torch.device("cpu"))
            for r, (m, lo) in enumerate(sharding.divide_work(mt, world))]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7, 8])
def test_divide_work_is_the_jax_package_split(world):
    for mt in (1, 7, 8, 160, 161, 8_002, 1_048_576):
        if mt >= world:
            assert sharding.divide_work(mt, world) == jdivide_work(mt, world)


@pytest.mark.parametrize("kind,local_world,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"), ("cuda", 2, 1, "gloo"),
    ("cuda", 3, 1, "gloo"), ("cuda", 5, 4, "gloo")])
def test_backend_rule(kind, local_world, cards, want):
    assert sharding.choose_backend(kind, local_world, cards) == want


def test_helpers_without_a_shard_are_the_identity():
    x = torch.tensor([1.0, -0.0, 3.0], dtype=torch.float64)
    assert sharding.all_reduce_(x, None) is x
    parts = [x, x[:1]]
    assert sharding.all_reduce_many(parts, None) is parts
    assert sharding.local_rows(x, None) is x
    assert torch.equal(sharding.gather_m(x, None), x)
    assert sharding.broadcast_from0([2, True], None) == [2.0, 1.0]
    assert sharding.shard_for(10, torch.device("cpu")) is None  # no process group here
    assert sharding.is_writer()


@pytest.mark.parametrize("world", [2, 3])
def test_gather_keeps_values_and_helpers_reduce(tmp_path, world):
    """Gathered by values, -0.0 stays -0.0 at a slab's edge and inside it;
    the ragged slabs come back in marker order."""
    vals = [-0.0, 1.5, -0.0, 2.0**-1074, -3.25, 0.0, -0.0]
    job = dict(kind="collectives", mt=len(vals), values=[float(v).hex() for v in vals])
    res = [r[0] for r in launch(str(tmp_path), world, [job])]
    for r in res:
        assert r["gathered"] == [float(v).hex() for v in vals]
        assert r["sums"] == [sum(range(world)), 2 * sum(range(world))]
        assert r["from0"] == [0.5, 1.0]
        assert r["counts"] == {"all_reduce": 2, "all_gather": 1, "broadcast": 1}


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8, PACKED4_DTYPE])
def test_design_slabs_are_the_global_rows(dtype):
    """Standardization and quantization are per marker, so each rank's slab
    of a design is the global design's rows; mt stays global."""
    X = np.random.default_rng(3).normal(size=(23, 10))
    whole = build_design(X, compute_dtype=dtype)
    for sh in _shards(23, 3):
        q = {}
        part = build_design(X[sh.lo:sh.hi], compute_dtype=dtype, shard=sh, quant_out=q)
        assert part.shard is sh and part.mt == 23.0 and part.m_pad == sh.hi - sh.lo
        assert torch.equal(part.X, whole.X[sh.lo:sh.hi])
        for k in ("mave", "msig", "mmask"):
            assert torch.equal(getattr(part, k), getattr(whole, k)[sh.lo:sh.hi]), k
        if dtype != torch.float64:
            dev = (design_from_codes(part.X, shard=sh) if dtype == torch.int8
                   else design_from_packed(part.X, shard=sh))
            assert dev.mt == 23.0 and dev.m_pad == part.m_pad and dev.shard is sh


def test_slab_writes_are_one_process_bytes(tmp_path):
    v = np.random.default_rng(5).normal(size=11)
    v[3] = -0.0
    one = tmp_path / "one.bin"
    write_marker_file(str(one), torch.as_tensor(v), 11, 3.0)
    parts = tmp_path / "parts.bin"
    for sh in reversed(_shards(11, 4)):  # any order: O_CREAT without O_TRUNC, pwrite
        write_marker_file(str(parts), torch.as_tensor(v[sh.lo:sh.hi]), 11, 3.0, sh.lo)
    assert parts.read_bytes() == one.read_bytes()


@pytest.fixture(scope="module")
def padded_jax(tmp_path_factory):
    """The JAX package's f64 design of Mt = 161 markers on its 8-device mesh
    (padded to 168) and the checkpoint of a 2-iteration eigen run on it."""
    d = str(tmp_path_factory.mktemp("padded"))
    sim_main(["--out-dir", d, "--out-name", "ex", "-N", "40", "-M", "161", "--seed", "4"])
    ds = jload(f"{d}/ex.bin", f"{d}/ex.phen", 40, 161, "linear", make_mesh(), jnp.float64)
    ck = os.path.join(d, "ck.npz")
    jinfere(ds.dm, ds.phen.y, JConfig(out_dir=d, out_name="j", iterations=2, seed=7, trace=0,
                                      lmmse_solver="eigen", checkpoint_file=ck, **PRIOR))
    arrays = {k: np.asarray(getattr(ds.dm, k))
              for k in ("X", "mave", "msig", "mmask", "inv_sqrt_n", "n", "mt")}
    return arrays, ck


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_jax_mesh_design_cut_into_slabs(padded_jax, world):
    """The port's slabs of a padded JAX design rebuild its 161 real rows
    exactly, without the padding rows."""
    arrays, _ = padded_jax
    assert arrays["X"].shape[0] == 168 and arrays["mmask"][161:].sum() == 0
    rows = []
    for sh in _shards(161, world):
        dm = convert.design_from_arrays(arrays, shard=sh)
        assert dm.m_pad == sh.hi - sh.lo and dm.mt == 161.0 and float(dm.mmask.min()) == 1.0
        for k in ("mave", "msig"):
            np.testing.assert_array_equal(getattr(dm, k).numpy(), arrays[k][sh.lo:sh.hi])
        rows.append(dm.X.numpy())
    np.testing.assert_array_equal(np.concatenate(rows), arrays["X"][:161])


def test_padded_jax_checkpoint_is_cut_to_mt(padded_jax):
    from vampomi_tpu_torch.engine.checkpoint import load_checkpoint

    _, path = padded_jax
    raw = load_checkpoint(path)
    assert int(raw["meta"]["m_pad"]) == 168
    ck = convert.checkpoint_from_jax(path, model="linear", solver="eigen")
    assert int(ck["meta"]["m_pad"]) == 161
    for k in ("x1_hat", "r1", "mu_warm"):
        np.testing.assert_array_equal(ck["arrays"][k], raw["arrays"][k][:161])
    assert ck["arrays"]["y_adj"].shape == (40,)


@pytest.mark.parametrize("argv,ok", [
    (["--model", "bin_class"], True), (["--run-mode", "test"], True),
    (["--run-mode", "predict", "--model", "bin_class"], True),
    (["--run-mode", "association_test", "--pval-method", "loo"], True),
    ([], True), (["--profile-dir", "prof"], True)])
def test_cli_refuses_what_ranks_do_not_run(monkeypatch, argv, ok):
    """Over ranks every model, run mode and flag runs on any number of
    ranks: --profile-dir, the last flag refused, parses now too."""
    monkeypatch.setenv("VAMPOMI_DISTRIBUTED", "1")
    base = ["--meth-file", "x.bin", "--device", "cpu"]
    for world in ("2", "1"):
        monkeypatch.setenv("WORLD_SIZE", world)
        if ok:
            cfg = cli.parse_config(base + argv)
            assert [cfg.model, cfg.run_mode, cfg.profile_dir] == [
                argv[argv.index(f) + 1] if f in argv else d
                for f, d in (("--model", "linear"), ("--run-mode", "infere"),
                             ("--profile-dir", ""))]
        else:
            with pytest.raises(SystemExit, match="ROADMAP.md"):
                cli.parse_config(base + argv)


def test_one_rank_group_is_bitwise_no_group(tmp_path):
    """A process group of one rank sends every sum through gloo; the results
    are those of the run without a group, bit for bit."""
    d = str(tmp_path)
    sim_main(["--out-dir", d, "--out-name", "ex", "-N", "60", "-M", "90", "--seed", "2"])
    jobs = lambda out: [  # noqa: E731
        dict(name=f"r_{dt}_{s}", out_dir=os.path.join(d, out), meth=f"{d}/ex.bin",
             phen=f"{d}/ex.phen", ts=f"{d}/ex_ts.bin", n=60, mt=90, dtype=dt, solver=s,
             iterations=3) for dt, s in (("float64", "eigen"), ("float64", "cg"), ("int8", "cg"),
                                         ("int4", "spectral"))]
    for out in ("g", "n"):
        os.makedirs(os.path.join(d, out))
    grouped, = launch(d, 1, jobs("g"))
    alone, = launch(d, 0, jobs("n"))
    for g, a in zip(grouped, alone):
        assert (g["gamw"], g["x1"]) == (a["gamw"], a["x1"])
        assert g["collectives"] and a["collectives"] is None
    for f in sorted(os.listdir(os.path.join(d, "n"))):
        assert (open(os.path.join(d, "g", f), "rb").read()
                == open(os.path.join(d, "n", f), "rb").read()), f


# The one-process engine on a fixed problem, as digests of every output
# (metrics, estimates, gamw, gam1 and every file the run wrote: CSVs,
# dumps, eigen cache, checkpoint).  The digests were taken from the engine
# before sharding existed; the run pins torch's CPU kernels to their
# portable path, MKL to its reproducible mode, OpenBLAS (numpy's) to one
# kernel set and numpy's loops to AVX2 at most, one thread, so that they do
# not depend on the host's vector unit.
GOLDEN = {"g_float64_eigen": "d3a1082d5c81d0bd", "g_float64_spectral": "c107ea745cec5e0c",
          "g_float64_cg": "450fba53f517f861", "g_int8_eigen": "2db923640152741f",
          "g_int8_cg": "ef1601e4bcd5adeb", "g_int4_spectral": "d39db81e77687dd5"}
_GOLDEN_RUN = r"""
import hashlib, json, os, sys, tempfile
import numpy as np, torch
torch.set_num_threads(1)
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.dataset import load_dataset
from vampomi_tpu_torch.engine.linear import infere_linear
from vampomi_tpu_torch.sim.data_sim import main as sim_main
out = {}
with tempfile.TemporaryDirectory() as d:
    sim_main(["--out-dir", d, "--out-name", "ex", "-N", "120", "-M", "160", "--seed", "4"])
    ts = np.fromfile(d + "/ex_ts.bin")
    for dtype, solver, extra in (("float64", "eigen", {}), ("float64", "spectral", {}),
                                 ("float64", "cg", {}), ("int8", "eigen", {"eigen_cache": "c.npz"}),
                                 ("int8", "cg", {"checkpoint_file": "ck.npz"}),
                                 ("int4", "spectral", {})):
        ds = load_dataset(d + "/ex.bin", d + "/ex.phen", 120, 160, "linear",
                          RunConfig(compute_dtype=dtype).resolved_compute_dtype(), "cpu")
        name = f"g_{dtype}_{solver}"
        extra = {k: os.path.join(d, v) for k, v in extra.items()}
        cfg = RunConfig(out_dir=d, out_name=name, iterations=4, h2=0.8, probs=[0.9, 0.07, 0.03],
                        vars=[0.0, 1e-3, 1e-2], stop_criteria_thr=0.0, seed=7, trace=0,
                        device="cpu", lmmse_solver=solver, compute_dtype=dtype, **extra)
        res = infere_linear(ds.dm, ds.phen.y, cfg, true_signal=ts)
        h = hashlib.sha256()
        h.update(np.asarray(res.metrics_history).tobytes())
        h.update(res.x1_hat_scaled.tobytes()); h.update(res.r1_scaled.tobytes())
        h.update(np.float64(res.gamw).tobytes()); h.update(np.float64(res.gam1).tobytes())
        for f in sorted(os.listdir(d)):
            if f.startswith(name + "_"):
                h.update(f.encode()); h.update(open(os.path.join(d, f), "rb").read())
        out[name] = h.hexdigest()[:16]
print(json.dumps(out))
"""


def _pinned() -> dict:
    """The rank environment with every library pinned to one code path."""
    return dict(env(), ATEN_CPU_CAPABILITY="default", MKL_CBWR="COMPATIBLE",
                OPENBLAS_CORETYPE="Haswell",
                NPY_DISABLE_CPU_FEATURES="AVX512F AVX512CD AVX512_SKX AVX512_CLX "
                                         "AVX512_CNL AVX512_ICL")


def test_one_process_engine_is_bitwise_unchanged():
    p = subprocess.run([sys.executable, "-c", _GOLDEN_RUN], cwd=REPO, env=_pinned(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == GOLDEN


# The one-process probit engine and the run modes on a fixed problem, as
# digests of every output (metrics, estimates, r1, gam1, tau1, cov_eff,
# the checkpoint's contents and every file the run wrote), pinned as above.
# Taken from the code before probit and the modes took a shard: f64, int8
# and int4, eigen, spectral and CG, C = 2 covariates, checkpoints; SE, LOO,
# loo_std, test and predict for both models, f64 and int8.
GOLDEN_PROBIT = {
    "p_float64_eigen": "728843d8a9eda8f9", "p_float64_spectral": "bf4b4edfd0966af6",
    "p_float64_cg": "0d1c8a624deff705", "p_int8_eigen": "17b0283e64bb6b7d",
    "p_int8_cg": "92d5dccd2174baee", "p_int4_spectral": "cf739dbe2a366f6b",
    "a_float64_se": "e4e37e071c9fa416", "a_float64_loo": "effa571b9ac9847e",
    "a_float64_loo_std": "f12e65af09353dbb", "t_float64": "67ed0757bdda4014",
    "y_float64": "aa0f96f27475ddcc", "tp_float64": "b11958287d0a2ccb",
    "yp_float64": "cd55722657a363d3", "a_int8_se": "498fcd1ef1dfe456",
    "a_int8_loo": "9e4de8fc3887b3a2", "a_int8_loo_std": "af870e37ccbfc8cb",
    "t_int8": "37c77d42b3589379", "y_int8": "e08e06c2044d0dab",
    "tp_int8": "c8467305e2aa61b2", "yp_int8": "9ca68b4715e6d5dc"}
_GOLDEN_PROBIT_RUN = r"""
import dataclasses, hashlib, json, os, tempfile
import numpy as np, torch
torch.set_num_threads(1)
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.dataset import load_dataset
from vampomi_tpu_torch.engine.checkpoint import load_checkpoint
from vampomi_tpu_torch.engine.linear import infere_linear
from vampomi_tpu_torch.engine.probit import infere_bin_class
from vampomi_tpu_torch.modes.association import run_association_test
from vampomi_tpu_torch.modes.predict import run_predict
from vampomi_tpu_torch.modes.test_mode import run_test_linear, run_test_probit
from vampomi_tpu_torch.sim.data_sim import main as sim_main
HYPER = dict(probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], stop_criteria_thr=0.0, seed=7,
             trace=0, device="cpu")
out = {}
def digest(name, d, *arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, dtype=np.float64)).tobytes())
    for f in sorted(os.listdir(d)):
        if f.startswith(name + "_") or f.startswith(name + "."):
            h.update(f.encode()); h.update(open(os.path.join(d, f), "rb").read())
    out[name] = h.hexdigest()[:16]
dt = lambda s: RunConfig(compute_dtype=s).resolved_compute_dtype()
with tempfile.TemporaryDirectory() as d:
    sim_main(["--out-dir", d, "--out-name", "ex", "-N", "120", "-M", "160", "--seed", "4"])
    ts = np.fromfile(d + "/ex_ts.bin")
    rows = [line.split() for line in open(d + "/ex.phen").read().splitlines()]
    open(d + "/ex01.phen", "w").write("".join(f"{a} {b} {int(float(v) > 0)}\n"
                                              for a, b, v in rows))
    z = np.random.default_rng(1).normal(size=(120, 2))
    open(d + "/ex.cov", "w").write("ID FID c1 c2\n" + "".join(
        f"{i} {i} {a!r} {b!r}\n" for i, (a, b) in enumerate(z.tolist())))
    for dtype, solver, c, ck in (("float64", "eigen", 2, True), ("float64", "spectral", 0, False),
                                 ("float64", "cg", 0, False), ("int8", "eigen", 0, False),
                                 ("int8", "cg", 0, True), ("int4", "spectral", 2, False)):
        ds = load_dataset(d + "/ex.bin", d + "/ex01.phen", 120, 160, "bin_class", dt(dtype),
                          "cpu", cov_file=d + "/ex.cov" if c else "", c=c)
        name = f"p_{dtype}_{solver}"
        cfg = RunConfig(out_dir=d, out_name=name, iterations=4, rho=0.3, gam1=1e-2, C=c,
                        lmmse_solver=solver, compute_dtype=dtype, model="bin_class",
                        checkpoint_file=os.path.join(d, name + ".npz") if ck else "", **HYPER)
        res = infere_bin_class(ds.dm, ds.phen.y, cfg, true_signal=ts, covariates=ds.covariates)
        arrs = [np.asarray(res.metrics_history), res.x1_hat_scaled, res.r1_scaled,
                [res.gam1, res.tau1], res.cov_eff if res.cov_eff is not None else []]
        if ck:
            k = load_checkpoint(os.path.join(d, name + ".npz"))
            arrs += [k["arrays"][a] for a in sorted(k["arrays"])]
            arrs += [[k["scalars"][a] for a in sorted(k["scalars"])], k["prior"]["probs"],
                     k["prior"]["vars"], k["rng_state"], [k["iteration"]]]
        digest(name, d, *arrs)
    for dtype in ("float64", "int8"):
        lin = f"l_{dtype}"
        ds = load_dataset(d + "/ex.bin", d + "/ex.phen", 120, 160, "linear", dt(dtype), "cpu")
        cfg = RunConfig(out_dir=d, out_name=lin, iterations=4, h2=0.8, lmmse_solver="eigen",
                        compute_dtype=dtype, **HYPER)
        res = infere_linear(ds.dm, ds.phen.y, cfg, true_signal=ts)
        mcfg = RunConfig(out_dir=d, N=120, Mt=160, N_test=120, gam1=res.gam1, device="cpu",
                         r1_file=f"{d}/{lin}_r1_it_4.bin", estimate_file=f"{d}/{lin}_it_4.bin",
                         test_iter_range=[1, 4])
        for method in ("se", "loo", "loo_std"):
            name = f"a_{dtype}_{method}"
            pv = run_association_test(ds, dataclasses.replace(mcfg, out_name=name,
                                                              pval_method=method))
            digest(name, d, pv)
        name = f"t_{dtype}"
        digest(name, d, run_test_linear(ds, dataclasses.replace(
            mcfg, out_name=name, estimate_file=f"{d}/{lin}_it_1.bin")))
        np.fromfile(f"{d}/{lin}_it_4.bin").tofile(f"{d}/y_{dtype}_it_4.bin")
        digest(f"y_{dtype}", d, run_predict(ds, dataclasses.replace(
            mcfg, estimate_file=f"{d}/y_{dtype}_it_4.bin")))
        dsp = load_dataset(d + "/ex.bin", d + "/ex01.phen", 120, 160, "bin_class", dt(dtype),
                           "cpu")
        name = f"tp_{dtype}"
        digest(name, d, run_test_probit(dsp, dataclasses.replace(
            mcfg, out_name=name, estimate_file=f"{d}/p_{dtype}_eigen_it_1.bin")))
        np.fromfile(f"{d}/p_{dtype}_eigen_it_4.bin").tofile(f"{d}/yp_{dtype}_it_4.bin")
        digest(f"yp_{dtype}", d, run_predict(dsp, dataclasses.replace(
            mcfg, estimate_file=f"{d}/yp_{dtype}_it_4.bin")))
print(json.dumps(out))
"""


def test_one_process_probit_and_modes_are_bitwise_unchanged():
    p = subprocess.run([sys.executable, "-c", _GOLDEN_PROBIT_RUN], cwd=REPO, env=_pinned(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == GOLDEN_PROBIT
