"""The port's CLI against the JAX CLI on the verify recipe's fixture
(N = 200, M = 256): the same output files, the same positional CSV layout
and values within tolerance, for inference with each LMMSE solver and for the
test, association_test and predict modes over f64, int8 and int4 designs;
probit inference (`--model bin_class`) and covariates (`--C`, `--cov-file`)
for both models; and SystemExit on every flag the port does not run yet.

The JAX CLI runs on the test suite's 8-device CPU mesh, so its sums run in
another order; the CG comparison replays the JAX engine's seeded probes
into the port, since the two frameworks' RNGs cannot give the same draws."""

import os

import jax
import numpy as np
import pytest
import torch

from vampomi_tpu.cli import main as jcli_main
from vampomi_tpu_torch.cli import main as tcli_main, parse_config
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.io.csv_writer import read_positional_csv
from vampomi_tpu_torch.sim.data_sim import main as sim_main

torch.set_num_threads(2)

N, M = 200, 256
SOLVERS = ["cg", "eigen", "spectral"]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vfy")
    sim_main(["--out-dir", str(d), "--out-name", "example", "-N", str(N), "-M", str(M),
              "--seed", "11"])
    return str(d)


def _args(d, out, solver):
    return ["--run-mode", "infere", "--model", "linear",
            "--meth-file", f"{d}/example.bin", "--phen-file", f"{d}/example.phen",
            "--true-signal-file", f"{d}/example_ts.bin", "--N", str(N), "--Mt", str(M),
            "--out-dir", d, "--out-name", out, "--iterations", "8", "--h2", "0.8",
            "--probs", "0.9,0.07,0.03", "--vars", "0.0,0.001,0.01",
            "--lmmse-solver", solver]


def _jax_probes(seed, n_iter, m):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_iter):
        key, sub = jax.random.split(key)
        b = jax.random.rademacher(sub, (m,), dtype=jax.numpy.float64) * (1.0 / np.sqrt(float(m)))
        out.append(torch.as_tensor(np.array(b)))
    return out


@pytest.fixture(scope="module")
def runs(fixture_dir):
    d = fixture_dir
    mp = pytest.MonkeyPatch()
    try:
        for solver in SOLVERS:
            assert jcli_main(_args(d, f"jax_{solver}", solver)) in (0, None)
            feed = iter(_jax_probes(0, 8, M))
            mp.setattr(tlin, "_draw_probe", lambda gen, dm: next(feed))
            assert tcli_main(_args(d, f"pt_{solver}", solver) + ["--device", "cpu"]) == 0
    finally:
        mp.undo()
    return d


def _outputs(d, prefix):
    return sorted(f[len(prefix):] for f in os.listdir(d) if f.startswith(prefix + "_"))


@pytest.mark.parametrize("solver", SOLVERS)
def test_cli_writes_the_same_files(runs, solver):
    got, want = _outputs(runs, f"pt_{solver}"), _outputs(runs, f"jax_{solver}")
    assert got == want
    assert "_it_8.bin" in got and "_r1_it_8.bin" in got and "_trace.jsonl" in got


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("name", ["metrics", "params", "prior"])
def test_cli_csv_layout_and_values_match(runs, solver, name):
    """Same header bytes, same positional layout (row offsets and NUL gaps),
    byte-identical wherever the formatted values agree, and values within
    tolerance: rtol 1e-5 — f64 sums in another order, amplified through 8
    iterations of CG stopped at rel-residual 1e-5 (eigen agrees closer)."""
    pt = open(os.path.join(runs, f"pt_{solver}_{name}.csv"), "rb").read()
    jx = open(os.path.join(runs, f"jax_{solver}_{name}.csv"), "rb").read()
    assert len(pt) == len(jx)
    assert pt.split(b"\n", 1)[0] == jx.split(b"\n", 1)[0]
    assert [i for i, b in enumerate(pt) if b == 0] == [i for i, b in enumerate(jx) if b == 0]
    for lp, lj in zip(pt.replace(b"\0", b"").split(b"\n"), jx.replace(b"\0", b"").split(b"\n")):
        fp, fj = lp.split(b","), lj.split(b",")
        assert [len(f) for f in fp] == [len(f) for f in fj]
        for a, b in zip(fp, fj):
            if a != b:
                assert abs(float(a) - float(b)) > 0  # differ only where the value does
    got = np.asarray(read_positional_csv(os.path.join(runs, f"pt_{solver}_{name}.csv")))
    want = np.asarray(read_positional_csv(os.path.join(runs, f"jax_{solver}_{name}.csv")))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("solver", SOLVERS)
def test_cli_estimates_match(runs, solver):
    for it in (1, 4, 8):
        got = np.fromfile(os.path.join(runs, f"pt_{solver}_it_{it}.bin"))
        want = np.fromfile(os.path.join(runs, f"jax_{solver}_it_{it}.bin"))
        assert got.shape == want.shape == (M,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())
    metrics = read_positional_csv(os.path.join(runs, f"pt_{solver}_metrics.csv"))
    assert metrics[-1][2] > 0.9  # x1 correlation of the recipe (~0.95 by it 8)


UNPORTED = [
    ["--resume-file", "ck.npz"],
    ["--checkpoint-file", "ck.npz"], ["--eigen-cache", "e.npz"],
    ["--profile-dir", "prof"], ["--compute-dtype", "bf16"],
]


@pytest.mark.parametrize("extra", UNPORTED, ids=lambda a: "".join(a).lstrip("-"))
def test_cli_unported_modes_and_flags_exit(tmp_path, extra):
    """The flags that were once refused (checkpoints, the eigen cache, bf16,
    and --profile-dir, the last of them) parse into the run's configuration
    now, and parsing does no work."""
    argv = ["--meth-file", str(tmp_path / "x.bin"), "--phen-file", str(tmp_path / "x.phen"),
            "--N", "10", "--Mt", "10", "--device", "cpu", "--out-dir", str(tmp_path)]
    cfg = parse_config(argv + extra)
    field = extra[0].lstrip("-").replace("-", "_")
    assert getattr(cfg, field) == extra[1]
    if field == "compute_dtype":
        assert cfg.resolved_compute_dtype() == torch.bfloat16
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("solver", SOLVERS)
def test_cli_checkpoint_and_resume_through_files(fixture_dir, solver):
    """--checkpoint-file then --resume-file through the port's CLI: 4 + 4
    iterations write the same bytes as 8 straight (the CSVs, appended to,
    and the dumps of iterations 5-8)."""
    d = fixture_dir
    common = ["--device", "cpu", "--seed", "3"]
    full = _args(d, f"ckf_{solver}", solver) + common
    assert tcli_main(full + ["--checkpoint-file", f"{d}/ckf_{solver}.npz"]) == 0
    first = _args(d, f"ckr_{solver}", solver) + common
    first[first.index("--iterations") + 1] = "4"
    assert tcli_main(first + ["--checkpoint-file", f"{d}/ckr_{solver}.npz"]) == 0
    assert tcli_main(_args(d, f"ckr_{solver}", solver) + common
                     + ["--resume-file", f"{d}/ckr_{solver}.npz"]) == 0
    names = [f"_{c}.csv" for c in ("metrics", "params", "prior")]
    names += [f"_{k}it_{i}.bin" for k in ("", "r1_") for i in range(5, 9)]
    for f in names:
        a, b = (open(f"{d}/{p}_{solver}{f}", "rb").read() for p in ("ckf", "ckr"))
        assert a == b, f


def test_cli_eigen_cache_loads_on_the_second_run(fixture_dir, capsys):
    d = fixture_dir
    argv = _args(d, "cache", "eigen") + ["--device", "cpu", "--eigen-cache", f"{d}/eig.npz"]
    assert tcli_main(argv) == 0
    first = np.fromfile(f"{d}/cache_it_8.bin")
    assert os.path.exists(f"{d}/eig.npz") and "eigenbasis of K built" in capsys.readouterr().out
    assert tcli_main(argv) == 0
    assert "eigenbasis of K loaded" in capsys.readouterr().out
    np.testing.assert_array_equal(np.fromfile(f"{d}/cache_it_8.bin"), first)


def test_cli_bf16_matches_the_jax_cli(fixture_dir):
    """--compute-dtype bf16 through both CLIs (eigen, deterministic): the
    same files, estimates within the bf16 rounding of JAX's vectors (the
    int8 design's tolerance, test_torch_engine_linear.py)."""
    d = fixture_dir
    argv = _args(d, "jbf", "eigen") + ["--compute-dtype", "bf16"]
    assert jcli_main(argv) in (0, None)
    argv = _args(d, "pbf", "eigen") + ["--compute-dtype", "bf16", "--device", "cpu"]
    assert tcli_main(argv) == 0
    assert _outputs(d, "pbf") == _outputs(d, "jbf")
    got, want = np.fromfile(f"{d}/pbf_it_8.bin"), np.fromfile(f"{d}/jbf_it_8.bin")
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max())
    np.testing.assert_allclose(np.asarray(read_positional_csv(f"{d}/pbf_metrics.csv")),
                               np.asarray(read_positional_csv(f"{d}/jbf_metrics.csv")),
                               rtol=2e-2, atol=2e-3)


# ---------------------------------------------------------------------------
# probit inference and covariates through files: both CLIs on the fixture's
# design with 0/1 labels and a covariate file; the port replays JAX's p1
# (and, for CG, its probes)

PROBIT_CASES = {  # name: (model, solver, with covariates)
    "bin_cg": ("bin_class", "cg", False),
    "bin_spectral": ("bin_class", "spectral", False),
    "bin_eigen": ("bin_class", "eigen", False),
    "bin_spectral_cov": ("bin_class", "spectral", True),
    "lin_eigen_cov": ("linear", "eigen", True),
}


def _probit_args(d, out, model, solver, cov):
    phen = f"{d}/example_bin.phen" if model == "bin_class" else f"{d}/example.phen"
    argv = ["--run-mode", "infere", "--model", model, "--meth-file", f"{d}/example.bin",
            "--phen-file", phen, "--true-signal-file", f"{d}/example_ts.bin", "--N", str(N),
            "--Mt", str(M), "--out-dir", d, "--out-name", out, "--iterations", "6",
            "--probs", "0.9,0.07,0.03", "--vars", "0.0,0.001,0.01", "--lmmse-solver", solver,
            "--stop-criteria-thr", "1e-8"]
    argv += ["--rho", "0.3", "--gam1", "1e-2"] if model == "bin_class" else ["--h2", "0.8"]
    return argv + (["--C", "2", "--cov-file", f"{d}/example.cov"] if cov else [])


@pytest.fixture(scope="module")
def probit_runs(runs):
    """Every case through both CLIs.  The 0/1 labels threshold the
    fixture's phenotype at its median; two covariates shift it."""
    from tests.test_torch_probit import replay_draws

    d = runs
    rows = [line.split() for line in open(f"{d}/example.phen").read().splitlines()]
    y = np.array([float(r[2]) for r in rows])
    Z = np.random.default_rng(8).normal(size=(N, 2))
    with open(f"{d}/example_bin.phen", "w") as f:
        for r, v in zip(rows, (y + Z @ [0.6, -0.4] > np.median(y)).astype(int)):
            f.write(f"{r[0]} {r[1]} {v}\n")
    with open(f"{d}/example.cov", "w") as f:
        f.write("ID FID c1 c2\n")
        for r, z in zip(rows, Z):
            f.write(f"{r[0]} {r[1]} {float(z[0])!r} {float(z[1])!r}\n")
    for name, (model, solver, cov) in PROBIT_CASES.items():
        assert jcli_main(_probit_args(d, f"jax_{name}", model, solver, cov)) in (0, None)
        mp = pytest.MonkeyPatch()
        try:
            replay_draws(mp, 0, N, M, 6, jax.numpy.float64, probes=solver == "cg")
            argv = _probit_args(d, f"pt_{name}", model, solver, cov) + ["--device", "cpu"]
            assert tcli_main(argv) == 0
        finally:
            mp.undo()
    return d


@pytest.mark.parametrize("case", list(PROBIT_CASES))
def test_cli_probit_and_covariates_write_the_same_files(probit_runs, case):
    got, want = _outputs(probit_runs, f"pt_{case}"), _outputs(probit_runs, f"jax_{case}")
    assert got == want
    assert "_it_6.bin" in got and "_r1_it_6.bin" in got and "_trace.jsonl" in got


@pytest.mark.parametrize("case", list(PROBIT_CASES))
@pytest.mark.parametrize("name", ["metrics", "params", "prior"])
def test_cli_probit_and_covariates_csvs_match(probit_runs, case, name):
    """Same header and positional layout (the probit params row holds 8
    values under the 6-name header, its prior row the ×N variances), values
    to rtol 1e-5 as the linear runs above."""
    pt = open(os.path.join(probit_runs, f"pt_{case}_{name}.csv"), "rb").read()
    jx = open(os.path.join(probit_runs, f"jax_{case}_{name}.csv"), "rb").read()
    assert len(pt) == len(jx)
    assert pt.split(b"\n", 1)[0] == jx.split(b"\n", 1)[0]
    assert [i for i, b in enumerate(pt) if b == 0] == [i for i, b in enumerate(jx) if b == 0]
    got = np.asarray(read_positional_csv(os.path.join(probit_runs, f"pt_{case}_{name}.csv")))
    want = np.asarray(read_positional_csv(os.path.join(probit_runs, f"jax_{case}_{name}.csv")))
    if name == "params":
        assert got.shape[1] == (9 if PROBIT_CASES[case][0] == "bin_class" else 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("case", list(PROBIT_CASES))
def test_cli_probit_and_covariates_estimates_match(probit_runs, case):
    for it in (1, 3, 6):
        for kind in ("it", "r1_it"):
            got = np.fromfile(os.path.join(probit_runs, f"pt_{case}_{kind}_{it}.bin"))
            want = np.fromfile(os.path.join(probit_runs, f"jax_{case}_{kind}_{it}.bin"))
            assert got.shape == want.shape == (M,)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())


@pytest.mark.parametrize("method", ["se", "loo"])
def test_cli_probit_association_test_matches_jax(probit_runs, method):
    """association_test --model bin_class (0/1 labels read raw) on the
    probit eigen run's dumps, through both CLIs."""
    d = probit_runs
    gam1 = read_positional_csv(f"{d}/jax_bin_eigen_params.csv")[-1][3]
    src = {"se": ["--r1-file", f"{d}/jax_bin_eigen_r1_it_6.bin", "--gam1", repr(gam1)],
           "loo": ["--estimate-file", f"{d}/jax_bin_eigen_it_6.bin"]}[method]
    for who, main, extra in (("jax", jcli_main, []), ("pt", tcli_main, ["--device", "cpu"])):
        argv = ["--run-mode", "association_test", "--model", "bin_class", "--pval-method", method,
                "--meth-file", f"{d}/example.bin", "--phen-file", f"{d}/example_bin.phen",
                "--N", str(N), "--Mt", str(M), "--out-dir", d, "--out-name", f"{who}_passoc"]
        assert main(argv + src + extra) in (0, None)
    g, w = (np.fromfile(f"{d}/{who}_passoc_it_6_pval_{method}.bin") for who in ("pt", "jax"))
    assert g.shape == (M,) and np.all((g >= 0) & (g <= 1))
    if method == "se":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(np.log10(g + 1e-300), np.log10(w + 1e-300), rtol=1e-9,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# the run modes through files: both CLIs on the JAX eigen run's dumps

KINDS = {"f64": "float64", "int8": "int8", "int4": "int4"}
MODES = ["test", "se", "loo", "loo_std", "predict"]


def _mode_args(d, mode, kind, out, est):
    common = ["--Mt", str(M), "--out-dir", d, "--out-name", out,
              "--compute-dtype", KINDS[kind]]
    if mode in ("test", "predict"):
        return ["--run-mode", mode, "--meth-file-test", f"{d}/example.bin",
                "--phen-file-test", f"{d}/example.phen", "--N-test", str(N),
                "--estimate-file", est, "--test-iter-range", "1,8"] + common
    base = ["--run-mode", "association_test", "--meth-file", f"{d}/example.bin",
            "--phen-file", f"{d}/example.phen", "--N", str(N), "--pval-method", mode]
    if mode == "se":
        return base + ["--r1-file", f"{d}/jax_eigen_r1_it_8.bin", "--gam1", "4.7"] + common
    return base + ["--estimate-file", est] + common


@pytest.fixture(scope="module")
def mode_runs(runs):
    """Every mode for every design kind through both CLIs; predict reads a
    copy of the estimate per package, since it writes <prefix>.yhat beside
    it."""
    d = runs
    est8 = np.fromfile(f"{d}/jax_eigen_it_8.bin")
    for kind in KINDS:
        for who, main, extra in (("jax", jcli_main, []), ("pt", tcli_main, ["--device", "cpu"])):
            for mode in MODES:
                out = f"{who}_{kind}_{mode}"
                est = f"{d}/jax_eigen_it_1.bin" if mode == "test" else f"{d}/{out}_it_8.bin"
                if mode != "test":
                    est8.tofile(est)
                assert main(_mode_args(d, mode, kind, out, est) + extra) in (0, None)
    return d


def _mode_output(d, who, kind, mode):
    out = f"{d}/{who}_{kind}_{mode}"
    if mode == "test":
        return f"{out}_test.csv"
    if mode == "predict":
        return f"{out}_.yhat"
    return f"{out}_it_8_pval_{mode}.bin"


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("mode", MODES)
def test_cli_modes_write_what_the_jax_cli_writes(mode_runs, kind, mode):
    """The same file with the same layout; values to rtol 1e-9 for f64 (the
    JAX CLI sums over its 8-device test mesh), within the quantized
    designs' tolerance against JAX's bf16-rounded products otherwise (the
    port's own quantized modes are held against the f64 brute force in
    tests/test_torch_modes.py)."""
    got_path, want_path = (_mode_output(mode_runs, w, kind, mode) for w in ("pt", "jax"))
    got, want = open(got_path, "rb").read(), open(want_path, "rb").read()
    assert len(got) > 0
    if kind == "f64" or mode != "predict":  # %g text of other values may be shorter
        assert len(got) == len(want)
    if mode == "test":
        assert got.split(b"\n")[0] == want.split(b"\n")[0]
        g, w = (np.asarray(read_positional_csv(p)) for p in (got_path, want_path))
        assert g.shape == (8, 3)
    elif mode == "predict":
        g, w = (np.array([float(v) for v in t.decode().split()]) for t in (got, want))
        assert g.shape == (N,)
    else:
        g, w = np.frombuffer(got), np.frombuffer(want)
        assert g.shape == (M,) and np.all((g >= 0) & (g <= 1))
        if mode != "se":
            g, w = np.log10(g + 1e-300), np.log10(w + 1e-300)
    assert np.all(np.isfinite(g))
    if mode == "se":
        np.testing.assert_array_equal(g, w)  # r1 file and arithmetic shared
    elif kind == "f64":
        np.testing.assert_allclose(g, w, rtol=1e-4 if mode == "predict" else 1e-9,
                                   atol=1e-5 if mode == "predict" else 1e-12)
    else:
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)
