"""The port's CLI against the JAX CLI on the verify recipe's fixture
(N = 200, M = 256): the same output files, the same positional CSV layout
and values within tolerance, for inference with each LMMSE solver and for the
test, association_test and predict modes over f64, int8 and int4 designs;
and SystemExit on every mode and flag the port does not run yet.

The JAX CLI runs on the test suite's 8-device CPU mesh, so its sums run in
another order; the CG comparison replays the JAX engine's seeded probes
into the port, since the two frameworks' RNGs cannot give the same draws."""

import os

import jax
import numpy as np
import pytest
import torch

from vampomi_tpu.cli import main as jcli_main
from vampomi_tpu_torch.cli import main as tcli_main
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
    ["--model", "bin_class"], ["--run-mode", "association_test", "--model", "bin_class"],
    ["--C", "2"], ["--resume-file", "ck.npz"],
    ["--checkpoint-file", "ck.npz"], ["--eigen-cache", "e.npz"], ["--init-conf", "g.conf"],
    ["--profile-dir", "prof"], ["--compute-dtype", "bf16"],
]


@pytest.mark.parametrize("extra", UNPORTED, ids=lambda a: "".join(a).lstrip("-"))
def test_cli_unported_modes_and_flags_exit(tmp_path, extra):
    argv = ["--meth-file", str(tmp_path / "x.bin"), "--phen-file", str(tmp_path / "x.phen"),
            "--N", "10", "--Mt", "10", "--device", "cpu", "--out-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        tcli_main(argv + extra)
    assert not os.listdir(tmp_path)


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
