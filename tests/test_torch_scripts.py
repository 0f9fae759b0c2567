"""The port's five analysis scripts (vampomi_tpu_torch/scripts: p_vals,
metrics, roc, r2, manhattan) against the JAX package's on the outputs of
one run of the port's CLI, and the CLI's --profile-dir."""

import contextlib
import glob
import io
import json
import os

import numpy as np
import pytest

from vampomi_tpu.scripts import manhattan as jmanhattan
from vampomi_tpu.scripts import metrics as jmetrics
from vampomi_tpu.scripts import p_vals as jp_vals
from vampomi_tpu.scripts import r2 as jr2
from vampomi_tpu.scripts import roc as jroc
from vampomi_tpu_torch.cli import main as tcli_main
from vampomi_tpu_torch.io.csv_writer import read_positional_csv
from vampomi_tpu_torch.scripts import manhattan, metrics, p_vals, r2, roc
from vampomi_tpu_torch.sim.data_sim import main as sim_main

N, M, ITERS = 80, 120, 4


def _run_cli(d: str, name: str, *extra: str) -> None:
    tcli_main(["--device", "cpu", "--run-mode", "infere", "--meth-file", f"{d}/ex.bin",
               "--phen-file", f"{d}/ex.phen", "--true-signal-file", f"{d}/ex_ts.bin",
               "--N", str(N), "--Mt", str(M), "--out-dir", d, "--out-name", name,
               "--iterations", str(ITERS), "--stop-criteria-thr", "0", "--h2", "0.8",
               "--probs", "0.9,0.07,0.03", "--vars", "0.0,0.001,0.01",
               "--lmmse-solver", "eigen", "--compute-dtype", "int8", *extra])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One int8 eigen run of the port's CLI, then its test, SE and predict
    modes on the same file: every input the scripts read."""
    d = str(tmp_path_factory.mktemp("scripts"))
    sim_main(["--out-dir", d, "--out-name", "ex", "-N", str(N), "-M", str(M), "--seed", "6"])
    _run_cli(d, "r")
    gam1 = read_positional_csv(f"{d}/r_params.csv")[ITERS - 1][2]
    common = ["--device", "cpu", "--Mt", str(M), "--out-dir", d, "--compute-dtype", "int8"]
    tcli_main(common + ["--run-mode", "test", "--meth-file-test", f"{d}/ex.bin",
                        "--phen-file-test", f"{d}/ex.phen", "--N-test", str(N),
                        "--estimate-file", f"{d}/r_it_1.bin", "--test-iter-range", f"1,{ITERS}",
                        "--out-name", "r"])
    tcli_main(common + ["--run-mode", "association_test", "--pval-method", "se",
                        "--meth-file", f"{d}/ex.bin", "--phen-file", f"{d}/ex.phen",
                        "--N", str(N), "--r1-file", f"{d}/r_r1_it_{ITERS}.bin",
                        "--gam1", repr(gam1), "--out-name", "se"])
    tcli_main(common + ["--run-mode", "predict", "--meth-file-test", f"{d}/ex.bin",
                        "--phen-file-test", f"{d}/ex.phen", "--N-test", str(N),
                        "--estimate-file", f"{d}/r_it_{ITERS}.bin", "--out-name", "r"])
    return d


def _both(port_main, jax_main, argv_of):
    """Each package's script on its argv; (return values, printed lines)."""
    res = {}
    for tag, fn in (("port", port_main), ("jax", jax_main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = fn(argv_of(tag))
        res[tag] = (r, buf.getvalue().splitlines())
    return res


def test_p_vals_is_jaxs_and_the_se_modes_file(run):
    res = _both(p_vals.main, jp_vals.main, lambda tag: [
        "--out-name", f"pv_{tag}", "--csv-params", f"{run}/r_params.csv",
        "--r1-file", f"{run}/r_r1_it_{ITERS}.bin", "--it", str(ITERS), "--M", str(M),
        "--N", str(N)])
    port, jax = (open(f"{run}/pv_{t}.bin", "rb").read() for t in ("port", "jax"))
    assert port == jax == open(f"{run}/se_it_{ITERS}_pval_se.bin", "rb").read()
    assert res["port"][1][:-1] == res["jax"][1][:-1]  # the last line names the file
    assert int(res["port"][1][3].split("|")[3]) >= 0


def test_metrics_is_jaxs(run):
    res = _both(metrics.main, jmetrics.main, lambda tag: [
        "--csv-metrics", f"{run}/r_metrics.csv", "--csv-test", f"{run}/r_test.csv",
        "--csv-params", f"{run}/r_params.csv", "--csv-prior", f"{run}/r_prior.csv",
        "--iterations", str(ITERS)])
    assert res["port"][1] == res["jax"][1]
    for k, v in res["port"][0].items():
        np.testing.assert_array_equal(v, res["jax"][0][k], err_msg=k)
    assert os.path.getsize(f"{run}/r_metrics.png") > 0


def test_roc_is_jaxs(run):
    res = _both(roc.main, jroc.main, lambda tag: [
        "--pval", f"{run}/se_it_{ITERS}_pval_se.bin", "--true-signal", f"{run}/ex_ts.bin",
        "--out-name", f"roc_{tag}", "--it", str(ITERS), "--M", str(M)])
    assert [ln for ln in res["port"][1] if "saved" not in ln] == \
        [ln for ln in res["jax"][1] if "saved" not in ln]
    assert res["port"][0]["auc"] == res["jax"][0]["auc"] and res["port"][0]["auc"] > 0.5
    assert os.path.getsize(f"{run}/roc_port.png") > 0


def test_r2_is_jaxs(run):
    res = _both(r2.main, jr2.main, lambda tag: [
        "--est", f"{run}/r_.yhat", "--true", f"{run}/ex.phen"])
    assert res["port"] == res["jax"] and 0 < res["port"][0] <= 1


def test_manhattan_is_jaxs(run, tmp_path):
    probes = str(tmp_path / "probes")
    for c, (lo, hi) in enumerate(((0, 50), (50, 90), (90, M))):
        with open(f"{probes}{c + 1}.txt", "w") as f:
            f.writelines(f"cg{i}\n" for i in range(lo, hi))
    res = _both(manhattan.main, jmanhattan.main, lambda tag: [
        "--pval", f"{run}/se_it_{ITERS}_pval_se.bin", "--probes", probes,
        "--out-name", f"man_{tag}", "--trait", "t", "--M", str(M), "--n-chr", "3"])
    assert res["port"][0] == res["jax"][0]
    assert [ln for ln in res["port"][1] if "saved" not in ln] == \
        [ln for ln in res["jax"][1] if "saved" not in ln]
    assert open(f"{run}/man_port.csv").read() == open(f"{run}/man_jax.csv").read()
    assert os.path.getsize(f"{run}/man_port.png") > 0


def test_profile_dir_writes_a_trace_and_the_same_outputs(tmp_path):
    """--profile-dir on the CPU: one parseable Chrome trace of the inference
    run (rank0.*.pt.trace.json) with the engine's operators in it, and
    every output file the run without the flag writes, byte for byte (the
    trace.jsonl telemetry holds wall times, so its iterations are compared
    without them: without `seconds`, and of `phases` the counted passes
    alone)."""
    d = str(tmp_path)
    sim_main(["--out-dir", d, "--out-name", "ex", "-N", str(N), "-M", str(M), "--seed", "7"])
    for sub in ("plain", "prof"):
        os.makedirs(f"{d}/{sub}")
    _run_cli(d, "plain/r")
    _run_cli(d, "prof/r", "--profile-dir", f"{d}/trace")
    traces = glob.glob(f"{d}/trace/rank0.*.pt.trace.json")
    assert len(traces) == 1 and os.listdir(f"{d}/trace") == [os.path.basename(traces[0])]
    events = json.load(open(traces[0]))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    files = sorted(os.listdir(f"{d}/plain"))
    assert files == sorted(os.listdir(f"{d}/prof")) and len(files) == 3 + 1 + 2 * ITERS
    for f in files:
        a, b = (open(f"{d}/{s}/{f}", "rb").read() for s in ("plain", "prof"))
        if f.endswith("_trace.jsonl"):
            def strip(raw):
                recs = [json.loads(ln) for ln in raw.decode().splitlines()]
                return [{**{k: v for k, v in r.items() if k != "seconds"},
                         "phases": {"passes": r["phases"]["passes"]}} for r in recs]
            a, b = strip(a), strip(b)
        assert a == b, f
