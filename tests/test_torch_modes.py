"""The port's run modes (vampomi_tpu_torch/modes/) and the row-moments kernel's
plain version against the JAX package's modes and an f64 brute force, on
the CPU.

Inputs: a data_sim fixture (N = 300, M = 512) written to files and loaded by
each package's own load_dataset, and estimate / r1 files made from a numpy
seed.  Tolerances, with their reasons:
  * f64 designs: SE p-values are the same numpy/scipy arithmetic (bitwise);
    LOO p-values and test-mode values sum in another order (rtol 1e-9 and
    1e-13: the test CSV keeps JAX's layout byte for byte, but its 15th
    decimal may differ); the `.yhat` text (6 digits) is byte for byte.
  * quantized designs: held against the f64 brute force on the SAME codes
    (the dequantized matrix the operator models): the port's X y_mod is f32
    with y_mod never rounded to bf16, so log10 p agrees to 1e-3 relative;
    JAX's CPU path rounds y_mod to bf16 (association.py:90-105), so the two
    packages agree to ~1e-2 on log10 p.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import linregress

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.dataset import load_dataset as jload
from vampomi_tpu.modes import association as jassoc
from vampomi_tpu.modes.predict import run_predict as jpredict
from vampomi_tpu.modes.test_mode import run_test_linear as jtest_linear
from vampomi_tpu.modes.test_mode import run_test_probit as jtest_probit
from vampomi_tpu.ops import pallas_matvec
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.dataset import load_dataset as tload
from vampomi_tpu_torch.modes import association as tassoc
from vampomi_tpu_torch.modes import test_mode as ttest
from vampomi_tpu_torch.modes.predict import run_predict as tpredict
from vampomi_tpu_torch.ops import operator as top
from vampomi_tpu_torch.ops.moments import (
    row_moments_int8, row_moments_int8_plain, row_moments_packed4, row_moments_packed4_plain,
)
from vampomi_tpu_torch.ops.packed4 import unpack_rows
from vampomi_tpu_torch.sim.data_sim import simulate_iid, write_fixture

torch.set_num_threads(2)

N, M = 300, 512
ITERS = 10  # estimate files: two batches of the port's 8, one of JAX's 16
DTYPES = {"f64": (jnp.float64, torch.float64), "int8": (jnp.int8, torch.int8),
          "int4": (jnp.uint8, torch.uint8)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("modes")
    fx = simulate_iid(n=N, m=M, lam=0.1, h2=0.8, seed=5)
    paths = write_fixture(fx, str(d), "ex")
    rng = np.random.default_rng(17)
    for it in range(1, ITERS + 1):
        est = fx.beta * (it / ITERS) + rng.normal(0.0, 1e-3, M)
        est.astype("<f8").tofile(os.path.join(d, f"w_it_{it}.bin"))
        (fx.beta * 2.0 + rng.normal(0.0, 0.05, M)).astype("<f8").tofile(
            os.path.join(d, f"w_r1_it_{it}.bin"))
    ybin = (fx.X @ fx.beta > 0).astype(float)
    with open(os.path.join(d, "bin.phen"), "w") as f:
        for i, v in enumerate(ybin):
            f.write(f"{i} {i} {v:g}\n")
    return dict(dir=str(d), fx=fx, bin=paths["bin"], phen=paths["phen"],
                binphen=os.path.join(d, "bin.phen"))


def _datasets(files, kind, model="linear", phen=None):
    jd, td = DTYPES[kind]
    phen = phen or files["phen"]
    return (jload(files["bin"], phen, N, M, model, None, jd),
            tload(files["bin"], phen, N, M, model, td, "cpu"))


def _cfgs(files, out, **kw):
    base = dict(out_dir=files["dir"], meth_file="x", N=N, Mt=M, N_test=N, **kw)
    return JConfig(out_name=f"jax_{out}", **base), RunConfig(out_name=f"pt_{out}", **base)


def _dequantized(files, kind):
    """The (N, M) f64 matrix the quantized design models: the codes times
    the scale plus the zero point."""
    X = files["fx"].X.T  # (M, N) marker-major
    if kind == "f64":
        return X.T
    Xq, s, z = top.quantize_markers(X) if kind == "int8" else top.quantize_markers4(X)
    return (s[:, None] * Xq + z[:, None]).T


def _std(X):
    mu = X.mean(axis=0)
    sd = np.sqrt(((X - mu) ** 2).sum(axis=0) / (X.shape[0] - 1))
    return (X - mu) / sd / np.sqrt(X.shape[0])


# ---------------------------------------------------------------------------
# the row-moments kernel's plain version


@pytest.mark.parametrize("shape", [(37, 101), (64, 256), (1, 1), (5, 3), (129, 1000)])
def test_row_moments_plain_are_the_exact_integer_sums(shape):
    m, n = shape
    rng = np.random.default_rng(m + n)
    X = rng.integers(-128, 128, size=(m, n), dtype=np.int8)
    got = row_moments_int8(torch.as_tensor(X)).numpy()
    x = X.astype(np.int64)
    assert got.dtype == np.int64 and got.shape == (m, 2)
    np.testing.assert_array_equal(got[:, 0], x.sum(axis=1))
    np.testing.assert_array_equal(got[:, 1], (x * x).sum(axis=1))
    codes = rng.integers(-8, 8, size=(m, 2 * n), dtype=np.int8)
    got = row_moments_packed4(torch.as_tensor(top.pack_nibbles_host(codes))).numpy()
    c = codes.astype(np.int64)
    np.testing.assert_array_equal(got[:, 0], c.sum(axis=1))
    np.testing.assert_array_equal(got[:, 1], (c * c).sum(axis=1))


def test_row_moments_plain_chunking_does_not_change_the_sums(monkeypatch):
    """A small chunk budget (many chunks, a ragged last one) gives the same
    integers."""
    from vampomi_tpu_torch.ops import atx_int8

    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.integers(-128, 128, size=(301, 77), dtype=np.int8))
    Xp = torch.as_tensor(rng.integers(0, 256, size=(301, 39), dtype=np.uint8))
    want = row_moments_int8_plain(X), row_moments_packed4_plain(Xp)
    monkeypatch.setattr(atx_int8, "PLAIN_CHUNK_BYTES", 77 * 8 * 7)
    assert torch.equal(row_moments_int8_plain(X), want[0])
    assert torch.equal(row_moments_packed4_plain(Xp), want[1])


def test_loo_takes_an_int8_design_past_the_int32_sums():
    """An int8 design of N = 140,000 samples with codes of ±127: its sums of
    squares (2.26e9) leave int32.  The LOO statistics are the exact integer
    sums and the p-values lie in [0, 1]."""
    from vampomi_tpu_torch.dataset import Dataset
    from vampomi_tpu_torch.io.phen import Phenotype

    rng = np.random.default_rng(9)
    n, m = 140_000, 3
    X = np.sign(rng.normal(size=(m, n)))
    qinfo = {}
    dm = top.build_design(X, compute_dtype=torch.int8, device="cpu", quant_out=qinfo)
    y = X[0] * 0.3 + rng.normal(size=n)
    sumx, sumsqx, xy = tassoc._loo_stats(dm, y)
    q = dm.X.numpy().astype(np.int64)
    np.testing.assert_array_equal(sumx, q.sum(axis=1))
    np.testing.assert_array_equal(sumsqx, (q * q).sum(axis=1))
    assert sumsqx.min() > 2**31
    ds = Dataset(dm=dm, phen=Phenotype(y=y, intercept=0.0, scale=1.0), covariates=None,
                 qscale=qinfo["scale"])
    for standardized in (False, True):
        p = tassoc.pvals_loo(ds, np.zeros(m), standardized=standardized)
        assert p.shape == (m,) and np.all((p >= 0) & (p <= 1)) and p[0] < 1e-12


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_row_moments_match_jax_loo_sums(files, kind):
    """The code sums of JAX's _loo_stats (f32 sums, exact at N = 300) equal
    the port's int64 moments of the same codes."""
    jds, tds = _datasets(files, kind)
    y = np.random.default_rng(2).normal(size=N)
    jsx, jsq, _ = (np.asarray(a) for a in jassoc._loo_stats(jds.dm, jnp.asarray(y)))
    mom = (row_moments_int8 if kind == "int8" else row_moments_packed4)(tds.dm.X).numpy()
    np.testing.assert_array_equal(mom[:, 0], jsx)
    np.testing.assert_array_equal(mom[:, 1], jsq)


def test_row_moments_wrappers_refuse_what_the_kernel_does_not_take():
    """Wrong dtypes and layouts raise; long rows do not (the sums are int64)."""
    assert row_moments_int8(torch.zeros((1, 131072), dtype=torch.int8)).tolist() == [[0, 0]]
    with pytest.raises(TypeError, match="int8"):
        row_moments_int8(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        row_moments_packed4(torch.zeros((2, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        row_moments_packed4(torch.zeros((4, 4), dtype=torch.uint8).T)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_loo_stats_xy_matches_the_interpreted_kernel(files, kind):
    """X y_mod of a quantized design against the JAX Pallas kernel in the
    interpreter (f32 products, y never rounded) and the exact f64 product."""
    _, tds = _datasets(files, kind)
    y = np.random.default_rng(3).normal(size=N)
    _, _, xy = tassoc._loo_stats(tds.dm, y)
    X = tds.dm.X.numpy()
    raw = pallas_matvec.atx_int8_raw if kind == "int8" else pallas_matvec.atx_packed4_raw
    tm = pallas_matvec.pick_tile(*X.shape)
    want = np.asarray(raw(jnp.asarray(X), jnp.asarray(y, dtype=jnp.float32), tm,
                          interpret=True))
    C = X.astype(np.float64) if kind == "int8" else unpack_rows(
        torch.as_tensor(X), torch.float64).numpy()
    scale = np.abs(C) @ np.abs(y.astype(np.float32).astype(np.float64))
    assert np.max(np.abs(xy - want) / scale) < 1e-6
    assert np.max(np.abs(xy - C @ y.astype(np.float32).astype(np.float64)) / scale) < 1e-6


# ---------------------------------------------------------------------------
# association_test


def test_load_dataset_keeps_the_dequantization_scale(files):
    qinfo = {}
    top.build_design(files["fx"].X.T, compute_dtype=torch.int8, quant_out=qinfo)
    _, tds = _datasets(files, "int8")
    np.testing.assert_array_equal(tds.qscale, qinfo["scale"])
    assert _datasets(files, "f64")[1].qscale is None
    assert _datasets(files, "int4")[1].qscale.shape == (M,)


def test_packed_design_needs_an_even_sample_count(files):
    with pytest.raises(ValueError, match="even sample count"):
        tload(files["bin"], files["phen"], N - 1, M, "linear", torch.uint8, "cpu")


def test_pvals_se_file_is_jax_byte_for_byte(files):
    jds, tds = _datasets(files, "f64")
    r1 = os.path.join(files["dir"], "w_r1_it_7.bin")
    jc, tc = _cfgs(files, "se", pval_method="se", r1_file=r1, gam1=2.0)
    want = jassoc.run_association_test(jds, jc)
    got = tassoc.run_association_test(tds, tc)
    np.testing.assert_array_equal(got, want)
    a = open(os.path.join(files["dir"], "pt_se_it_7_pval_se.bin"), "rb").read()
    assert a == open(os.path.join(files["dir"], "jax_se_it_7_pval_se.bin"), "rb").read()
    assert len(a) == 8 * M


def _brute_loo(files, kind, x1_up, standardized):
    """Per-marker scipy regressions of y_mod + (add-back) on the marker, in
    f64 on the matrix the design models (tests/test_modes.py:73-175)."""
    X = _dequantized(files, kind)
    A = _std(X)
    y = _datasets(files, "f64")[1].phen.y
    y_mod = y - A @ x1_up
    out = np.empty(M)
    for j in range(M):
        add = A[:, j] * x1_up[j] if standardized else X[:, j] / np.sqrt(N) * x1_up[j]
        out[j] = linregress(X[:, j], y_mod + add).pvalue
    return out


@pytest.mark.parametrize("kind", ["f64", "int8", "int4"])
@pytest.mark.parametrize("method", ["loo", "loo_std"])
def test_loo_pvals_match_brute_force_and_jax(files, kind, method):
    jds, tds = _datasets(files, kind)
    est = os.path.join(files["dir"], "w_it_10.bin")
    jc, tc = _cfgs(files, f"{kind}_{method}", pval_method=method, estimate_file=est)
    got = tassoc.run_association_test(tds, tc)
    want = jassoc.run_association_test(jds, jc)
    stored = np.fromfile(os.path.join(files["dir"], f"pt_{kind}_{method}_it_10_pval_{method}.bin"))
    np.testing.assert_array_equal(stored, got)
    x1_up = np.fromfile(est) * np.sqrt(N)
    brute = _brute_loo(files, kind, x1_up, method == "loo_std")
    lg, lb, lw = (np.log10(p + 1e-300) for p in (got, brute, want))
    if kind == "f64":
        np.testing.assert_allclose(got, brute, rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-14)
    else:
        np.testing.assert_allclose(lg, lb, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(lg, lw, rtol=2e-2, atol=2e-2)
    assert (got[files["fx"].beta != 0] < 0.05 / M).sum() > 0


def test_loo_quirk_on_a_quantized_design_needs_the_scale(files):
    _, tds = _datasets(files, "int8")
    x1_up = files["fx"].beta * np.sqrt(N)
    with pytest.raises(ValueError, match="dequantization scale"):
        tassoc.pvals_loo(tds._replace(qscale=None), x1_up)
    assert np.all(np.isfinite(tassoc.pvals_loo(tds._replace(qscale=None), x1_up,
                                               standardized=True)))


# ---------------------------------------------------------------------------
# test and predict


@pytest.mark.parametrize("kind", ["f64", "int8", "int4"])
def test_test_mode_csv_matches_jax(files, kind):
    """Ten estimates (two passes of 8 in the port, one of 16 in JAX): the
    same header, positional layout and field widths; f64 values to rtol
    1e-13 (the two packages' f64 products sum in other orders, so the 15th
    decimal of "%20.15f" may differ); quantized values against the f64
    brute force on the same codes."""
    jds, tds = _datasets(files, kind)
    est = os.path.join(files["dir"], "w_it_1.bin")
    jc, tc = _cfgs(files, f"test_{kind}", estimate_file=est, test_iter_range=[1, ITERS])
    want = jtest_linear(jds, jc)
    got = ttest.run_test_linear(tds, tc)
    a = open(os.path.join(files["dir"], f"pt_test_{kind}_test.csv"), "rb").read()
    b = open(os.path.join(files["dir"], f"jax_test_{kind}_test.csv"), "rb").read()
    assert len(got) == len(want) == ITERS
    assert len(a) == len(b) and a.split(b"\n")[0] == b.split(b"\n")[0]
    assert [i for i, c in enumerate(a) if c in b",\n\0"] == \
        [i for i, c in enumerate(b) if c in b",\n\0"]
    if kind == "f64":
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)
        return
    A = _std(_dequantized(files, kind))
    y = tds.phen.y
    for it, row in zip(range(1, ITERS + 1), got):
        z = A @ (np.fromfile(os.path.join(files["dir"], f"w_it_{it}.bin")) * np.sqrt(N))
        r2 = 1.0 - np.sum((y - z) ** 2) / (np.var(y, ddof=1) * N)
        c2 = np.dot(z, y) ** 2 / (np.dot(z, z) * np.dot(y, y))
        np.testing.assert_allclose(row, [r2, c2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("kind", ["f64", "int8", "int4"])
def test_a_column_does_not_depend_on_its_batch(files, kind):
    """An estimate's z is the same whichever batch it rides in (batches of
    1, 3 and 8): bitwise for f64, within f32 rounding (1e-6 of the largest
    |z|) for the quantized plain versions."""
    _, tds = _datasets(files, kind)
    _, tc = _cfgs(files, "batch", estimate_file=os.path.join(files["dir"], "w_it_1.bin"),
                  test_iter_range=[1, ITERS])
    runs = [dict(ttest._collect_predictions(tds, tc, chunk=c)) for c in (1, 3, ttest.CHUNK)]
    assert ttest.CHUNK == 8
    for other in runs[1:]:
        for it in range(1, ITERS + 1):
            if kind == "f64":
                np.testing.assert_array_equal(other[it], runs[0][it])
            else:
                np.testing.assert_allclose(other[it], runs[0][it], rtol=0,
                                           atol=1e-6 * np.abs(runs[0][it]).max())


def test_test_mode_probit_csv_matches_jax(files):
    """The probit confusion rows, and no header row (read raw: the port's
    read_positional_csv would drop line 0)."""
    jds, tds = _datasets(files, "f64", model="bin_class", phen=files["binphen"])
    est = os.path.join(files["dir"], "w_it_1.bin")
    jc, tc = _cfgs(files, "probit", model="bin_class", estimate_file=est,
                   test_iter_range=[1, ITERS])
    want = jtest_probit(jds, jc)
    got = ttest.run_test_probit(tds, tc)
    assert got == want
    a = open(os.path.join(files["dir"], "pt_probit_test.csv"), "rb").read()
    assert a == open(os.path.join(files["dir"], "jax_probit_test.csv"), "rb").read()
    lines = [ln for ln in a.replace(b"\0", b"").decode().splitlines() if ln.strip()]
    assert len(lines) == ITERS and not lines[0].startswith("iteration")
    assert int(lines[-1].split(",")[0]) == ITERS


@pytest.mark.parametrize("kind", ["f64", "int8", "int4"])
def test_predict_yhat_matches_jax(files, kind, tmp_path):
    """`{v:g}` lines to <prefix>.yhat: byte for byte for f64; quantized
    values within the text's 6 digits of the f64 brute force."""
    jds, tds = _datasets(files, kind)
    outs = {}
    for who, ds, Cfg, run in (("jax", jds, JConfig, jpredict), ("pt", tds, RunConfig, tpredict)):
        d = tmp_path / who
        d.mkdir()
        est = d / "p_it_3.bin"
        np.fromfile(os.path.join(files["dir"], "w_it_10.bin")).astype("<f8").tofile(est)
        run(ds, Cfg(out_dir=str(d), out_name="p", N_test=N, Mt=M, estimate_file=str(est),
                    meth_file="x"))
        outs[who] = (d / "p_.yhat").read_bytes()
    lines = outs["pt"].decode().splitlines()
    assert len(lines) == N
    if kind == "f64":
        assert outs["pt"] == outs["jax"]
        return
    z = _std(_dequantized(files, kind)) @ (
        np.fromfile(os.path.join(files["dir"], "w_it_10.bin")) * np.sqrt(N))
    np.testing.assert_allclose([float(v) for v in lines], z, rtol=1e-4, atol=1e-5)


def test_predict_needs_an_iteration_tag(files):
    _, tds = _datasets(files, "f64")
    with pytest.raises(SystemExit, match="it_<k>"):
        tpredict(tds, RunConfig(N_test=N, Mt=M, estimate_file="/no/tag.bin"))


def test_unknown_pval_method_raises(files):
    _, tds = _datasets(files, "f64")
    cfg = dataclasses.replace(RunConfig(out_dir=files["dir"], out_name="x", N=N, Mt=M),
                              pval_method="bogus")
    with pytest.raises(ValueError, match="unknown pval method"):
        tassoc.run_association_test(tds, cfg)
