"""The port's packed-int4 design (`--compute-dtype int4`) against the JAX
package on the CPU: the quantizer and the nibble layout, the plain versions
of the three packed kernels against the TPU kernels in the Pallas
interpreter, the operator, the Gram, whole engine trajectories and the CLI.

Inputs are made from a seed with numpy.  Two references throughout:
  * the JAX package (vampomi_tpu/ops/operator.py, pallas_matvec.py): its
    interpret-mode kernels multiply in f32 like the port (relative
    tolerance ~1e-5: f32 sums in another order), while its CPU operator and
    engine take the unpack-einsum route that rounds vectors to bf16
    (tolerances of the int8 tests in test_torch_engine_linear.py);
  * the port's own int8 design holding the same codes and vectors: packing
    is storage, so the two agree to f32 rounding."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.engine import linear as jlin
from vampomi_tpu.ops import operator as jop
from vampomi_tpu.ops import pallas_matvec
from vampomi_tpu.ops import spectral as jspec
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.cli import main as tcli_main
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.io.bin_io import read_bin_slab
from vampomi_tpu_torch.io.csv_writer import read_positional_csv
from vampomi_tpu_torch.ops import operator as top
from vampomi_tpu_torch.ops import spectral as tspec
from vampomi_tpu_torch.ops.broadcast import ax_batch_packed4, ax_batch_packed4_plain
from vampomi_tpu_torch.ops.packed4 import (
    atx_batch_packed4, atx_batch_packed4_plain, atx_packed4, atx_packed4_plain, unpack_nibbles,
    unpack_rows,
)
from vampomi_tpu_torch.sim.data_sim import main as sim_main
from vampomi_tpu_torch.sim.data_sim import simulate_iid

from tests.test_torch_engine_linear import _jax_engine_probes, cfg_kw

torch.set_num_threads(2)

U8 = top.PACKED4_DTYPE


def _arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def fx():
    return simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42)


@pytest.fixture(scope="module")
def pair4(fx):
    """The JAX packed design and its carry into the port."""
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jop.PACKED4_DTYPE)
    return jdm, convert.design_from_arrays(_arrays(jdm))


def _same_codes_int8(dm4):
    """The port's int8 design over the same codes and vectors as dm4."""
    return dm4._replace(X=unpack_rows(dm4.X, torch.int8).contiguous())


def _rel_to_magnitudes(got, want, absA, absv):
    """max |got - want| / (|A| |v|): error relative to the sum of magnitudes."""
    return float(np.max(np.abs(got - want) / np.maximum(absA @ absv, 1e-30)))


# --------------------------------------------------------------- quantizer


@pytest.mark.parametrize("shape", [(500, 300), (64, 2), (7, 130)])
def test_quantize_and_pack_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    X = rng.uniform(0.0, 1.0, size=shape) * rng.uniform(0.1, 3.0, size=(shape[0], 1))
    X[0] = 0.37  # a constant marker: codes exactly 0, scale 1
    Xq, s, z = top.quantize_markers4(X)
    jq, js, jz = jop.quantize_markers4(X)
    np.testing.assert_array_equal(Xq, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(z, jz)
    assert Xq.min() >= -8 and Xq.max() <= 7 and not Xq[0].any()
    packed = top.pack_nibbles_host(Xq)
    np.testing.assert_array_equal(packed, jop.pack_nibbles_host(jq))
    assert packed.dtype == np.uint8 and packed.shape == (shape[0], shape[1] // 2)
    lo, hi = unpack_nibbles(torch.as_tensor(packed), torch.int8)
    jlo, jhi = jop.unpack_nibbles(jnp.asarray(packed), dtype=jnp.int8)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(unpack_rows(torch.as_tensor(packed), torch.int8).numpy(), Xq)


def test_odd_sample_count_refuses():
    codes = np.zeros((4, 9), dtype=np.int8)
    with pytest.raises(ValueError, match="even sample count"):
        top.pack_nibbles_host(codes)
    with pytest.raises(ValueError, match="even sample count"):
        top.build_design(np.random.default_rng(0).normal(size=(4, 9)), compute_dtype=U8)


# ------------------------------------------- plain kernels vs Pallas interpret


def _packed_inputs(m, n2, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-8, 8, size=(m, 2 * n2), dtype=np.int8)
    return codes, top.pack_nibbles_host(codes), rng


@pytest.mark.parametrize("shape", [(128, 128), (96, 192)])
def test_atx_packed4_plain_matches_pallas_interpret(shape):
    m, n2 = shape
    codes, Xp, rng = _packed_inputs(m, n2, 0)
    y = rng.normal(size=2 * n2).astype(np.float32)
    tm = pallas_matvec.pick_tile(m, n2)
    want = np.asarray(pallas_matvec.atx_packed4_raw(jnp.asarray(Xp), jnp.asarray(y), tm,
                                                    interpret=True))
    got = atx_packed4_plain(torch.as_tensor(Xp), torch.as_tensor(y)).numpy()
    exact = codes.astype(np.float64) @ y.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert _rel_to_magnitudes(got, exact, np.abs(codes), np.abs(y)) < 1e-6


@pytest.mark.parametrize("k", [1, 2, 3])
def test_ax_batch_packed4_plain_matches_pallas_interpret(k):
    m, n2 = 128, 128
    codes, Xp, rng = _packed_inputs(m, n2, k)
    W = rng.normal(size=(m, k)).astype(np.float32)
    tm = pallas_matvec.pick_tile(m, n2)
    want = np.asarray(pallas_matvec.ax_batch_packed4_raw(jnp.asarray(Xp), jnp.asarray(W),
                                                         (tm, k), interpret=True))
    got = ax_batch_packed4_plain(torch.as_tensor(Xp), torch.as_tensor(W)).numpy()
    assert got.shape == want.shape == (2 * n2, k)
    exact = codes.T.astype(np.float64) @ W.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert _rel_to_magnitudes(got, exact, np.abs(codes.T), np.abs(W)) < 1e-6


@pytest.mark.parametrize("k", [1, 2, 3])
def test_atx_batch_packed4_plain_matches_pallas_interpret(k):
    m, n2 = 96, 192
    codes, Xp, rng = _packed_inputs(m, n2, 10 + k)
    Ys = rng.normal(size=(2 * n2, k)).astype(np.float32)
    tm = pallas_matvec.pick_tile(m, n2)
    want = np.asarray(pallas_matvec.atx_batch_packed4_raw(jnp.asarray(Xp), jnp.asarray(Ys),
                                                          (tm, k), interpret=True))
    got = atx_batch_packed4_plain(torch.as_tensor(Xp), torch.as_tensor(Ys)).numpy()
    assert got.shape == want.shape == (m, k)
    exact = codes.astype(np.float64) @ Ys.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert _rel_to_magnitudes(got, exact, np.abs(codes), np.abs(Ys)) < 1e-6


@pytest.mark.parametrize("shape", [(1001, 50), (7, 1), (1, 33)])
def test_packed_wrappers_ragged_shapes_on_cpu(shape):
    """Shapes the TPU gate refuses (no tile divides M) run: the CPU wrappers
    take the plain versions and count no kernel launch."""
    m, n2 = shape
    assert pallas_matvec.pick_tile(m, n2) is None or m < 8
    codes, Xp, rng = _packed_inputs(m, n2, 20)
    c64 = codes.astype(np.float64)
    X = torch.as_tensor(Xp)
    y = rng.normal(size=2 * n2).astype(np.float32)
    Ys = rng.normal(size=(2 * n2, 2)).astype(np.float32)
    W = rng.normal(size=(m, 2)).astype(np.float32)
    before = (atx_packed4.launches, atx_batch_packed4.launches, ax_batch_packed4.launches)
    v = atx_packed4(X, torch.as_tensor(y)).numpy()
    Y = atx_batch_packed4(X, torch.as_tensor(Ys)).numpy()
    Z = ax_batch_packed4(X, torch.as_tensor(W)).numpy()
    assert (atx_packed4.launches, atx_batch_packed4.launches, ax_batch_packed4.launches) == before
    assert _rel_to_magnitudes(v, c64 @ y, np.abs(c64), np.abs(y)) < 1e-6
    assert _rel_to_magnitudes(Y, c64 @ Ys, np.abs(c64), np.abs(Ys)) < 1e-6
    assert _rel_to_magnitudes(Z, c64.T @ W, np.abs(c64.T), np.abs(W)) < 1e-6


BAD = {
    "dtype_X": (lambda X, V: (X.to(torch.int8), V), TypeError),
    "dtype_V": (lambda X, V: (X, V.double()), TypeError),
    "rows": (lambda X, V: (X, V[:-1]), ValueError),
    "k_above_8": (lambda X, V: (X, torch.zeros((V.shape[0], 9))), ValueError),
    "k_zero": (lambda X, V: (X, V[:, :0]), ValueError),
    "non_contiguous_X": (lambda X, V: (X.t(), V), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
@pytest.mark.parametrize("fn", ["atx_batch_packed4", "ax_batch_packed4"])
def test_packed_wrappers_reject_bad_input(case, fn):
    X = torch.zeros((8, 8), dtype=torch.uint8)
    rows = 16 if fn == "atx_batch_packed4" else 8
    V = torch.zeros((rows, 2), dtype=torch.float32)
    Xb, Vb = BAD[case][0](X, V)
    with pytest.raises(BAD[case][1]):
        {"atx_batch_packed4": atx_batch_packed4, "ax_batch_packed4": ax_batch_packed4}[fn](Xb, Vb)


# ----------------------------------------------------------------- operator


def test_build_design_int4_matches_jax(fx, pair4):
    jdm, _ = pair4
    qo = {}
    tdm = top.build_design(fx.X.T, compute_dtype=U8, device="cpu", quant_out=qo)
    assert tdm.X.dtype == torch.uint8 and tuple(tdm.X.shape) == (500, 150)
    np.testing.assert_array_equal(tdm.X.numpy(), np.asarray(jdm.X))
    np.testing.assert_array_equal(tdm.mave.numpy(), np.asarray(jdm.mave))
    np.testing.assert_array_equal(tdm.msig.numpy(), np.asarray(jdm.msig))
    assert tdm.wd == torch.float32 and tdm.n == 300.0 and tdm.mt == 500.0
    _, s, z = jop.quantize_markers4(fx.X.T)
    np.testing.assert_array_equal(qo["scale"], s)
    np.testing.assert_array_equal(qo["zero"], z)


def test_design_from_packed_matches_host_stats():
    codes, Xp, _ = _packed_inputs(200, 75, 7)
    codes[3] = 2  # a constant marker gets msig = 1
    Xp = top.pack_nibbles_host(codes)
    dm = top.design_from_packed(torch.as_tensor(Xp))
    mave, msig = top.dequantized_stats(codes, np.ones(200), np.zeros(200), 1.0)
    assert dm.n == 150.0 and dm.mt == 200.0 and dm.X.dtype == torch.uint8
    np.testing.assert_allclose(dm.mave.numpy(), mave.astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(dm.msig.numpy(), msig.astype(np.float32), rtol=1e-6)
    assert dm.msig[3].item() == 1.0
    with pytest.raises(ValueError, match="uint8"):
        top.design_from_packed(torch.as_tensor(codes))


OPS = {
    "ax": lambda mod, dm, v: mod.ax(dm, v["x"]),
    "atx": lambda mod, dm, v: mod.atx(dm, v["y"]),
    "ax_batch": lambda mod, dm, v: mod.ax_batch(dm, v["xs"]),
    "atx_batch": lambda mod, dm, v: mod.atx_batch(dm, v["ys"]),
    "normal_eq_mult": lambda mod, dm, v: mod.normal_eq_mult(dm, v["xs"], 2.5, 0.7),
}


def _vals(m, n, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=m), y=rng.normal(size=n),
                xs=rng.normal(size=(m, 2)), ys=rng.normal(size=(n, 2)))


@pytest.mark.parametrize("op", list(OPS))
def test_operator_products_int4_match_jax_and_same_codes(pair4, op):
    """Against the JAX packed operator (bf16-rounded vectors on the CPU:
    relative error ~4e-3 of a product's norm) and, to f32 rounding, against
    the port's int8 design over the same codes."""
    jdm, tdm = pair4
    vals = _vals(tdm.m_pad, int(tdm.n), 3)
    tv = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in vals.items()}
    got = OPS[op](top, tdm, tv).numpy()
    want = np.asarray(OPS[op](jop, jdm, {k: jnp.asarray(v, dtype=jnp.float32)
                                         for k, v in vals.items()}))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2
    same = OPS[op](top, _same_codes_int8(tdm), tv).numpy()
    np.testing.assert_allclose(got, same, rtol=1e-5, atol=1e-5 * np.abs(same).max())


def test_gram_int4_matches_same_codes_and_jax(pair4):
    jdm, tdm = pair4
    K4 = tspec.gram(tdm).numpy().astype(np.float64)
    K8 = tspec.gram(_same_codes_int8(tdm)).numpy().astype(np.float64)
    np.testing.assert_allclose(K4, K8, rtol=1e-5, atol=1e-6 * np.abs(K8).max())
    # JAX weights one side in bf16 (spectral.py:111-133)
    Kj = np.asarray(jspec.gram(jdm), dtype=np.float64)
    assert np.linalg.norm(K4 - Kj) / np.linalg.norm(Kj) < 1e-2
    # and the f64 product of the codes the design holds
    c = unpack_rows(tdm.X, torch.float64).numpy()
    A = (c - tdm.mave.double().numpy()[:, None]) * tdm.msig.double().numpy()[:, None]
    K = A.T @ A / tdm.n
    np.testing.assert_allclose(K4, K, rtol=1e-4, atol=1e-5 * np.abs(K).max())


def test_gram_int4_block_boundary(pair4):
    _, tdm = pair4
    np.testing.assert_allclose(tspec.gram(tdm, block=37).numpy(), tspec.gram(tdm).numpy(),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- engine


@pytest.mark.parametrize("solver", ["eigen", "cg"])
def test_int4_engine_matches_jax_int4_and_same_codes(fx, tmp_path, monkeypatch, solver):
    """The int4 trajectory against the JAX int4 engine (CG with the JAX
    engine's probes replayed into the port; bf16 tolerance, as the int8 test)
    and, tightly, against the port's run on the int8 design over the same
    codes (the same probes: both draw from the port's seeded generator)."""
    kw = cfg_kw(tmp_path, iterations=4, lmmse_solver=solver)
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jop.PACKED4_DTYPE)
    jres = jlin.infere_linear(jdm, fx.y, JConfig(**kw), true_signal=fx.beta,
                              write_outputs=False)
    tdm = top.build_design(fx.X.T, compute_dtype=U8, device="cpu")
    assert tdm.X.dtype == torch.uint8
    res8 = tlin.infere_linear(_same_codes_int8(tdm), fx.y, RunConfig(**kw, device="cpu"),
                              true_signal=fx.beta, write_outputs=False)
    res4 = tlin.infere_linear(tdm, fx.y, RunConfig(**kw, device="cpu"),
                              true_signal=fx.beta, write_outputs=False)
    got, same = np.asarray(res4.metrics_history), np.asarray(res8.metrics_history)
    assert np.all(np.isfinite(got)) and got.shape == same.shape == (4, 6)
    np.testing.assert_allclose(got, same, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res4.x1_hat_scaled, res8.x1_hat_scaled, rtol=1e-4,
                               atol=1e-5 * np.abs(res8.x1_hat_scaled).max())

    feed = iter(_jax_engine_probes(kw["seed"], 4, fx.X.shape[1], jnp.float32))
    monkeypatch.setattr(tlin, "_draw_probe", lambda gen, dm: next(feed))
    resj = tlin.infere_linear(tdm, fx.y, RunConfig(**kw, device="cpu"),
                              true_signal=fx.beta, write_outputs=False)
    got = np.asarray(resj.metrics_history)
    want = np.asarray(jres.metrics_history)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(resj.gamw, jres.gamw, rtol=2e-2)
    np.testing.assert_allclose(resj.x1_hat_scaled, jres.x1_hat_scaled,
                               atol=2e-2 * np.abs(jres.x1_hat_scaled).max())
    c_t = np.corrcoef(resj.x1_hat_scaled, fx.beta)[0, 1]
    c_j = np.corrcoef(jres.x1_hat_scaled, fx.beta)[0, 1]
    assert abs(c_t - c_j) < 1e-2 and c_t > 0.7


def test_int4_trace_counts_half_a_byte_per_element(fx, tmp_path):
    import json

    tdm = top.build_design(fx.X.T, compute_dtype=U8, device="cpu")
    cfg = RunConfig(**cfg_kw(tmp_path, iterations=1, lmmse_solver="eigen", device="cpu"))
    tlin.infere_linear(tdm, fx.y, cfg, true_signal=fx.beta)
    rec = json.loads(open(os.path.join(tmp_path, "t_trace.jsonl")).readline())
    # two passes over M x N elements at 0.5 byte each
    assert rec["bytes_moved"] == pytest.approx(2 * 500 * 300 * 0.5)


# ---------------------------------------------------------------------- CLI


@pytest.mark.parametrize("solver", ["eigen", "cg"])
def test_cli_int4_through_files(tmp_path, solver):
    n, m, iters = 200, 256, 8
    d = str(tmp_path)
    sim_main(["--out-dir", d, "--out-name", "example", "-N", str(n), "-M", str(m),
              "--seed", "11"])
    out = f"i4_{solver}"
    argv = ["--run-mode", "infere", "--model", "linear",
            "--meth-file", f"{d}/example.bin", "--phen-file", f"{d}/example.phen",
            "--true-signal-file", f"{d}/example_ts.bin", "--N", str(n), "--Mt", str(m),
            "--out-dir", d, "--out-name", out, "--iterations", str(iters), "--h2", "0.8",
            "--probs", "0.9,0.07,0.03", "--vars", "0.0,0.001,0.01", "--stop-criteria-thr", "0",
            "--lmmse-solver", solver, "--compute-dtype", "int4", "--device", "cpu"]
    assert tcli_main(argv) == 0
    want = {f"{out}_{s}.csv" for s in ("metrics", "params", "prior")} | {f"{out}_trace.jsonl"}
    want |= {f"{out}_{k}it_{i}.bin" for k in ("", "r1_") for i in range(1, iters + 1)}
    have = {f for f in os.listdir(d) if f.startswith(out + "_")}
    assert have == want
    for f in want:
        if f.endswith(".bin"):
            assert np.all(np.isfinite(read_bin_slab(os.path.join(d, f), m)))
    x1c = [r[2] for r in read_positional_csv(os.path.join(d, f"{out}_metrics.csv"))]
    assert x1c[-1] > x1c[0] and x1c[-1] > 0.8
