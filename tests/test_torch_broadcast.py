"""The int8 broadcast pass Z = X^T W (ops/broadcast.py ax_batch_int8), behind
the int8 `ax` and `ax_batch`, on the CPU: its plain version against the
exact f64 product, the operator against the JAX int8 operator, and the
wrapper's contract.  Inputs are made from a seed with numpy.

The TPU kernel it ports, `ax2_i8_pallas` (tools/r4_probe.py:77-103), has no
interpret flag and tools/ is a probe script, so it is not called here: the
exact f64 product is the sharp reference, and the JAX operator (which
rounds w to bf16 on the CPU, vampomi_tpu/ops/operator.py:186-197) is held
at the bf16 tolerance of test_torch_engine_linear.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.ops import operator as jop
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.ops import atx_int8 as atx_mod
from vampomi_tpu_torch.ops import operator as top
from vampomi_tpu_torch.ops.broadcast import ax_batch_int8, ax_batch_int8_plain
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)


def _rel(got, want, scale):
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))


@pytest.mark.parametrize("shape", [(300, 500), (1000, 1001), (7, 1), (1, 33), (64, 16)])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_ax_batch_int8_plain_matches_exact(shape, k):
    """f32 products of exact int8 -> f32 codes and f32 weights, summed in f32:
    relative to sum |x||w| the error stays below 1e-6."""
    m, n = shape
    rng = np.random.default_rng(m * 10 + k)
    Xq = rng.integers(-127, 128, size=(m, n), dtype=np.int8)
    W = rng.normal(size=(m, k)).astype(np.float32)
    before = ax_batch_int8.launches
    got = ax_batch_int8(torch.as_tensor(Xq), torch.as_tensor(W)).numpy()
    assert ax_batch_int8.launches == before  # the CPU runs the plain version
    assert got.shape == (n, k) and got.dtype == np.float32
    X64, W64 = Xq.astype(np.float64), W.astype(np.float64)
    assert _rel(got, X64.T @ W64, np.abs(X64.T) @ np.abs(W64)) < 1e-6


def test_ax_batch_int8_chunk_boundary(monkeypatch):
    """The same sum when the row-chunk budget splits X into many ragged
    chunks."""
    rng = np.random.default_rng(9)
    X = torch.as_tensor(rng.integers(-127, 128, size=(500, 300), dtype=np.int8))
    W = torch.as_tensor(rng.normal(size=(500, 2)).astype(np.float32))
    whole = ax_batch_int8_plain(X, W)
    monkeypatch.setattr(atx_mod, "PLAIN_CHUNK_BYTES", 4 * 300 * 37)
    split = ax_batch_int8_plain(X, W)
    scale = X.double().abs().T @ W.double().abs()
    assert _rel(split.numpy(), whole.numpy(), scale.numpy()) < 1e-6


@pytest.fixture(scope="module")
def pair8():
    raw = simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42).X.T
    jdm = jop.build_design(raw, mesh=None, compute_dtype=jnp.int8)
    return jdm, convert.design_from_arrays({k: np.asarray(v) for k, v in jdm._asdict().items()})


@pytest.mark.parametrize("k", [1, 2, 3])
def test_int8_ax_batch_matches_jax_operator(pair8, k):
    """The port's int8 ax_batch (through ax_batch_int8) against JAX
    operator.ax_batch on the same design: JAX rounds w to bf16, so they
    agree to ~4e-3 of the product's norm; against the exact f64 operator
    the port agrees to f32 rounding."""
    jdm, tdm = pair8
    rng = np.random.default_rng(k)
    xs = rng.normal(size=(tdm.m_pad, k)).astype(np.float32)
    got = top.ax_batch(tdm, torch.as_tensor(xs)).numpy()
    want = np.asarray(jop.ax_batch(jdm, jnp.asarray(xs)))
    assert got.shape == want.shape == (300, k)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())
    A = ((tdm.X.double() - tdm.mave.double()[:, None]) * tdm.msig.double()[:, None]
         * tdm.inv_sqrt_n.double()).numpy()
    exact = A.T @ xs.astype(np.float64)
    assert _rel(got, exact, np.abs(A.T) @ np.abs(xs.astype(np.float64))) < 1e-6


def test_int8_ax_is_the_k1_broadcast(pair8):
    """int8 `ax` is the K = 1 case of ax_batch (one kernel for both on a
    card), and matches JAX operator.ax at the bf16 tolerance."""
    jdm, tdm = pair8
    x = np.random.default_rng(4).normal(size=tdm.m_pad).astype(np.float32)
    got = top.ax(tdm, torch.as_tensor(x)).numpy()
    col = top.ax_batch(tdm, torch.as_tensor(x[:, None])).numpy()[:, 0]
    np.testing.assert_array_equal(got, col)
    want = np.asarray(jop.ax(jdm, jnp.asarray(x)))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2


BAD = {
    "dtype_X": (lambda X, W: (X.to(torch.uint8), W), TypeError),
    "dtype_W": (lambda X, W: (X, W.double()), TypeError),
    "rows": (lambda X, W: (X, W[:-1]), ValueError),
    "rank": (lambda X, W: (X, W[:, 0]), ValueError),
    "k_above_8": (lambda X, W: (X, torch.zeros((X.shape[0], 9))), ValueError),
    "non_contiguous_W": (lambda X, W: (X, torch.zeros((3, X.shape[0])).T), ValueError),
    "empty_X": (lambda X, W: (X[:0], W[:0]), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_ax_batch_int8_rejects_bad_input(case):
    X = torch.zeros((8, 16), dtype=torch.int8)
    W = torch.zeros((8, 2), dtype=torch.float32)
    Xb, Wb = BAD[case][0](X, W)
    with pytest.raises(BAD[case][1]):
        ax_batch_int8(Xb, Wb)



def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """A library is named by a hash of its source and every header it
    includes, transitively: editing a header rebuilds instead of loading a
    stale library."""
    from vampomi_tpu_torch.ops import _build

    real = {n: {p.name for p in _build.sources(n)} for n in
            ("atx_int8", "ax_batch_int8", "ax_batch_packed4", "atx_packed4", "atx_batch_packed4",
             "atx_batch_int8", "stream", "atx_mxu", "ax_mxu", "ax2_packed4_mxu", "row_moments")}
    assert real["ax_batch_int8"] == {"ax_batch_int8.cu", "xtw.cuh", "codes.cuh"}
    assert real["row_moments"] == {"row_moments.cu", "codes.cuh"}
    for name in ("atx_batch_packed4", "atx_batch_int8", "atx_packed4"):
        assert real[name] == {f"{name}.cu", "xy.cuh", "codes.cuh"}
    assert real["atx_int8"] == {"atx_int8.cu"}
    assert real["stream"] == {"stream.cu"}
    assert real["atx_mxu"] == {"atx_mxu.cu", "mma_bf16.cuh", "codes.cuh"}
    mxu_xtw = {"mxu_xtw.cuh", "mma_bf16.cuh", "xtw.cuh", "codes.cuh"}
    assert real["ax_mxu"] == {"ax_mxu.cu"} | mxu_xtw
    assert real["ax2_packed4_mxu"] == {"ax2_packed4_mxu.cu"} | mxu_xtw
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert {p.name for p in _build.sources("k")} == {"k.cu", "a.cuh", "b.cuh"}
    before = _build._library_path("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build._library_path("k") != before


def test_entry_points_are_looked_up_once(monkeypatch):
    """A wrapper asks for its C entry point on every launch: the library is
    loaded and the symbol resolved once per process."""
    import ctypes

    from vampomi_tpu_torch.ops import _build

    calls = []
    libc = ctypes.CDLL(None)
    monkeypatch.setattr(_build, "_FUNCTIONS", {})
    monkeypatch.setattr(_build, "library", lambda name: calls.append(name) or libc)
    first = _build.function("libc", "abs", [ctypes.c_int])
    assert _build.function("libc", "abs", [ctypes.c_int]) is first
    assert calls == ["libc"] and first(-3) == 3
