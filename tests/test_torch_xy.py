"""The reduce direction Y = X Ys on the int8 design (ops/atx_int8.py
atx_batch_int8, CG's A^T pass) on the CPU.  Inputs are made from a seed
with numpy.

The plain version is held column by column against the TPU kernel
`atx_int8_raw` in the Pallas interpreter and against the exact f64 product:
both sum exact f32 products in f32, so relative to sum |x||y| they agree to
f32 rounding (1e-6).  Not against JAX `operator.atx_batch`, which rounds Ys
to bf16 on the CPU (vampomi_tpu/ops/operator.py:334-340)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.ops import pallas_matvec
from vampomi_tpu_torch.ops import operator as top
from vampomi_tpu_torch.ops.atx_int8 import atx_batch_int8, atx_batch_int8_plain
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)
TOL = 1e-6


def _rel(got, want, scale):
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))


def _case(m, n, k, seed):
    rng = np.random.default_rng(seed)
    Xq = rng.integers(-127, 128, size=(m, n), dtype=np.int8)
    Ys = rng.normal(size=(n, k)).astype(np.float32)
    X64, Y64 = Xq.astype(np.float64), Ys.astype(np.float64)
    return Xq, Ys, X64 @ Y64, np.abs(X64) @ np.abs(Y64)


@pytest.mark.parametrize("shape", [(96, 256), (64, 384)])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_atx_batch_int8_plain_matches_pallas_interpret(shape, k):
    m, n = shape
    Xq, Ys, exact, scale = _case(m, n, k, m + k)
    got = atx_batch_int8_plain(torch.as_tensor(Xq), torch.as_tensor(Ys)).numpy()
    assert got.shape == (m, k) and got.dtype == np.float32
    tm = pallas_matvec.pick_tile(m, n)
    for j in range(k):
        col = np.asarray(pallas_matvec.atx_int8_raw(jnp.asarray(Xq), jnp.asarray(Ys[:, j]), tm,
                                                    interpret=True))
        assert _rel(got[:, j], col, scale[:, j]) < TOL
    assert _rel(got, exact, scale) < TOL


@pytest.mark.parametrize("shape", [(1000, 1001), (7, 1), (1, 33), (5, 16), (3, 4096)])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_atx_batch_int8_ragged_shapes_on_cpu(shape, k):
    """Any M, N >= 1: the CPU wrapper runs the plain version, counts no
    kernel launch, and matches the exact f64 product."""
    m, n = shape
    Xq, Ys, exact, scale = _case(m, n, k, 7 * m + k)
    before = atx_batch_int8.launches
    got = atx_batch_int8(torch.as_tensor(Xq), torch.as_tensor(Ys)).numpy()
    assert atx_batch_int8.launches == before
    assert got.shape == (m, k)
    assert _rel(got, exact, scale) < TOL


BAD = {
    "dtype_X": (lambda X, Y: (X.to(torch.uint8), Y), TypeError),
    "dtype_Ys": (lambda X, Y: (X, Y.double()), TypeError),
    "rows_of_Ys": (lambda X, Y: (X, Y[:-1]), ValueError),
    "rank": (lambda X, Y: (X, Y[:, 0]), ValueError),
    "k_above_8": (lambda X, Y: (X, torch.zeros((X.shape[1], 9))), ValueError),
    "non_contiguous_Ys": (lambda X, Y: (X, torch.zeros((2, X.shape[1])).T), ValueError),
    "non_contiguous_X": (lambda X, Y: (torch.zeros((16, 8), dtype=torch.int8).T, Y), ValueError),
    "empty_X": (lambda X, Y: (X[:0], Y), ValueError),
    "device_mismatch": (lambda X, Y: (X, Y.to("meta")), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_atx_batch_int8_rejects_bad_input(case):
    X = torch.zeros((8, 16), dtype=torch.int8)
    Ys = torch.zeros((16, 2), dtype=torch.float32)
    Xb, Yb = BAD[case][0](X, Ys)
    before = atx_batch_int8.launches
    with pytest.raises(BAD[case][1]):
        atx_batch_int8(Xb, Yb)
    assert atx_batch_int8.launches == before


def test_int8_atx_batch_goes_through_the_wrapper(monkeypatch):
    """operator.atx_batch on an int8 design calls atx_batch_int8 (the CUDA
    kernel on a card) on the design's X, once."""
    raw = simulate_iid(n=120, m=200, lam=0.1, h2=0.8, seed=5).X.T
    dm = top.build_design(raw, compute_dtype=torch.int8, device="cpu")
    ys = torch.as_tensor(np.random.default_rng(1).normal(size=(120, 2)).astype(np.float32))
    calls = []

    def spy(X, Ys):
        calls.append((X, Ys.shape))
        return atx_batch_int8(X, Ys)

    want = top.atx_batch(dm, ys)
    monkeypatch.setattr(top, "atx_batch_int8", spy)
    got = top.atx_batch(dm, ys)
    assert len(calls) == 1 and calls[0][0] is dm.X and calls[0][1] == (120, 2)
    assert torch.equal(got, want)
