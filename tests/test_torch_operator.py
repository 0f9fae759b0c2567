"""The port's design operator and its int8 kernel wrapper against the JAX
package (vampomi_tpu/ops/operator.py, ops/pallas_matvec.py) on the CPU.

Both packages get the same raw X, made from a seed with numpy; the JAX
DesignMatrix is carried into the port by convert.design_from_arrays, so the
operator products compare on identical inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.ops import operator as jop
from vampomi_tpu.ops import pallas_matvec
from vampomi_tpu_torch import convert
from vampomi_tpu_torch.ops import operator as top
from vampomi_tpu_torch.ops.atx_int8 import atx_int8, atx_int8_plain
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)

DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def raw():
    return simulate_iid(n=300, m=500, lam=0.1, h2=0.8, seed=42).X.T  # (M, N)


def _arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.mark.parametrize("name", list(DTYPES))
def test_build_design_matches_jax(raw, name):
    jd, td = DTYPES[name]
    jdm = jop.build_design(raw, mesh=None, compute_dtype=jd)
    tdm = top.build_design(raw, compute_dtype=td, device="cpu")
    assert tdm.X.dtype == td and tuple(tdm.X.shape) == tuple(jdm.X.shape)
    # int8: identical codes; f64/f32: the same values
    np.testing.assert_array_equal(tdm.X.numpy(), np.asarray(jdm.X))
    # the f64 host statistics are identical; only the final cast to the
    # work dtype rounds (f32 for float32 and int8 designs)
    rtol = 1e-12 if name == "float64" else 0.0
    np.testing.assert_allclose(tdm.mave.numpy(), np.asarray(jdm.mave), rtol=rtol)
    np.testing.assert_allclose(tdm.msig.numpy(), np.asarray(jdm.msig), rtol=rtol)
    assert tdm.wd == (torch.float64 if name == "float64" else torch.float32)
    assert tdm.n == float(jdm.n) and tdm.mt == float(jdm.mt)


@pytest.fixture(scope="module")
def pair64(raw):
    jdm = jop.build_design(raw, mesh=None, compute_dtype=jnp.float64)
    return jdm, convert.design_from_arrays(_arrays(jdm), device="cpu")


OPS = {
    "ax": lambda mod, dm, v: mod.ax(dm, v["x"]),
    "atx": lambda mod, dm, v: mod.atx(dm, v["y"]),
    "ax_batch": lambda mod, dm, v: mod.ax_batch(dm, v["xs"]),
    "atx_batch": lambda mod, dm, v: mod.atx_batch(dm, v["ys"]),
    "normal_eq_mult": lambda mod, dm, v: mod.normal_eq_mult(dm, v["xs"], 2.5, 0.7),
}


@pytest.mark.parametrize("op", list(OPS))
def test_operator_products_f64_match_jax(pair64, op):
    jdm, tdm = pair64
    rng = np.random.default_rng(3)
    m, n = tdm.X.shape
    vals = dict(x=rng.normal(size=m), y=rng.normal(size=n),
                xs=rng.normal(size=(m, 3)), ys=rng.normal(size=(n, 3)))
    want = np.asarray(OPS[op](jop, jdm, {k: jnp.asarray(v) for k, v in vals.items()}))
    got = OPS[op](top, tdm, {k: torch.as_tensor(v) for k, v in vals.items()}).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(96, 256), (64, 384)])
def test_atx_int8_plain_matches_pallas_interpret(shape):
    """The port's plain version against the TPU kernel in the Pallas
    interpreter and against the exact f64 product, at the tolerance of
    tests/test_pallas_matvec.py (f32 accumulation; int8 -> f32 exact).
    Not against JAX operator.atx: on the CPU that takes the einsum route,
    which rounds y to bf16 (~1.6e-3 relative)."""
    m, n = shape
    rng = np.random.default_rng(0)
    Xq = rng.integers(-127, 128, size=(m, n), dtype=np.int8)
    y = rng.normal(size=n).astype(np.float32)
    tm = pallas_matvec.pick_tile(m, n)
    jax_v = np.asarray(pallas_matvec.atx_int8_raw(
        jnp.asarray(Xq), jnp.asarray(y), tm, interpret=True))
    got = atx_int8_plain(torch.as_tensor(Xq), torch.as_tensor(y)).numpy()
    exact = Xq.astype(np.float64) @ y.astype(np.float64)
    np.testing.assert_allclose(got, jax_v, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got, exact, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("shape", [(1000, 1001), (7, 1), (1, 33)])
def test_atx_int8_ragged_shapes_on_cpu(shape):
    """Any M, N >= 1 (no tile gate): the CPU wrapper runs the plain
    version and counts no kernel launch."""
    m, n = shape
    rng = np.random.default_rng(1)
    Xq = rng.integers(-127, 128, size=(m, n), dtype=np.int8)
    y = rng.normal(size=n).astype(np.float32)
    before = atx_int8.launches
    got = atx_int8(torch.as_tensor(Xq), torch.as_tensor(y)).numpy()
    assert atx_int8.launches == before
    scale = np.abs(Xq).astype(np.float64) @ np.abs(y).astype(np.float64)
    exact = Xq.astype(np.float64) @ y.astype(np.float64)
    assert np.max(np.abs(got - exact) / np.maximum(scale, 1e-30)) < 1e-6


def test_int8_ax_batch_and_atx_batch_against_exact(raw):
    """int8 products are f32 dequantized-chunk matmuls: against the exact
    f64 product of the same codes and vectors they agree to f32 rounding of
    an N- or M-term sum (relative to the sum of magnitudes, < 1e-6)."""
    tdm = top.build_design(raw, compute_dtype=torch.int8, device="cpu")
    Xq = tdm.X.numpy().astype(np.float64)
    msig = tdm.msig.numpy().astype(np.float64)
    mave = tdm.mave.numpy().astype(np.float64)
    m, n = Xq.shape
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(m, 2)).astype(np.float32)
    ys = rng.normal(size=(n, 2)).astype(np.float32)
    A = (Xq - mave[:, None]) * msig[:, None] / np.sqrt(n)  # (M, N) = A^T
    got_ax = top.ax_batch(tdm, torch.as_tensor(xs)).numpy()
    want_ax = A.T @ xs.astype(np.float64)
    scale_ax = np.abs(A.T) @ np.abs(xs.astype(np.float64))
    assert np.max(np.abs(got_ax - want_ax) / scale_ax) < 1e-6
    got_atx = top.atx_batch(tdm, torch.as_tensor(ys)).numpy()
    want_atx = A @ ys.astype(np.float64)
    scale_atx = np.abs(A) @ np.abs(ys.astype(np.float64))
    assert np.max(np.abs(got_atx - want_atx) / scale_atx) < 1e-6
    # the single-vector directions agree with the batch columns
    np.testing.assert_allclose(top.ax(tdm, torch.as_tensor(xs[:, 0])).numpy(),
                               got_ax[:, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(top.atx(tdm, torch.as_tensor(ys[:, 0])).numpy(),
                               got_atx[:, 0], rtol=1e-5, atol=1e-5)


def test_int8_products_chunk_boundary(raw, monkeypatch):
    """The plain int8 products give the same result when the row-chunk
    budget splits X into many ragged chunks."""
    tdm = top.build_design(raw, compute_dtype=torch.int8, device="cpu")
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(tdm.m_pad, 2)).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=(300, 2)).astype(np.float32))
    whole = (top.ax_batch(tdm, x), top.atx_batch(tdm, y), top.atx(tdm, y[:, 0]))
    monkeypatch.setattr(top, "PLAIN_CHUNK_BYTES", 4 * 300 * 37)
    from vampomi_tpu_torch.ops import atx_int8 as mod
    monkeypatch.setattr(mod, "PLAIN_CHUNK_BYTES", 4 * 300 * 37)
    split = (top.ax_batch(tdm, x), top.atx_batch(tdm, y), top.atx(tdm, y[:, 0]))
    for a, b in zip(whole, split):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_design_from_codes_matches_host_stats():
    rng = np.random.default_rng(7)
    Xq = rng.integers(-127, 128, size=(200, 150), dtype=np.int8)
    Xq[3] = 5  # a constant marker gets msig = 1
    dm = top.design_from_codes(torch.as_tensor(Xq))
    mave, msig = top.dequantized_stats(Xq, np.ones(200), np.zeros(200), 1.0)
    np.testing.assert_allclose(dm.mave.numpy(), mave.astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(dm.msig.numpy(), msig.astype(np.float32), rtol=1e-6)
    assert dm.msig[3].item() == 1.0


BAD = {
    "dtype_X": (lambda X, y: (X.to(torch.int16), y), TypeError),
    "dtype_y": (lambda X, y: (X, y.double()), TypeError),
    "shape": (lambda X, y: (X, y[:-1]), ValueError),
    "rank": (lambda X, y: (X.reshape(-1), y), ValueError),
    "non_contiguous": (lambda X, y: (X.t(), y[:X.shape[0]].contiguous()), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_atx_int8_wrapper_rejects_bad_input(case):
    X = torch.zeros((8, 16), dtype=torch.int8)
    y = torch.zeros(16, dtype=torch.float32)
    fn, err = BAD[case]
    Xb, yb = fn(X, y)
    with pytest.raises(err):
        atx_int8(Xb, yb)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the atx_int8 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 1001), (4096, 10240), (77, 20000)])
def test_atx_int8_kernel_matches_plain_on_card(cuda_device, shape):
    """The CUDA kernel against its plain version on the card (f32 sums in
    another order: relative to sum |x||y|, below 1e-6)."""
    m, n = shape
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    X = torch.randint(-127, 128, (m, n), dtype=torch.int8, device=cuda_device, generator=g)
    y = torch.randn(n, device=cuda_device, generator=g)
    before = atx_int8.launches
    got = atx_int8(X, y)
    assert atx_int8.launches == before + 1
    want = atx_int8_plain(X, y)
    scale = X.double().abs() @ y.double().abs()
    assert ((got.double() - want.double()).abs() / scale).max().item() < 1e-6
    assert torch.equal(got, atx_int8(X, y))  # no atomics: bitwise repeatable
