"""The port's CUDA kernels on a card: each against its plain PyTorch version
and the exact f64 product, bitwise repeatability, and one launch count per
launch; and the quantized operators on the card against the same operators
on the CPU.

Every test here needs a CUDA card and is marked `cuda`; without one they
skip.  The file imports neither jax nor the JAX package, so it runs where
only torch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

(`--noconftest` skips tests/conftest.py, which configures jax for the rest
of the suite).  Tolerances: f32 sums in another order, relative to
sum |x||v|, below 1e-6; the tensor-core kernels' f32 sums do not round like
IEEE adds, and are held to chip_smoke.py's 1e-5 (KERNEL_TOL); the integer
read-floor sums are bitwise."""

import warnings

import numpy as np
import pytest
import torch

from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.io import bin_io
from vampomi_tpu_torch.ops import operator as top
from vampomi_tpu_torch.ops.atx_int8 import (
    atx_batch_int8, atx_batch_int8_plain, atx_int8, atx_int8_plain,
)
from vampomi_tpu_torch.ops.bf16 import (
    atx_batch_bf16, atx_batch_bf16_plain, atx_bf16, atx_bf16_plain, ax_batch_bf16,
    ax_batch_bf16_plain,
)
from vampomi_tpu_torch.ops.moments import (
    row_moments_int8, row_moments_int8_plain, row_moments_packed4, row_moments_packed4_plain,
)
from vampomi_tpu_torch.ops.broadcast import (
    ax_batch_int8, ax_batch_int8_plain, ax_batch_packed4, ax_batch_packed4_plain,
)
from vampomi_tpu_torch.gibbs import sampler as gibbs_sampler
from vampomi_tpu_torch.ops.gibbs_block import gibbs_block_update, gibbs_block_update_plain
from vampomi_tpu_torch.ops.mxu import (
    atx_mxu, atx_mxu_plain, ax2_packed4_mxu, ax2_packed4_mxu_plain, ax_mxu, ax_mxu_plain,
    bf16_round,
)
from vampomi_tpu_torch.ops.packed4 import (
    atx_batch_packed4, atx_batch_packed4_plain, atx_packed4, atx_packed4_plain, unpack_rows,
)
from vampomi_tpu_torch.ops.stream import (
    stream_rowsum, stream_rowsum_plain, stream_sum, stream_sum_plain,
)
from vampomi_tpu_torch.ops.spectral import GramFactor, shift_inverse
from vampomi_tpu_torch.sim.data_sim import simulate_iid
from vampomi_tpu_torch.tools import KERNEL_TOL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want, scale):
    return ((got.double() - want.double()).abs() / scale.clamp_min(1e-30)).max().item()


def _check(kern, plain, X, V, A, tol=1e-6, V_exact=None):
    """kern(X, V) against plain(X, V) and the f64 A @ V_exact (V unless
    given); repeatable."""
    got = kern(X, V)
    V_exact = V if V_exact is None else V_exact
    scale = A.abs() @ V_exact.double().abs()
    assert _rel(got, plain(X, V), scale) < tol
    assert _rel(got, A @ V_exact.double(), scale) < tol
    assert torch.equal(got, kern(X, V))


@pytest.mark.parametrize("shape", [(1000, 1001), (4096, 10240), (77, 20000)])
def test_atx_int8_kernel_matches_plain_on_card(cuda_device, shape):
    m, n = shape
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    X = torch.randint(-127, 128, (m, n), dtype=torch.int8, device=cuda_device, generator=g)
    y = torch.randn(n, 1, device=cuda_device, generator=g)
    before = atx_int8.launches
    _check(lambda a, v: atx_int8(a, v[:, 0].contiguous())[:, None],
           lambda a, v: atx_int8_plain(a, v[:, 0].contiguous())[:, None], X, y, X.double())
    assert atx_int8.launches == before + 2


@pytest.mark.parametrize("shape", [(1000, 1001), (4096, 10240), (77, 16)])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_ax_batch_int8_kernel_matches_plain_on_card(cuda_device, shape, k):
    m, n = shape
    g = torch.Generator(device=cuda_device)
    g.manual_seed(k)
    X = torch.randint(-127, 128, (m, n), dtype=torch.int8, device=cuda_device, generator=g)
    W = torch.randn(m, k, device=cuda_device, generator=g)
    before = ax_batch_int8.launches
    _check(ax_batch_int8, ax_batch_int8_plain, X, W, X.double().T)
    assert ax_batch_int8.launches == before + 2


@pytest.mark.parametrize("shape", [(1000, 501), (4096, 5120), (77, 16)])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_packed_kernels_match_plain_on_card(cuda_device, shape, k):
    m, n2 = shape
    g = torch.Generator(device=cuda_device)
    g.manual_seed(k)
    X = torch.randint(0, 256, (m, n2), dtype=torch.uint8, device=cuda_device, generator=g)
    C = unpack_rows(X, torch.float64)
    Ys = torch.randn(2 * n2, k, device=cuda_device, generator=g)
    W = torch.randn(m, k, device=cuda_device, generator=g)
    before = (atx_batch_packed4.launches, ax_batch_packed4.launches, atx_packed4.launches)
    _check(atx_batch_packed4, atx_batch_packed4_plain, X, Ys, C)
    _check(ax_batch_packed4, ax_batch_packed4_plain, X, W, C.T)
    _check(lambda a, v: atx_packed4(a, v[:, 0].contiguous())[:, None],
           lambda a, v: atx_packed4_plain(a, v[:, 0].contiguous())[:, None], X, Ys[:, :1], C)
    assert (atx_batch_packed4.launches, ax_batch_packed4.launches, atx_packed4.launches) == \
        (before[0] + 2, before[1] + 2, before[2] + 2)


# the three X Ys kernels of csrc/xy.cuh (R = 4 rows per warp at K <= 4)
XY = {"int8": (atx_batch_int8, atx_batch_int8_plain),
      "packed4": (atx_batch_packed4, atx_batch_packed4_plain),
      "bf16": (atx_batch_bf16, atx_batch_bf16_plain)}


def _xy_case(dev, kind, m, nb, k, seed, offset=0):
    """X (m, nb) of int8 codes, packed bytes or bf16 values starting
    `offset` elements into its storage (1: not 16-byte aligned, so the
    byte or unit path), its f64 values (m, N) and f32 Ys (N, k)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if kind == "bf16":
        X = torch.randn(m * nb + offset, device=dev, generator=g).to(torch.bfloat16)
        X = X[offset:].view(m, nb)
        return X, X.double(), torch.randn(nb, k, device=dev, generator=g)
    lo, hi, dt = (-127, 128, torch.int8) if kind == "int8" else (0, 256, torch.uint8)
    X = torch.randint(lo, hi, (m * nb + offset,), dtype=dt, device=dev,
                      generator=g)[offset:].view(m, nb)
    C = X.double() if kind == "int8" else unpack_rows(X, torch.float64)
    return X, C, torch.randn(C.shape[1], k, device=dev, generator=g)


@pytest.mark.parametrize("kind", list(XY))
@pytest.mark.parametrize("shape", [(1003, 1024), (3, 4096), (4097, 10240), (77, 16), (1000, 1001)])
@pytest.mark.parametrize("k", range(1, 9))
def test_xy_kernels_match_plain_on_card(cuda_device, kind, shape, k):
    """M not a multiple of R (1003, 4097, 77) and below it (3), the 16-byte
    and the byte path, Ys in shared memory or (large N*K) through the
    read-only cache."""
    kern, plain = XY[kind]
    X, C, Ys = _xy_case(cuda_device, kind, *shape, k, seed=shape[0] + k)
    before = kern.launches
    _check(kern, plain, X, Ys, C)
    assert kern.launches == before + 2


@pytest.mark.parametrize("kind", list(XY))
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("k", [2, 3])
def test_xy_kernels_ldg_path_and_unaligned_x_on_card(cuda_device, kind, offset, k):
    """N = 20,000 samples: Yt of 160-240 KB, above the shared-memory cap,
    so Ys is read through the read-only cache; offset 1 puts X one byte off
    16-byte alignment."""
    kern, plain = XY[kind]
    nb = 10_000 if kind == "packed4" else 20_000
    X, C, Ys = _xy_case(cuda_device, kind, 515, nb, k, seed=k + 10 * offset, offset=offset)
    _check(kern, plain, X, Ys, C)


@pytest.mark.parametrize("shape", [(1000, 1001), (4096, 10240), (77, 16), (3, 8)])
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("offset", [0, 1])
def test_bf16_kernels_match_plain_on_card(cuda_device, shape, k, offset):
    """atx_bf16 and ax_batch_bf16 against their plain versions and the f64
    product of the stored values (a bf16 value widens to f32 exactly), at
    the 16-byte and (N % 8 != 0, or offset 1: X off 16-byte alignment) the
    unit path; one launch a call."""
    m, n = shape
    X, C, y = _xy_case(cuda_device, "bf16", m, n, 1, seed=k + n, offset=offset)
    W = torch.randn(m, k, device=cuda_device)
    before = (atx_bf16.launches, ax_batch_bf16.launches)
    _check(ax_batch_bf16, ax_batch_bf16_plain, X, W, C.T)
    _check(lambda a, v: atx_bf16(a, v[:, 0].contiguous())[:, None],
           lambda a, v: atx_bf16_plain(a, v[:, 0].contiguous())[:, None], X, y, C)
    assert (atx_bf16.launches, ax_batch_bf16.launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("dtype", [torch.int8, top.PACKED4_DTYPE, torch.bfloat16])
def test_quantized_operator_on_card_matches_cpu(cuda_device, dtype):
    """ax, atx, ax_batch, atx_batch of a quantized design: the card (through
    the kernels) against the CPU (plain versions), and every kernel of the
    dtype launched."""
    rng = np.random.default_rng(0)
    raw = rng.uniform(0.0, 1.0, size=(3000, 512))
    cpu = top.build_design(raw, compute_dtype=dtype, device="cpu")
    card = top.build_design(raw, compute_dtype=dtype, device=cuda_device)
    x = rng.normal(size=3000).astype(np.float32)
    y = rng.normal(size=512).astype(np.float32)
    xs = rng.normal(size=(3000, 2)).astype(np.float32)
    ys = rng.normal(size=(512, 2)).astype(np.float32)
    kernels = {torch.int8: [atx_int8, ax_batch_int8, atx_batch_int8],
               top.PACKED4_DTYPE: [atx_packed4, ax_batch_packed4, atx_batch_packed4],
               torch.bfloat16: [atx_bf16, ax_batch_bf16, atx_batch_bf16]}[dtype]
    before = [k.launches for k in kernels]
    for op, v in ((top.ax, x), (top.atx, y), (top.ax_batch, xs), (top.atx_batch, ys)):
        want = op(cpu, torch.as_tensor(v)).numpy()
        got = op(card, torch.as_tensor(v, device=cuda_device)).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    assert all(k.launches > b for k, b in zip(kernels, before))


@pytest.mark.parametrize("shape", [(1000, 1001), (4096, 10240), (77, 16), (3, 5)])
@pytest.mark.parametrize("offset", [0, 1])
def test_stream_kernels_match_plain_bitwise_on_card(cuda_device, shape, offset):
    """The read-floor sums equal the plain int64 sums wrapped to int32, bit
    for bit, on aligned X and on a view one row in (16-byte loads off when
    N % 16 != 0)."""
    m, n = shape
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m + offset)
    X = torch.randint(-128, 128, (m + offset, n), dtype=torch.int8, device=cuda_device,
                      generator=g)[offset:]
    before = (stream_sum.launches, stream_rowsum.launches)
    for kern, plain in ((stream_sum, stream_sum_plain), (stream_rowsum, stream_rowsum_plain)):
        got = kern(X)
        assert got.dtype == torch.int32
        assert torch.equal(got, plain(X))
        assert torch.equal(got, kern(X))
    assert (stream_sum.launches, stream_rowsum.launches) == (before[0] + 2, before[1] + 2)


def test_stream_sum_wraps_like_int32_on_card(cuda_device):
    X = torch.full((4096, 4200), 127, dtype=torch.int8, device=cuda_device)
    want = np.sum(np.full(4096 * 4200, 127, dtype=np.int32), dtype=np.int32)
    assert int(stream_sum(X)) == int(want) == int(stream_sum_plain(X))


@pytest.mark.parametrize("shape", [(1000, 1001), (4096, 10240), (77, 16), (1003, 96)])
def test_atx_mxu_kernel_matches_plain_on_card(cuda_device, shape):
    m, n = shape
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m)
    X = torch.randint(-127, 128, (m, n), dtype=torch.int8, device=cuda_device, generator=g)
    y = torch.randn(n, 1, device=cuda_device, generator=g)
    before = atx_mxu.launches
    _check(lambda a, v: atx_mxu(a, v[:, 0].contiguous())[:, None],
           lambda a, v: atx_mxu_plain(a, v[:, 0].contiguous())[:, None], X, y, X.double(),
           tol=KERNEL_TOL, V_exact=bf16_round(y))
    assert atx_mxu.launches == before + 2


@pytest.mark.parametrize("shape", [(1000, 1002), (4096, 10240), (77, 16)])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_ax_mxu_kernels_match_plain_on_card(cuda_device, shape, k):
    """ax_mxu on int8 X of the shape, ax2_packed4_mxu on packed X of half its
    width."""
    m, n = shape
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m + k)
    X = torch.randint(-127, 128, (m, n), dtype=torch.int8, device=cuda_device, generator=g)
    Xp = torch.randint(0, 256, (m, n // 2), dtype=torch.uint8, device=cuda_device, generator=g)
    W = torch.randn(m, k, device=cuda_device, generator=g)
    before = (ax_mxu.launches, ax2_packed4_mxu.launches)
    _check(ax_mxu, ax_mxu_plain, X, W, X.double().T, tol=KERNEL_TOL, V_exact=bf16_round(W))
    _check(ax2_packed4_mxu, ax2_packed4_mxu_plain, Xp, W, unpack_rows(Xp, torch.float64).T,
           tol=KERNEL_TOL, V_exact=bf16_round(W))
    assert (ax_mxu.launches, ax2_packed4_mxu.launches) == (before[0] + 2, before[1] + 2)


def test_dumps_byte_identical_and_pinned_on_card(cuda_device, tmp_path, monkeypatch):
    """A short eigen run with the dumps on: the .bin files written through
    the side-stream copies are byte-identical to the same run with the
    copies made synchronously on the compute stream, and the copies land in
    pinned host memory."""
    fx = simulate_iid(n=512, m=2048, lam=0.1, h2=0.8, seed=3)
    y = fx.y * np.sqrt((511.0) / np.sum((fx.y - fx.y.mean()) ** 2))
    copies = []

    class Recording(bin_io.HostStager):
        def copy(self, vecs):
            c = super().copy(vecs)
            copies.append(c)
            return c

    class Synchronous:
        def __init__(self, device):
            pass

        def copy(self, vecs):
            return bin_io.HostCopy([v.cpu() for v in vecs])

    names = {}
    for name, stager in (("side", Recording), ("sync", Synchronous)):
        monkeypatch.setattr(tlin, "HostStager", stager)
        for dtype in (torch.int8, top.PACKED4_DTYPE):
            dm = top.build_design(fx.X.T, compute_dtype=dtype, device=cuda_device)
            out = f"{name}_{dtype}".replace("torch.", "")
            cfg = RunConfig(out_dir=str(tmp_path), out_name=out, iterations=4,
                            lmmse_solver="eigen", stop_criteria_thr=0.0, device="cuda", seed=1,
                            probs=[0.9, 0.07, 0.03], vars=[0.0, 1e-3, 1e-2], h2=0.8)
            tlin.infere_linear(dm, y, cfg, true_signal=fx.beta)
            names.setdefault(name, []).append(out)
    assert len(copies) == 8
    assert all(t.is_pinned() for c in copies for t in c.wait())
    for side, sync in zip(names["side"], names["sync"]):
        for it in range(1, 5):
            for kind in ("", "r1_"):
                a = (tmp_path / f"{side}_{kind}it_{it}.bin").read_bytes()
                b = (tmp_path / f"{sync}_{kind}it_{it}.bin").read_bytes()
                assert len(a) == 8 * 2048 and a == b, (side, kind, it)


@pytest.mark.parametrize("kind", ["int8", "packed4"])
@pytest.mark.parametrize("shape", [(1000, 1001), (4096, 10240), (77, 16), (3, 5), (1003, 96)])
@pytest.mark.parametrize("offset", [0, 1])
def test_row_moments_match_plain_bitwise_on_card(cuda_device, kind, shape, offset):
    """Σ q and Σ q² per row equal the plain int64 sums bit for bit, on
    aligned X and on a view one row in (the byte path when the row length or
    the pointer rules out 16-byte loads); the full int8 byte range, -128
    included."""
    m, n = shape
    nb = n if kind == "int8" else max(1, n // 2)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(m + offset)
    lo, hi, dt = (-128, 128, torch.int8) if kind == "int8" else (0, 256, torch.uint8)
    X = torch.randint(lo, hi, (m + offset, nb), dtype=dt, device=cuda_device,
                      generator=g)[offset:]
    kern, plain = ((row_moments_int8, row_moments_int8_plain) if kind == "int8"
                   else (row_moments_packed4, row_moments_packed4_plain))
    before = kern.launches
    got = kern(X)
    assert got.dtype == torch.int64 and got.shape == (m, 2)
    assert torch.equal(got, plain(X))
    assert torch.equal(got, kern(X))
    assert kern.launches == before + 2


def test_row_moments_extreme_rows_on_card(cuda_device):
    """Rows of all -128 past the longest N an int32 sum of squares holds
    (131,071), on the 16-byte path and on the byte path, and packed rows of
    all -8 codes: the int64 sums at their extremes."""
    for n in (131071, 262144, 262147):
        X = torch.full((5, n), -128, dtype=torch.int8, device=cuda_device)
        got = row_moments_int8(X).cpu()
        assert got[:, 0].tolist() == [-128 * n] * 5
        assert got[:, 1].tolist() == [16384 * n] * 5
    Xp = torch.zeros((5, 4096), dtype=torch.uint8, device=cuda_device)  # nibbles 0: codes -8
    got = row_moments_packed4(Xp).cpu()
    assert got[:, 0].tolist() == [-8 * 8192] * 5 and got[:, 1].tolist() == [64 * 8192] * 5


@pytest.mark.parametrize("n", [524288, 600001])
def test_row_moments_long_rows_match_plain_bitwise_on_card(cuda_device, n):
    """Random int8 rows longer than an int32 sum of squares allows: the
    kernel's int64 sums equal the plain version's bit for bit."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n)
    X = torch.randint(-128, 128, (7, n), dtype=torch.int8, device=cuda_device, generator=g)
    got = row_moments_int8(X)
    assert got.dtype == torch.int64
    assert torch.equal(got, row_moments_int8_plain(X))
    assert int(got[:, 1].max()) > 2**31


@pytest.mark.parametrize("n,nb", [(512, None), (2048, 4), (2048, 16), (3000, None)])
def test_shift_inverse_on_card_matches_f64(cuda_device, n, nb):
    """W = L^{-1} and T = tr S^{-1} in f32 on the card against the f64
    factor on the CPU, by the blocked pass: one leaf at N = 512, 4 and 16
    blocks at 2,048, and default_nb's 4 ragged blocks of 750 rows, each a
    recursion, at 3,000: W S W^T = I to f32 accuracy at these
    well-conditioned shifts, with one host sync a call; a shift that is not
    positive definite raises."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, 4 * n)) / np.sqrt(4 * n)
    K = A @ A.T
    tau, gam2 = 5.0, 0.3
    S = tau * K + gam2 * np.eye(n)
    want = shift_inverse(GramFactor(K=torch.as_tensor(K)), tau, gam2, nb=nb)
    fac = GramFactor(K=torch.as_tensor(K, dtype=torch.float32, device=cuda_device))
    # the shift on the card, as the engines hold it (a Python number would
    # add its own copy to the card); a first call sets cuSOLVER up
    shift = [torch.tensor(x, dtype=torch.float64, device=cuda_device) for x in (tau, gam2)]
    shift_inverse(fac, *shift, nb=nb)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = shift_inverse(fac, *shift, nb=nb)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1
    W = got.W.double().cpu().numpy()
    np.testing.assert_allclose(W @ S @ W.T, np.eye(n), atol=2e-4)
    np.testing.assert_allclose(float(got.T), float(want.T), rtol=1e-5)
    b = rng.standard_normal(n)
    np.testing.assert_allclose(
        got.solve(torch.as_tensor(b, dtype=torch.float32, device=cuda_device)).cpu().numpy(),
        want.solve(torch.as_tensor(b)).numpy(), rtol=1e-4, atol=1e-5 * np.abs(b).max())
    with pytest.raises(RuntimeError, match="not positive definite"):
        shift_inverse(GramFactor(K=torch.as_tensor(K, dtype=torch.float32,
                                                   device=cuda_device)), -tau, gam2, nb=nb)


@pytest.mark.parametrize("dtype", [torch.int8, top.PACKED4_DTYPE, torch.bfloat16])
def test_a_column_does_not_depend_on_its_batch_on_card(cuda_device, dtype):
    """Test mode sends 8 estimates through one ax_batch pass: each column at
    K = 8 against the same column alone (K = 1) and in a batch of 3, within
    f32 rounding (the kernel's split of the marker sum follows K)."""
    rng = np.random.default_rng(0)
    dm = top.build_design(rng.uniform(size=(20000, 1024)), compute_dtype=dtype,
                          device=cuda_device)
    xs = torch.as_tensor(rng.normal(size=(20000, 8)), dtype=torch.float32, device=cuda_device)
    full = top.ax_batch(dm, xs)
    for k in range(8):
        tol = 1e-5 * float(full[:, k].abs().max())
        alone = top.ax_batch(dm, xs[:, k:k + 1].contiguous())[:, 0]
        torch.testing.assert_close(alone, full[:, k], rtol=0, atol=tol)
        lo = min(k, 5)
        three = top.ax_batch(dm, xs[:, lo:lo + 3].contiguous())[:, k - lo]
        torch.testing.assert_close(three, full[:, k], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the Gibbs block update (csrc/gibbs_block.cu) and the sampler on the card


def _gibbs_block_inputs(B, L, dtype, masked, dev, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    A = torch.randn((B, 300), device=dev, generator=g) / np.sqrt(300)  # the Gram made on the card
    mm = np.ones(B)
    # masked: a count of markers drawn at random, or their indices
    mm[rng.choice(B, masked, replace=False) if isinstance(masked, int) else list(masked)] = 0.0
    vec = {"u": rng.uniform(size=B), "z": rng.normal(size=B), "xb0": rng.normal(size=B) * 0.3,
           "mmask_b": mm}
    t = {k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in vec.items()}
    f64 = dict(dtype=torch.float64, device=dev)
    return (A @ A.T,
            torch.as_tensor(rng.normal(size=B) * 2, dtype=torch.float32, device=dev),
            t["xb0"], t["mmask_b"], t["u"], t["z"],
            torch.as_tensor(rng.dirichlet(np.ones(L)), **f64),
            torch.as_tensor(gibbs_sampler.decade_cvars(L), **f64),
            torch.tensor(1.7, **f64), torch.tensor(0.4, **f64))


@pytest.mark.parametrize("B,L,dtype,masked", [
    (1, 4, torch.float32, 0), (100, 2, torch.float32, 5), (256, 4, torch.float32, 3),
    (256, 6, torch.float64, 3), (1500, 4, torch.float32, 10), (1500, 2, torch.float64, 0),
    (58_200, 4, torch.float32, 20),  # c past the shared memory: in global scratch
    # sub-blocks of 32 markers: ragged tails, one lane's component each and
    # lanes looping over L past 32, masked markers on sub-block boundaries
    (31, 4, torch.float32, 3), (32, 4, torch.float32, 0), (33, 4, torch.float32, 2),
    (255, 4, torch.float32, 9), (257, 4, torch.float32, 5), (100, 1, torch.float32, 4),
    (64, 33, torch.float32, 3), (100, 40, torch.float64, 6),
    (257, 4, torch.float32, (0, 31, 32, 63, 64, 255, 256)), (256, 4, torch.float64, 0),
    (64, 16, torch.float32, 2), (40, 32, torch.float32, 1),
    (40, 140, torch.float32, 3)])  # L past the tables' room: the chain computes v itself
def test_gibbs_block_update_kernel_matches_plain_on_card(cuda_device, B, L, dtype, masked):
    """The kernel against its plain version on the same card tensors: the
    components equal, x to 1e-6 of its largest value (f64 log and exp of
    two libraries), masked markers at 0; bitwise repeatable; one launch a
    call.  The cases cover the kernel's sub-blocks of 32 markers (see
    csrc/gibbs_block.cu)."""
    args = _gibbs_block_inputs(B, L, dtype, masked, cuda_device)
    before = gibbs_block_update.launches
    x, k = gibbs_block_update(*args)
    px, pk = gibbs_block_update_plain(*args)
    torch.cuda.synchronize()
    assert x.dtype == dtype and k.dtype == torch.int32
    assert torch.equal(k, pk)
    torch.testing.assert_close(x, px, rtol=0, atol=1e-6 * float(px.abs().max()))
    assert bool((x[args[3] == 0] == 0).all()) and bool((k[args[3] == 0] == 0).all())
    x2, k2 = gibbs_block_update(*args)
    assert torch.equal(x, x2) and torch.equal(k, k2)
    assert gibbs_block_update.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.int8, top.PACKED4_DTYPE, torch.float32])
def test_block_grams_on_card_match_cpu(cuda_device, dtype):
    """Quantized Grams bitwise equal to the CPU's (exact integer products,
    the same f32 corrections; torch._int_mm at a block of 100 rows and an
    N of 1,002 pads both); f32 Grams to 1e-5 of the largest (cuBLAS and the
    CPU's BLAS sum in other orders)."""
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(400, 1002))
    cpu = gibbs_sampler.build_block_grams(top.build_design(X, compute_dtype=dtype), block=100)
    card = gibbs_sampler.build_block_grams(
        top.build_design(X, compute_dtype=dtype, device=cuda_device), block=100).cpu()
    if dtype == torch.float32:
        torch.testing.assert_close(card, cpu, rtol=0, atol=1e-5 * float(cpu.abs().max()))
    else:
        assert torch.equal(card, cpu)


@pytest.mark.parametrize("dtype", [torch.int8, top.PACKED4_DTYPE])
def test_gibbs_sweep_on_card_matches_cpu(cuda_device, dtype):
    """Two sweeps on the card and on the CPU from the same state with the
    same draws: all but at most 2 of 2,048 components equal (a draw near a
    boundary may flip under the passes' other summation order), x to 1e-4
    of its largest value where they agree; one kernel launch and one pass
    each way per block."""
    sim = simulate_iid(n=512, m=2048, lam=0.05, h2=0.6, seed=3)
    y = sim.y / sim.y.std(ddof=1)
    cvars = gibbs_sampler.decade_cvars(4)
    state = None
    for _ in range(2):
        outs = {}
        for dev in ("cpu", cuda_device):
            dm = top.build_design(sim.X.T, compute_dtype=dtype, device=dev)
            grams = gibbs_sampler.build_block_grams(dm, block=256)
            s0 = (gibbs_sampler.init_state(dm, y, 4) if state is None
                  else gibbs_sampler.GibbsState(*[t.to(dev) for t in state]))
            before = gibbs_block_update.launches
            new, _ = gibbs_sampler.gibbs_sweep(
                dm, grams, s0, torch.as_tensor(cvars).to(dev), gibbs_sampler.TorchDraws(5),
                torch.as_tensor(y, dtype=torch.float32, device=dev), block=256)
            outs[str(dev)] = (new, gibbs_block_update.launches - before)
        (a, na), (b, nb) = outs["cpu"], outs[str(cuda_device)]
        assert na == 0 and nb == 8
        bc, bx = b.comp.cpu(), b.x.cpu()
        agree = a.comp == bc
        assert int((~agree).sum()) <= 2
        torch.testing.assert_close(bx[agree], a.x[agree], rtol=0,
                                   atol=1e-4 * float(a.x.abs().max()))
        state = [t.cpu() for t in b]
