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
sum |x||v|, below 1e-6."""

import numpy as np
import pytest
import torch

from vampomi_tpu_torch.ops import operator as top
from vampomi_tpu_torch.ops.atx_int8 import atx_int8, atx_int8_plain
from vampomi_tpu_torch.ops.broadcast import (
    ax_batch_int8, ax_batch_int8_plain, ax_batch_packed4, ax_batch_packed4_plain,
)
from vampomi_tpu_torch.ops.packed4 import (
    atx_batch_packed4, atx_batch_packed4_plain, atx_packed4, atx_packed4_plain, unpack_rows,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want, scale):
    return ((got.double() - want.double()).abs() / scale.clamp_min(1e-30)).max().item()


def _check(kern, plain, X, V, A):
    """kern(X, V) against plain(X, V) and the f64 A @ V; repeatable."""
    got = kern(X, V)
    scale = A.abs() @ V.double().abs()
    assert _rel(got, plain(X, V), scale) < 1e-6
    assert _rel(got, A @ V.double(), scale) < 1e-6
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


@pytest.mark.parametrize("dtype", [torch.int8, top.PACKED4_DTYPE])
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
    kernels = ([atx_int8, ax_batch_int8] if dtype == torch.int8
               else [atx_packed4, ax_batch_packed4, atx_batch_packed4])
    before = [k.launches for k in kernels]
    for op, v in ((top.ax, x), (top.atx, y), (top.ax_batch, xs), (top.atx_batch, ys)):
        want = op(cpu, torch.as_tensor(v)).numpy()
        got = op(card, torch.as_tensor(v, device=cuda_device)).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    assert all(k.launches > b for k, b in zip(kernels, before))
