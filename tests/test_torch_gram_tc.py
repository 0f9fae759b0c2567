"""The Gram on the tensor cores (vampomi_tpu_torch/ops/gram_tc.py) and the
route spectral.gram takes to it.

On the CPU: the three-piece bf16 split of the f32 weighted side is exact for
every int8 code, every int4 nibble and a sweep of bf16 values times the
weights standardisation gives; the plain version and the three-piece
arithmetic agree with today's f32 route and with f64 within f32 rounding,
on ragged shapes; the mirrored G is
exactly symmetric; and every CPU design (int8, packed int4, bf16, f32, f64)
keeps the route it had, bit for bit.  On a card (marked `cuda`, skipped
here): the kernel against its plain version, and the dispatch."""

import numpy as np
import pytest
import torch

from vampomi_tpu_torch.ops import gram_tc as gtc
from vampomi_tpu_torch.ops import spectral
from vampomi_tpu_torch.ops.operator import PACKED4_DTYPE, build_design
from vampomi_tpu_torch.ops.packed4 import unpack_rows

torch.set_num_threads(2)

STORAGE = {"int8": torch.int8, "int4": PACKED4_DTYPE, "bf16": torch.bfloat16}


def _codes(kind: str) -> torch.Tensor:
    """Every value a stored element can decode to: all int8 codes, all
    nibbles, and bf16 values over 2^-30 .. 2^30 of both signs."""
    if kind == "int8":
        return torch.arange(-127, 128, dtype=torch.float32)
    if kind == "int4":
        return torch.arange(-8, 8, dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    mant = torch.randint(0, 128, (2048,), generator=g)
    expo = torch.randint(-30, 31, (2048,), generator=g)
    sign = torch.where(torch.rand(2048, generator=g) < 0.5, -1.0, 1.0)
    return (sign * (1 + mant / 128.0) * torch.exp2(expo.float())).to(torch.bfloat16).float()


@pytest.mark.parametrize("kind", sorted(STORAGE))
def test_split3_is_exact(kind):
    # w2 = 1 / var of a standardised marker: int8 codes ~1e-4, nibbles
    # ~5e-2, bf16 values anywhere; a log sweep with random significands
    g = torch.Generator().manual_seed(11)
    w2 = torch.exp2(torch.linspace(-24.0, 8.0, 257)) * (1 + torch.rand(257, generator=g))
    v = w2[:, None] * _codes(kind)[None, :]
    h, m, l = gtc.split3(v)
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    assert torch.equal((h.float() + m.float()) + l.float(), v)
    assert torch.equal(h.float() + (m.float() + l.float()), v)
    assert bool((l.float().abs() <= m.float().abs()).all())


def _store(kind: str, m: int, n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if kind == "int8":
        return torch.randint(-127, 128, (m, n), dtype=torch.int8, generator=g)
    if kind == "int4":
        return torch.randint(0, 256, (m, n // 2), dtype=torch.uint8, generator=g)
    return torch.randn((m, n), generator=g).to(torch.bfloat16)


@pytest.mark.parametrize("kind,m,n", [("int8", 1000, 257), ("int4", 1000, 258),
                                      ("bf16", 1000, 1000)])
def test_plain_agrees_with_f32_route(kind, m, n):
    """gram_tc_plain and the kernel's arithmetic (the three pieces of each
    block's f32 w2 * x, each times the codes in f32) against the f32 route
    and f64, blocks of 384 rows so that M is not a multiple of the block."""
    X = _store(kind, m, n, 3)
    g = torch.Generator().manual_seed(4)
    w2 = torch.rand(m, generator=g) * 0.02 + 1e-4
    u = w2 * torch.randn(m, generator=g)
    G, t = gtc.gram_tc_plain(X, w2, u, block=384)
    G32, t32 = gtc.gram_blocks(X, w2, u, n, block=384)
    G64, t64 = gtc.gram_blocks(X, w2.double(), u.double(), n, block=384)
    G3 = torch.zeros((n, n))
    for lo in range(0, m, 384):
        Xb = gtc.decode(X[lo:lo + 384])
        for piece in gtc.split3(w2[lo:lo + 384, None] * Xb):
            G3 += piece.float().T @ Xb
    assert torch.equal(G, G.T)
    assert torch.equal(G.tril(), G32.tril())
    scale, tscale = float(G64.abs().max()), float(t64.abs().max())
    for Gr in (G, G3):
        assert float((Gr.double() - G64).abs().max()) < 1e-6 * scale
    assert float((G3 - G32).abs().max()) < 2e-6 * scale
    assert float((t.double() - t64).abs().max()) < 1e-6 * tscale
    assert torch.equal(t, t32)  # the same product: u @ codes in f32


def test_mirror_lower_is_exactly_symmetric():
    A = torch.randn((300, 300), generator=torch.Generator().manual_seed(8))
    low = A.tril().clone()
    M = gtc.mirror_lower(A)
    assert torch.equal(M, M.T)
    assert torch.equal(M.tril(), low)


def test_cpu_gram_tc_is_its_plain_version():
    X = _store("int4", 500, 130, 6)
    w2 = torch.rand(500) * 0.1
    u = w2 * torch.randn(500)
    before = gtc.gram_tc.launches
    G, t = gtc.gram_tc(X, w2, u, block=128)
    Gp, tp = gtc.gram_tc_plain(X, w2, u, block=128)
    assert torch.equal(G, Gp) and torch.equal(t, tp)
    assert gtc.gram_tc.launches == before
    with pytest.raises(TypeError):
        gtc.gram_tc(X.float(), w2, u)
    with pytest.raises(ValueError):
        gtc.gram_tc(X, w2.double(), u)
    with pytest.raises(ValueError):
        gtc.gram_tc(X, w2[:-1], u[:-1])


def _gram_before(dm, block: int = 16384) -> torch.Tensor:
    """spectral.gram as it was before the tensor-core route: the reference
    the CPU route must keep bit for bit."""
    acc = dm.wd
    X = dm.X
    m, n = dm.m_pad, int(dm.n)
    w2 = (dm.msig * dm.msig).to(acc)
    u = w2 * dm.mave.to(acc)
    G = torch.zeros((n, n), dtype=acc)
    t = torch.zeros(n, dtype=acc)
    block = max(1, min(block, m))
    for lo in range(0, m, block):
        hi = min(m, lo + block)
        Xb = unpack_rows(X[lo:hi], acc) if X.dtype == PACKED4_DTYPE else X[lo:hi].to(acc)
        G += (w2[lo:hi, None] * Xb).T @ Xb
        t += u[lo:hi] @ Xb
    s2 = (u * dm.mave.to(acc)).sum()
    K = (G - t[:, None] - t[None, :] + s2) * dm.inv_sqrt_n.to(acc) ** 2
    return 0.5 * (K + K.T)


@pytest.mark.parametrize("dtype", [torch.int8, PACKED4_DTYPE, torch.bfloat16, torch.float32,
                                   torch.float64])
def test_cpu_route_is_unchanged(dtype):
    raw = np.random.default_rng(9).normal(size=(700, 130))
    dm = build_design(raw, dtype)
    for block in (16384, 256):
        assert torch.equal(spectral.gram(dm, block=block), _gram_before(dm, block=block))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,n", [("int8", 20000, 1000), ("int4", 20000, 1000),
                                      ("bf16", 3000, 258), ("int8", 200, 130)])
def test_kernel_against_plain_on_card(cuda_device, kind, m, n):
    X = _store(kind, m, n, 12).to(cuda_device)
    g = torch.Generator().manual_seed(13)
    w2 = (torch.rand(m, generator=g) * 0.02 + 1e-4).to(cuda_device)
    u = w2 * torch.randn(m, generator=g).to(cuda_device)
    before = gtc.gram_tc.launches
    G, t = gtc.gram_tc(X, w2, u)
    Gp, tp = gtc.gram_tc_plain(X, w2, u)
    assert gtc.gram_tc.launches == before + 2 * -(-m // 16384)
    assert torch.equal(G, G.T)
    assert float((G - Gp).abs().max()) < 1e-5 * float(Gp.abs().max())
    assert float((t - tp).abs().max()) < 1e-5 * float(tp.abs().max())
    assert torch.equal(G, gtc.gram_tc(X, w2, u)[0])


@pytest.mark.cuda
def test_gram_routes_on_card(cuda_device):
    raw = np.random.default_rng(14).normal(size=(2000, 300))
    for dtype, launched in ((torch.int8, True), (torch.float32, False)):
        dm = build_design(raw, dtype, device=cuda_device)
        before = gtc.gram_tc.launches
        K = spectral.gram(dm).cpu()
        assert gtc.gram_tc.launches - before == (2 if launched else 0)
        K_cpu = _gram_before(build_design(raw, dtype))
        assert float((K - K_cpu).abs().max()) < 1e-5 * float(K_cpu.abs().max())
