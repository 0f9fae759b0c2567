"""The plain reference (benchmark/reference/gvamp.py) on the CPU, at small
sizes, against cases derived by hand: the standardized operator and its
Gram against the dense matrix, the packed layout, TF32 rounding, the
denoiser and the EM step written out per marker, and a first iteration
solved densely."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import gvamp


def _dense(codes: np.ndarray) -> np.ndarray:
    """The standardized (N, M) design of (M, N) codes: sd with N - 1."""
    n = codes.shape[1]
    c = codes.astype(np.float64)
    mu = c.mean(axis=1, keepdims=True)
    sd = np.sqrt(((c - mu) ** 2).sum(axis=1, keepdims=True) / (n - 1))
    return ((c - mu) / sd).T / math.sqrt(n)


def _codes(m, n, seed=0):
    return torch.randint(-127, 128, (m, n), dtype=torch.int8,
                         generator=torch.Generator().manual_seed(seed))


def test_unpack_layout():
    # low nibble sample j, high nibble sample j + N/2, both biased by 8
    packed = torch.tensor([[0x0F, 0x80], [0x78, 0x18]], dtype=torch.uint8)
    want = [[7, -8, -8, 0], [0, 0, -1, -7]]
    assert gvamp.unpack_codes(packed, torch.float64).tolist() == want


@pytest.mark.parametrize("packed", [False, True])
def test_operator_and_gram_against_dense(packed):
    m, n = 300, 48
    if packed:
        raw = torch.randint(0, 256, (m, n // 2), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(3))
        codes = gvamp.unpack_codes(raw, torch.float64).numpy()
    else:
        raw = _codes(m, n)
        codes = raw.numpy()
    A = _dense(codes)
    d = gvamp.Design(raw, packed)
    d.rows = 7  # several blocks, the last one short
    X = np.random.default_rng(1).normal(size=(m, 2))
    Y = np.random.default_rng(2).normal(size=(n, 3))
    np.testing.assert_allclose(d.ax(torch.as_tensor(X)).numpy(), A @ X, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(d.atx(torch.as_tensor(Y)).numpy(), A.T @ Y, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(d.gram().numpy(), A @ A.T, rtol=1e-12, atol=1e-12)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -1.5 - 2.0**-11,
                      1.0 + 2.0**-11 + 2.0**-20])
    want = [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -1.5 - 2.0**-10, 1.0 + 2.0**-10]
    assert gvamp.round_tf32(x).tolist() == want
    r = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    rel = ((gvamp.round_tf32(r) - r).abs() / r.abs()).max()
    assert 2.0**-12 < rel <= 2.0**-11


def test_tf32_design_rounds_its_products():
    m, n = 500, 64
    d64, d32 = gvamp.Design(_codes(m, n), False), gvamp.Design(_codes(m, n), False, "tf32")
    X = torch.randn(m, 1, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    err = ((d32.ax(X).double() - d64.ax(X)).abs().max() / d64.ax(X).abs().max()).item()
    assert 1e-6 < err < 2e-3  # TF32's 2^-11, not float32's 2^-24


def test_denoiser_by_hand():
    prior = gvamp.Prior(probs=[0.9, 0.1], vars=[0.0, 2.0])
    gam1 = 0.5  # sigma = 2
    r = torch.tensor([-1.5, 0.0, 0.3, 4.0], dtype=torch.float64)
    g, dg = gvamp.denoise(r, gam1, prior)
    for i, ri in enumerate(r.tolist()):
        # posterior of a spike-and-slab: the slab's weight times its shrinkage
        spike = 0.9 * math.exp(-ri * ri / 4) / math.sqrt(2)
        slab = 0.1 * math.exp(-ri * ri / 8) / math.sqrt(4)
        w = slab / (spike + slab)
        assert g[i].item() == pytest.approx(w * ri * 0.5, rel=1e-12, abs=1e-15)
        h = 1e-6
        gp = gvamp.denoise(torch.tensor([ri + h], dtype=torch.float64), gam1, prior)[0]
        gm = gvamp.denoise(torch.tensor([ri - h], dtype=torch.float64), gam1, prior)[0]
        assert dg[i].item() == pytest.approx(((gp - gm) / (2 * h)).item(), rel=1e-6, abs=1e-9)


def test_em_step_by_hand():
    r1 = torch.tensor([0.2, -1.0, 3.0], dtype=torch.float64)
    gam1, prior = 0.25, gvamp.Prior(probs=[0.8, 0.2], vars=[0.0, 5.0])
    nv, v = 4.0, 5.0
    pins, resg = [], []
    for r in r1.tolist():
        slab = 0.2 * math.exp(-r * r / 2 / (v + nv)) / math.sqrt(2 * math.pi * (v + nv))
        spike = 0.8 * math.exp(-r * r / 2 / nv) / math.sqrt(2 * math.pi * nv)
        pin = slab / (slab + spike)
        mean = gam1 * r / (1 / v + gam1)
        pins.append(pin)
        resg.append(pin * (mean * mean + 1 / (1 / v + gam1)))
    out = gvamp.em_step(r1, gam1, prior, learn_vars=True)
    lam = sum(pins) / 3
    assert out.probs == pytest.approx([1 - lam, lam], rel=1e-12)
    assert out.vars == pytest.approx([0.0, sum(resg) / sum(pins)], rel=1e-12)
    assert gvamp.em_step(r1, gam1, prior, learn_vars=False).vars == [0.0, 5.0]


def test_em_merge_erases_the_later_component():
    r1 = torch.linspace(-2, 2, 50, dtype=torch.float64)
    out = gvamp.em_step(r1, 1.0, gvamp.Prior(probs=[0.5, 0.25, 0.25], vars=[0.0, 1.0, 1.2]),
                        learn_vars=False)
    assert len(out.probs) == 2 and out.vars == [0.0, 1.0]
    assert sum(out.probs) == pytest.approx(1.0)


def test_first_iteration_solved_densely():
    m, n, h2 = 400, 40, 0.8
    codes = _codes(m, n, 7)
    A = _dense(codes.numpy())
    rng = np.random.default_rng(5)
    beta = np.zeros(m)
    beta[rng.choice(m, 8, replace=False)] = rng.normal(0, 0.3, 8)
    y = A @ beta * math.sqrt(n) + rng.normal(0, 0.5, n)
    prior = gvamp.Prior(probs=[0.98, 0.02], vars=[0.0, 0.1])
    d = gvamp.Design(codes, False)
    ans = gvamp.run(d, gvamp.eigen_of(d.gram()), torch.as_tensor(y), torch.as_tensor(beta),
                    prior, iterations=1, h2=h2)
    # iteration 1 from x1 = r1 = 0: alpha1 = mean g1'(0), gam2 = gam1/alpha1 - gam1,
    # x2 = (gamw A^T A + gam2 I)^{-1} gamw A^T y
    gam1, gamw = 1e-6, 1 / (1 - h2)
    sigma = 1 / gam1
    vs = np.array([0.0, 0.1 * n])
    w = np.array([0.98, 0.02]) / np.sqrt(vs + sigma)
    w /= w.sum()
    alpha1 = float((w * vs / (vs + sigma)).sum())
    gam2 = gam1 / alpha1 - gam1
    x2 = np.linalg.solve(gamw * A.T @ A + gam2 * np.eye(m), gamw * A.T @ y)
    z2 = A @ x2
    r2 = 1 - np.sum((y - z2) ** 2) / np.sum(y * y)
    corr = lambda a, b: a @ b / math.sqrt((a @ a) * (b @ b))  # noqa: E731
    np.testing.assert_allclose(ans.rows[0], [0.0, 0.0, r2, corr(x2, beta), 0.0, corr(z2, y) ** 2],
                               rtol=1e-9, atol=1e-12)
    # the state after it: x1 = g1(0) = 0, so r2 = 0; alpha2 = gam2 tr(P^{-1}) / M with
    # P = gamw A^T A + gam2 I; gam1 damped by rho = 1/2; r1 = eta2 x2 / gam1, in file units
    # over sqrt(N); gamw = N / (|y - z2|^2 + tr(A^T A P^{-1}))
    Pinv = np.linalg.inv(gamw * A.T @ A + gam2 * np.eye(m))
    eta2 = gam2 / (gam2 * np.trace(Pinv) / m)
    gam1_new = 0.5 * (eta2 - gam2) + 0.5 * gam1
    assert ans.gam1 == pytest.approx(gam1_new, rel=1e-9)
    assert ans.gamw == pytest.approx(n / (np.sum((y - z2) ** 2) + np.trace(A.T @ A @ Pinv)),
                                     rel=1e-9)
    np.testing.assert_allclose(ans.r1.numpy(), eta2 * x2 / gam1_new / math.sqrt(n), rtol=1e-8)
    assert not ans.x1.any()


@pytest.mark.parametrize("packed", [False, True])
def test_tail_row_against_dense(packed):
    m, n = 300, 48
    if packed:
        codes = torch.randint(0, 256, (m, n // 2), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(3))
        A = _dense(gvamp.unpack_codes(codes, torch.float64).numpy())
    else:
        codes = _codes(m, n, 3)
        A = _dense(codes.numpy())
    rng = np.random.default_rng(9)
    x1, y, ts = rng.normal(size=m), rng.normal(size=n), rng.normal(size=m)
    z1 = A @ (x1 * math.sqrt(n))
    corr = lambda a, b: a @ b / math.sqrt((a @ a) * (b @ b))  # noqa: E731
    want = [1 - np.sum((y - z1) ** 2) / np.sum(y * y), corr(x1, ts), corr(z1, y) ** 2]
    got = gvamp.tail_row(gvamp.Design(codes, packed), torch.as_tensor(x1), torch.as_tensor(y),
                         torch.as_tensor(ts))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_probes_are_the_engines():
    from vampomi_tpu_torch.engine.linear import _draw_probe
    from vampomi_tpu_torch.ops.operator import design_from_codes
    dm = design_from_codes(_codes(64, 16))
    g = torch.Generator().manual_seed(987654321012)
    engine = [_draw_probe(g, dm).double() for _ in range(3)]
    for a, b in zip(gvamp.probes(987654321012, 64, 3), engine):
        assert torch.equal(a.to(torch.float32).double(), b)
