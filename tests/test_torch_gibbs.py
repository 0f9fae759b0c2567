"""The port's Gibbs warm start (vampomi_tpu_torch/gibbs, ops/gibbs_block.py,
scripts/conf_gibbs_init.py and pip.py, cli --init-conf) against the JAX
package on the CPU.

Both packages run on one design (the JAX DesignMatrix carried over by
convert.py, built with mesh=None so that M is not padded) and one state
(convert.gibbs_state_from_arrays).  The two frameworks' RNGs cannot give the
same draws, so the port's sweeps take a draw source that replays the JAX
runner's key schedule with jax.random (`JaxDraws`).

Tolerances.  The block Grams and the local correlations c are f32 in both
packages for every design dtype, so inside a block the two agree to f32
rounding, not to f64; r0 = A^T y_resid and the sums of a sweep run in
another order in each package.  A categorical draw flips only when u_j lands
within that rounding of a cumulative weight, which these seeds do not hit, so
the components are compared exactly and x, y_resid and the hyperparameters
to rtol 1e-5 (atol 1e-6 of their scale where values pass through 0).  A
bf16 design's block passes differ more: JAX contracts bf16 x bf16 into f32,
rounding the f32 vector to bf16 first (up to 2^-9 of each entry), where the
port multiplies the upcast codes in f32 (ROADMAP's "bf16 torch.matmul rounds
its output").  One sweep from one state moves x by up to 5.8e-4, y_resid by
1.2e-3 (each over |ref| plus the vector's largest), mu, sigma_g and sigma_e
by 7.1e-4, 1.9e-4 and 1.3e-4, and h2, vg, sigma_g and mu of the stats by up
to 1.7e-3, so the bf16 sweep is held at 5e-3, under 3 times the largest."""

import os
import shutil
import struct
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu import gibbs as jgibbs
from vampomi_tpu.cli import main as jcli_main
from vampomi_tpu.cli import parse_config as jparse
from vampomi_tpu.gibbs import sampler as jsampler
from vampomi_tpu.ops import operator as jop
from vampomi_tpu.scripts import conf_gibbs_init as jcgi
from vampomi_tpu.scripts import pip as jpip
from vampomi_tpu_torch import cli as tcli
from vampomi_tpu_torch import convert
from vampomi_tpu_torch import gibbs as tgibbs
from vampomi_tpu_torch.gibbs import __main__ as tgibbs_main
from vampomi_tpu_torch.gibbs import sampler as tsampler
from vampomi_tpu_torch.io.csv_writer import read_positional_csv
from vampomi_tpu_torch.ops import gibbs_block as tblock
from vampomi_tpu_torch.ops.operator import PACKED4_DTYPE, build_design
from vampomi_tpu_torch.scripts import conf_gibbs_init as tcgi
from vampomi_tpu_torch.scripts import pip as tpip
from vampomi_tpu_torch.sim.data_sim import main as sim_main
from vampomi_tpu_torch.sim.data_sim import simulate_iid

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5
BF16_TOL = 5e-3
JDT = {"float64": jnp.float64, "float32": jnp.float32, "int8": jnp.int8,
       "bfloat16": jnp.bfloat16}
TDT = {"float64": torch.float64, "float32": torch.float32, "int8": torch.int8}
WORK = {"float64": "float64", "float32": "float32", "bfloat16": "float32"}  # the state's dtype


class JaxDraws:
    """A draw source replaying the JAX runner's keys: a split per sweep
    (vampomi_tpu/gibbs/runner.py:125, 134), then in the sweep a split for the
    blocks, fold_in(b) and (ku, kz) per block, kmu, and (kg, ke, kp)
    (vampomi_tpu/gibbs/sampler.py:201-257)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def block_draws(self, nb, block, dtype, device):
        self.key, ks = jax.random.split(self.key)
        self.k, ksweep = jax.random.split(ks)
        self.hyper = None
        jd = jnp.float64 if dtype == torch.float64 else jnp.float32
        u, z = [], []
        for b in range(nb):
            ku, kz = jax.random.split(jax.random.fold_in(ksweep, b))
            u.append(np.asarray(jax.random.uniform(ku, (block,), dtype=jd)))
            z.append(np.asarray(jax.random.normal(kz, (block,), dtype=jd)))
        return torch.tensor(np.stack(u)).to(device), torch.tensor(np.stack(z)).to(device)

    def normal(self):
        self.k, kmu = jax.random.split(self.k)
        return float(jax.random.normal(kmu, dtype=jnp.float64))

    def gamma(self, shape):
        if self.hyper is None:
            self.k, kg, ke, self.kp = jax.random.split(self.k, 4)
            self.hyper = [kg, ke]
        return float(jax.random.gamma(self.hyper.pop(0), shape, dtype=jnp.float64))

    def dirichlet(self, alpha):
        return np.asarray(jax.random.dirichlet(self.kp, jnp.asarray(alpha)))


def _arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _designs(X_rows, dtype):
    """The JAX design (mesh=None) and the port's copy of it."""
    jdm = jop.build_design(X_rows, mesh=None, compute_dtype=JDT[dtype])
    return jdm, convert.design_from_arrays(_arrays(jdm))


@pytest.fixture(scope="module")
def problem():
    """M = 512 markers x N = 128 samples, 10 causal; y standardized."""
    rng = np.random.default_rng(7)
    m, n = 512, 128
    X = rng.normal(size=(m, n))
    beta = np.zeros(m)
    beta[rng.choice(m, 10, replace=False)] = rng.normal(0, 0.5, 10)
    y = X.T @ beta + rng.normal(0, 1.0, n)
    return X, (y - y.mean()) / y.std(ddof=1)


# ---------------------------------------------------------------------------
# block Grams


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_block_grams_match_jax_float(problem, dtype):
    """f64, f32 and bf16 designs: both packages form A_b A_b^T from the same
    standardized rows (f64 products cast to f32, or f32 products at full
    precision; bf16 codes upcast to f32 first) — rtol 2e-5, atol 2e-6, the
    JAX test's f32 tolerance (tests/test_gibbs.py:39)."""
    jdm, tdm = _designs(problem[0], dtype)
    want = np.asarray(jgibbs.build_block_grams(jdm, block=64))
    got = tsampler.build_block_grams(tdm, block=64)
    assert got.dtype == torch.float32 and got.shape == (8, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_block_grams_int8_equal_jax(problem):
    """int8: the code products are exact integers in both packages and the
    affine corrections run in f32 in the same order, so the Grams agree to
    the last f32 rounding of the corrections (rtol 1e-6 of the largest)."""
    jdm, tdm = _designs(problem[0], "int8")
    want = np.asarray(jgibbs.build_block_grams(jdm, block=64))
    got = tsampler.build_block_grams(tdm, block=64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert np.mean(got == want) > 0.9


def test_block_grams_packed_against_f64(problem):
    """Packed int4: against the f64 Gram of the standardized codes
    ((q - mave) msig / sqrt(N), from the same bytes): rtol 2e-5, atol 2e-6
    (f32 corrections of exact integer products)."""
    tdm = build_design(problem[0], compute_dtype=PACKED4_DTYPE)
    got = tsampler.build_block_grams(tdm, block=64).numpy()
    codes = np.asarray(tsampler.unpack_rows(tdm.X, torch.float64))
    A = ((codes - tdm.mave.double().numpy()[:, None]) * tdm.msig.double().numpy()[:, None]
         / np.sqrt(tdm.n))
    for b in range(8):
        rows = A[b * 64:(b + 1) * 64]
        np.testing.assert_allclose(got[b], rows @ rows.T, rtol=2e-5, atol=2e-6)


def test_block_grams_int8_overflow_guard(problem):
    """An int8 design whose N would overflow the exact int32 code product
    (127^2 N >= 2^31) raises, as JAX's does (tests/test_gibbs.py:60-71)."""
    _, tdm = _designs(problem[0], "int8")
    fake = tdm._replace(n=float(2**31 // (127 * 127) + 1))
    with pytest.raises(ValueError, match="overflow"):
        tsampler.build_block_grams(fake, block=64)


@pytest.mark.parametrize("b,n", [(5, 13), (3, 20000)])
def test_codes_product_is_exact(b, n):
    """The CPU's code product (f64) is the exact integer product rounded
    once to f32, as the card's int32 product cast to f32 is: at a ragged
    shape and at sums past 2^24 (all codes -127)."""
    gen = torch.Generator().manual_seed(1)
    Xq = (torch.randint(-127, 128, (b, n), dtype=torch.int8, generator=gen) if n < 1000
          else torch.full((b, n), -127, dtype=torch.int8))
    q = Xq.long()
    assert torch.equal(tsampler._codes_product(Xq), (q @ q.T).to(torch.int32).float())


# ---------------------------------------------------------------------------
# the block update: plain version against JAX and the numpy oracle


def _block_inputs(B, L, dtype, seed=3, masked=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 200)) / np.sqrt(200)
    G = (A @ A.T).astype(np.float32)
    r0 = (rng.normal(size=B) * 2).astype(np.float32)
    xb0 = (rng.normal(size=B) * 0.3).astype(dtype)
    mmask = np.ones(B, dtype=dtype)
    mmask[B - masked:] = 0.0
    u = rng.uniform(size=B).astype(dtype)
    z = rng.normal(size=B).astype(dtype)
    pi = rng.dirichlet(np.ones(L))
    cvars = tsampler.decade_cvars(L)
    return G, r0, xb0, mmask, u, z, pi, cvars, 2.0, 0.6


def _oracle(G, r0, xb0, mmask, u, z, pi, cvars, sigma_g, sigma_e):
    """tests/test_gibbs.py:98-123, the numpy oracle of block_update."""
    B = len(xb0)
    psi = cvars * sigma_g
    c = r0.astype(np.float32).copy()
    x = xb0.astype(np.float64).copy()
    ks = np.zeros(B, dtype=int)
    safe_psi = np.where(psi > 0, psi, 1.0)
    for j in range(B):
        sjj = float(G[j, j])
        rj = float(c[j]) + sjj * x[j]
        v = 1.0 / (sjj / sigma_e + 1.0 / safe_psi)
        m = v * rj / sigma_e
        logl = np.where(psi > 0, np.log(pi) + 0.5 * (np.log(v) - np.log(safe_psi))
                        + 0.5 * m * m / v, np.log(pi))
        if mmask[j] <= 0:
            logl = np.where(psi > 0, -np.inf, 0.0)
        w = np.exp(logl - logl.max())
        cum = np.cumsum(w)
        k = int(np.sum(cum < u[j] * cum[-1]))
        xnew = (m[k] + np.sqrt(v[k]) * z[j]) if psi[k] > 0 else 0.0
        xnew *= mmask[j]
        c = c - G[j] * np.float32(xnew - x[j])
        x[j] = xnew
        ks[j] = k
    return x, ks


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B,L,dtype", [(32, 4, np.float64), (64, 2, np.float32),
                                       (48, 6, np.float64), (1, 4, np.float32)])
def test_block_update_plain_matches_jax_and_the_oracle(B, L, dtype):
    """Components equal, x to rtol 1e-5 (atol 1e-6), masked markers at 0."""
    args = _block_inputs(B, L, dtype, masked=min(3, B - 1) if B > 1 else 0)
    got_x, got_k = tsampler.block_update(*[_t(np.asarray(a)) for a in args[:8]],
                                         torch.tensor(args[8], dtype=torch.float64),
                                         torch.tensor(args[9], dtype=torch.float64))
    jx, jk = jgibbs.block_update(*[jnp.asarray(a) for a in args])
    ox, ok = _oracle(*args)
    assert got_x.dtype == TDT["float64" if dtype == np.float64 else "float32"]
    assert got_k.dtype == torch.int32
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(got_k.numpy(), ok)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_x.numpy(), ox, rtol=1e-5, atol=1e-6)
    masked = args[3] == 0
    assert np.all(got_x.numpy()[masked] == 0.0) and np.all(got_k.numpy()[masked] == 0)
    assert len(np.unique(got_k.numpy())) > 1 or B == 1


def test_block_update_wrapper_contract():
    """The wrapper checks dtypes, shapes and devices, and on CPU tensors runs
    the plain version without counting a launch."""
    args = [_t(np.asarray(a)) for a in _block_inputs(16, 3, np.float32)[:8]]
    sg, se = torch.tensor(1.0, dtype=torch.float64), torch.tensor(0.5, dtype=torch.float64)
    before = tblock.gibbs_block_update.launches
    x, k = tblock.gibbs_block_update(*args, sg, se)
    px, pk = tblock.gibbs_block_update_plain(*args, sg, se)
    assert torch.equal(x, px) and torch.equal(k, pk)
    assert tblock.gibbs_block_update.launches == before
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError, match="Gb must be float32"):
        tblock.gibbs_block_update(*bad, sg, se)
    bad = list(args)
    bad[4] = args[4].double()
    with pytest.raises(TypeError, match="u must be"):
        tblock.gibbs_block_update(*bad, sg, se)
    bad = list(args)
    bad[1] = args[1][:8]
    with pytest.raises(ValueError, match="r0 must be"):
        tblock.gibbs_block_update(*bad, sg, se)
    with pytest.raises(ValueError, match="0-d"):
        tblock.gibbs_block_update(*args, sg[None], se)
    with pytest.raises(TypeError, match="sigma_e must be float64"):
        tblock.gibbs_block_update(*args, sg, se.float())
    bad = list(args)
    bad[0] = args[0].T
    with pytest.raises(ValueError, match="contiguous"):
        tblock.gibbs_block_update(*bad, sg, se)


# ---------------------------------------------------------------------------
# one sweep from one state


def _jax_state_after(jdm, y, sweeps, l_comp=4, block=64, seed=5):
    """JAX's state after `sweeps` sweeps from the cold start, and the runner
    key that follows."""
    cvars = jnp.asarray(jgibbs.decade_cvars(l_comp), dtype=jnp.float64)
    grams = jgibbs.build_block_grams(jdm, block=block)
    state = jgibbs.init_state(jdm, y, l_comp)
    key = jax.random.PRNGKey(seed)
    for _ in range(sweeps):
        key, ks = jax.random.split(key)
        state = jgibbs.gibbs_sweep(jdm, grams, state, cvars, ks, block=block)
    return grams, state, cvars, key


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_gibbs_sweep_matches_jax_from_one_state(problem, dtype):
    """From JAX's state after 2 sweeps (x and comp not zero), one JAX sweep
    and one port sweep with JAX's draws replayed: the same components, and
    x, y_resid, mu, sigma_g, sigma_e and pi to rtol 1e-5 (bf16: 5e-3, and
    atol 5e-3 of the largest x and y_resid); the port's stats are those of
    JAX's sweep_stats on JAX's new state."""
    X, y = problem
    rtol, atol = (BF16_TOL, BF16_TOL) if dtype == "bfloat16" else (RTOL, 1e-6)
    wd = WORK[dtype]
    jdm, tdm = _designs(X, dtype)
    grams, jstate, cvars, key = _jax_state_after(jdm, y, 2)
    jarrays = _arrays(jstate)  # the JAX sweep donates its state
    tstate = convert.gibbs_state_from_arrays(jarrays)
    assert tstate.x.dtype == TDT[wd] and int((tstate.comp > 0).sum()) > 0
    draws = JaxDraws(0)
    draws.key = key
    key, ks = jax.random.split(key)
    jnew = jgibbs.gibbs_sweep(jdm, grams, jstate, cvars, ks, block=64)
    tgrams = tsampler.build_block_grams(tdm, block=64)
    tnew, st = tsampler.gibbs_sweep(tdm, tgrams, tstate, torch.as_tensor(np.array(cvars)),
                                    draws, torch.as_tensor(y).to(TDT[wd]), block=64)
    np.testing.assert_array_equal(tnew.comp.numpy(), np.asarray(jnew.comp))
    scale = np.abs(np.asarray(jnew.x)).max()
    np.testing.assert_allclose(tnew.x.numpy(), np.asarray(jnew.x), rtol=rtol, atol=atol * scale)
    np.testing.assert_allclose(tnew.y_resid.numpy(), np.asarray(jnew.y_resid), rtol=rtol,
                               atol=atol * np.abs(np.asarray(jnew.y_resid)).max())
    for f in ("mu", "sigma_g", "sigma_e", "pi"):
        np.testing.assert_allclose(getattr(tnew, f).numpy(), np.asarray(getattr(jnew, f)),
                                   rtol=rtol, err_msg=f)
    jh2, jm, jvg = jsampler.sweep_stats(jdm, jnew, jnp.asarray(y, dtype=JDT[wd]))
    assert st.m_incl == int(jm) == int(tnew.comp.gt(0).sum())
    assert st.enqueue_s > 0.0  # the host's block loop, timed by the sweep
    np.testing.assert_allclose([st.h2, st.vg, st.sigma_g, st.mu],
                               [float(jh2), float(jvg), float(jnew.sigma_g), float(jnew.mu)],
                               rtol=rtol)
    # the state handed in is left as it was
    assert np.array_equal(tstate.x.numpy(), jarrays["x"])


def test_sweep_stats_match_jax(problem):
    X, y = problem
    jdm, tdm = _designs(X, "float64")
    _, jstate, _, _ = _jax_state_after(jdm, y, 2)
    tstate = convert.gibbs_state_from_arrays(_arrays(jstate))
    h2, m_incl, vg = tsampler.sweep_stats(tdm, tstate, torch.as_tensor(y))
    jh2, jm, jvg = jsampler.sweep_stats(jdm, jstate, jnp.asarray(y))
    assert int(m_incl) == int(jm)
    np.testing.assert_allclose([float(h2), float(vg)], [float(jh2), float(jvg)], rtol=1e-12)


def test_init_state_and_ladder_match_jax(problem):
    X, y = problem
    jdm, tdm = _designs(X, "float32")
    j, t = jgibbs.init_state(jdm, y, 5, h2_init=0.3), tsampler.init_state(tdm, y, 5, h2_init=0.3)
    for f in j._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
        assert str(getattr(t, f).dtype).split(".")[-1] == str(np.asarray(getattr(j, f)).dtype)
    np.testing.assert_array_equal(tsampler.decade_cvars(5), jgibbs.decade_cvars(5))


def test_packed_sweep_equals_int8_sweep_on_the_same_codes(problem):
    """A packed-int4 design and an int8 design holding the same 4-bit codes
    (and the same mave, msig) run the same sweep: the two operators and
    Gram paths compute the same f32 products of the same integers."""
    t4 = build_design(problem[0], compute_dtype=PACKED4_DTYPE)
    codes = tsampler.unpack_rows(t4.X, torch.int8).contiguous()
    t8 = t4._replace(X=codes)
    y = problem[1]
    outs = []
    for dm in (t4, t8):
        grams = tsampler.build_block_grams(dm, block=64)
        state = tsampler.init_state(dm, y, 3)
        for _ in range(2):
            state, st = tsampler.gibbs_sweep(dm, grams, state, torch.as_tensor(
                tsampler.decade_cvars(3)), tsampler.TorchDraws(11),
                torch.as_tensor(y, dtype=torch.float32), block=64)
        outs.append((state, st))
    (a, sa), (b, sb) = outs
    np.testing.assert_array_equal(a.comp.numpy(), b.comp.numpy())
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose([sa.sigma_g, sa.sigma_e], [sb.sigma_g, sb.sigma_e], rtol=1e-6)


def test_torch_draws_are_seeded():
    """One seed gives the same draws (the card and the CPU share them)."""
    a, b = tsampler.TorchDraws(4), tsampler.TorchDraws(4)
    ua, za = a.block_draws(3, 8, torch.float32, "cpu")
    ub, zb = b.block_draws(3, 8, torch.float32, "cpu")
    assert torch.equal(ua, ub) and torch.equal(za, zb) and ua.shape == (3, 8)
    assert 0.0 <= float(ua.min()) and float(ua.max()) < 1.0
    assert [a.normal(), a.gamma(3.0)] == [b.normal(), b.gamma(3.0)]
    np.testing.assert_array_equal(a.dirichlet(np.ones(4)), b.dirichlet(np.ones(4)))


# ---------------------------------------------------------------------------
# the runner end to end, and the consumers of its files


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run_gibbs of both packages on one f64 design, 8 sweeps (burnin 4),
    the port with JAX's draws replayed."""
    fx = simulate_iid(n=160, m=256, lam=0.08, h2=0.7, seed=9)
    y = fx.y / np.std(fx.y, ddof=1)
    jdm, tdm = _designs(fx.X.T, "float64")
    jd, td = tmp_path_factory.mktemp("jax_g"), tmp_path_factory.mktemp("torch_g")
    kw = dict(iterations=8, burnin=4, l_comp=4, block=64, seed=4, out_name="g", verbose=False)
    jres = jgibbs.run_gibbs(jdm, y, out_dir=str(jd), **kw)
    tres = tgibbs.run_gibbs(tdm, y, out_dir=str(td), draws=JaxDraws(4), **kw)
    return jres, tres


def _csv_rows(path):
    return [line.split(",") for line in open(path).read().splitlines()]


def test_run_gibbs_csv_matches_jax(runs):
    """Same rows and columns (8 + L), the integer columns exact, the rest
    to rtol 1e-5."""
    jres, tres = runs
    jr, tr = _csv_rows(jres.csv_path), _csv_rows(tres.csv_path)
    assert len(tr) == len(jr) == 8 and {len(r) for r in tr} == {len(r) for r in jr} == {12}
    for a, b in zip(tr, jr):
        assert (a[0], a[5], a[7]) == (b[0], b[5], b[7])
        np.testing.assert_allclose([float(v) for v in a], [float(v) for v in b],
                                   rtol=RTOL, atol=1e-12)
    assert tres.sweeps == 8 and len(tres.sweep_seconds) == 8 and tres.gram_seconds >= 0


def test_run_gibbs_bet_and_grm_match_jax(runs):
    """.bet: the uint32 marker count, then 8 records of [uint32 iteration,
    256 f64]: the same length, header and iteration numbers, betas to rtol
    1e-5; .grm one line of 4 values to rtol 1e-5; the result's means too."""
    jres, tres = runs
    tb, jb = open(tres.bet_path, "rb").read(), open(jres.bet_path, "rb").read()
    assert len(tb) == len(jb) == 4 + 8 * (4 + 256 * 8)
    assert tb[:4] == jb[:4] == struct.pack("I", 256)
    rec = 4 + 256 * 8
    for i in range(8):
        a, b = tb[4 + i * rec:4 + (i + 1) * rec], jb[4 + i * rec:4 + (i + 1) * rec]
        assert a[:4] == b[:4] == struct.pack("I", i + 1)
        bj = np.frombuffer(b[4:], "<f8")
        np.testing.assert_allclose(np.frombuffer(a[4:], "<f8"), bj, rtol=RTOL,
                                   atol=1e-6 * np.abs(bj).max())
    tg, jg = open(tres.grm_path).read(), open(jres.grm_path).read()
    assert tg.endswith("\n") and len(tg.split()) == len(jg.split()) == 4
    np.testing.assert_allclose([float(v) for v in tg.split()], [float(v) for v in jg.split()],
                               rtol=RTOL)
    np.testing.assert_allclose(tres.pip, jres.pip)
    np.testing.assert_allclose([tres.h2_mean, tres.sigma_g_mean, tres.sigma_e_mean],
                               [jres.h2_mean, jres.sigma_g_mean, jres.sigma_e_mean], rtol=RTOL)
    np.testing.assert_allclose(tres.x_mean_file, jres.x_mean_file, rtol=RTOL,
                               atol=1e-6 * np.abs(jres.x_mean_file).max())


def test_conf_gibbs_init_and_pip_are_byte_identical_to_jax(runs, tmp_path):
    """Both packages' scripts on the same input files write the same bytes
    (with and without the .grm; pip over a window)."""
    jres, _ = runs
    outs = {}
    for name, cgi, pipmod in (("jax", jcgi, jpip), ("torch", tcgi, tpip)):
        d = tmp_path / name
        d.mkdir()
        bet = str(d / "g.bet")
        shutil.copy(jres.bet_path, bet)
        conf = cgi.main(["-csv", jres.csv_path, "-grm", jres.grm_path, "-out_dir", str(d),
                         "-iterations", "2:8", "-rho", "0.4"])
        conf_b = open(conf, "rb").read()
        os.remove(conf)
        nogrm = cgi.main(["-csv", jres.csv_path, "-out_dir", str(d), "-iterations", "4:8"])
        pip = pipmod.main(["-bet", bet, "-iterations", "3:8"])
        outs[name] = (conf_b, open(nogrm, "rb").read(), open(str(d / "g.pip"), "rb").read(), pip)
    (a1, a2, a3, ap), (b1, b2, b3, bp) = outs["torch"], outs["jax"]
    assert a1 == b1 and a2 == b2 and a3 == b3
    assert b"\t" in a1 and len(ap) == 256
    np.testing.assert_array_equal(ap, bp)


# ---------------------------------------------------------------------------
# --init-conf


CONF = "ID\trho\tmix_comp\tlambda\tprobs\tvars\th2\n0\t0.35\t3\t0.05\t0.95,0.03,0.02\t0.0,0.001,0.01\t0.42\n"


@pytest.mark.parametrize("extra", [[], ["--probs", "0.5,0.3,0.2"], ["--vars", "0.0,0.002,0.02"],
                                   ["--rho", "0.9", "--h2", "0.1"]],
                         ids=["conf", "probs_win", "vars_win", "conf_wins_rho_h2"])
def test_init_conf_parses_as_jax_does(tmp_path, extra):
    """The .conf sets rho, h2, probs and vars; an explicit --probs or --vars
    still wins; the .conf wins over --rho and --h2 (vampomi_tpu/cli.py:148-155)."""
    conf = tmp_path / "g.conf"
    conf.write_text(CONF)
    argv = ["--meth-file", "m.bin", "--init-conf", str(conf)] + extra
    t, j = tcli.parse_config(argv), jparse(argv)
    assert (t.rho, t.h2, t.probs, t.vars) == (j.rho, j.h2, j.probs, j.vars)
    assert tcli.load_init_conf(str(conf)) == dict(rho=0.35, h2=0.42, probs=[0.95, 0.03, 0.02],
                                                  vars=[0.0, 0.001, 0.01])


def test_init_conf_infere_run_matches_jax(tmp_path):
    """A CPU infere run from a .conf (eigen, 6 iterations) against the JAX
    CLI with the same .conf: the same files, the params CSV to rtol 1e-5,
    the estimates to rtol 1e-5, and iteration 1's prior is the .conf's."""
    d = str(tmp_path)
    sim_main(["--out-dir", d, "--out-name", "ex", "-N", "200", "-M", "256", "--seed", "11"])
    (tmp_path / "g.conf").write_text(CONF)

    def argv(out):
        return ["--run-mode", "infere", "--meth-file", f"{d}/ex.bin", "--phen-file",
                f"{d}/ex.phen", "--true-signal-file", f"{d}/ex_ts.bin", "--N", "200", "--Mt",
                "256", "--out-dir", d, "--out-name", out, "--iterations", "6",
                "--lmmse-solver", "eigen", "--init-conf", f"{d}/g.conf"]

    assert jcli_main(argv("jx")) in (0, None)
    assert tcli.main(argv("pt") + ["--device", "cpu"]) == 0
    for name in ("params", "prior", "metrics"):
        got = np.asarray(read_positional_csv(f"{d}/pt_{name}.csv"))
        want = np.asarray(read_positional_csv(f"{d}/jx_{name}.csv"))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9, err_msg=name)
    prior = read_positional_csv(f"{d}/pt_prior.csv")[0]  # EM starts at iteration 2
    assert prior[:2] == [1, 3]
    np.testing.assert_allclose(prior[2:], [0.95, 0.03, 0.02, 0.0, 0.001, 0.01], rtol=1e-12)
    for it in (1, 6):
        got, want = np.fromfile(f"{d}/pt_it_{it}.bin"), np.fromfile(f"{d}/jx_it_{it}.bin")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the Gibbs CLI and the whole workflow on the CPU


def test_gibbs_cli_refuses_bf16_and_needs_a_card_by_default(monkeypatch, tmp_path):
    """bf16, refused before the port ran it, now samples (its three files
    written); the default device without a card still raises before any
    work."""
    d = tmp_path / "bf16"
    d.mkdir()
    sim_main(["--out-dir", str(d), "--out-name", "ex", "-N", "60", "-M", "128", "--seed", "2"])
    assert tgibbs_main.main(["--meth-file", str(d / "ex.bin"), "--phen-file", str(d / "ex.phen"),
                             "--N", "60", "--Mt", "128", "--out-dir", str(d), "--iterations",
                             "3", "--block", "64", "--compute-dtype", "bfloat16",
                             "--device", "cpu"]) == 0
    assert all(os.path.getsize(d / f"gibbs.{ext}") > 0 for ext in ("csv", "bet", "grm"))
    argv = ["--meth-file", str(tmp_path / "missing.bin"), "--phen-file", "p", "--N", "10",
            "--Mt", "10", "--out-dir", str(tmp_path / "none")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tgibbs_main.main(argv)
    assert not (tmp_path / "none").exists()


def test_gibbs_cli_matches_the_jax_cli_files(tmp_path):
    """Both Gibbs CLIs on one fixture (f64, 5 sweeps): the same three files
    of the same shapes (the draws differ, so not the same values)."""
    d = str(tmp_path)
    sim_main(["--out-dir", d, "--out-name", "ex", "-N", "120", "-M", "192", "--seed", "3"])
    base = ["--meth-file", f"{d}/ex.bin", "--phen-file", f"{d}/ex.phen", "--N", "120", "--Mt",
            "192", "--out-dir", d, "--iterations", "5", "--block", "64",
            "--compute-dtype", "float64"]
    jgibbs_main = __import__("vampomi_tpu.gibbs.__main__", fromlist=["main"])
    jgibbs_main.main(base + ["--out-name", "jx"])
    assert tgibbs_main.main(base + ["--out-name", "pt", "--device", "cpu"]) == 0
    for ext in ("csv", "bet", "grm"):
        assert os.path.getsize(f"{d}/pt.{ext}") > 0
    assert os.path.getsize(f"{d}/pt.bet") == os.path.getsize(f"{d}/jx.bet") == 4 + 5 * (4 + 192 * 8)
    assert [len(r) for r in _csv_rows(f"{d}/pt.csv")] == [len(r) for r in _csv_rows(f"{d}/jx.csv")]


def test_chip_smoke_gibbs_workflow_runs_on_the_cpu(tmp_path):
    """chip_smoke's workflow phase at a toy size with --device cpu: gibbs,
    conf_gibbs_init, pip and cli --init-conf through files (the card runs it
    at N = 2,000 x M = 8,000)."""
    chip_smoke.phase_gibbs_workflow("cpu", str(tmp_path), n=120, m=256, sweeps=6, iters=4)


def test_chip_smoke_gibbs_parity_runs_on_the_cpu():
    """chip_smoke's card-against-CPU phase at a toy size with the CPU in the
    card's place, packed int4 and bf16: the Grams, the sweeps and the
    comparisons run (the card runs it at M = 16,384 x N = 2,048)."""
    chip_smoke.phase_gibbs_parity("cpu", "int4", m=1024, n=256, sweeps=2)
    chip_smoke.phase_gibbs_parity("cpu", "bf16", m=1024, n=256, sweeps=2)
