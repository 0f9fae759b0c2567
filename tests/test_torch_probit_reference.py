"""The port's probit GLM-VAMP (engine/probit.py infere_bin_class) on the CPU
against the benchmark's plain probit reference
(benchmark/reference/gvamp_probit.py), which works the fit out again from
the codes, the labels and the seed, independently of the port and of the
JAX package.

In float64 the port follows the reference's trajectory to the bar that
tests/test_torch_probit.py holds it to against the JAX package.  With
int8 codes the port's float32 fit is held to the bar of the benchmark's
probit cell, read as that cell reads it (benchmark/models/probit.py
`readings`), at the cell's M/N on a small design; the reference in TF32
in the program's place, and the port with its beta1 moved by one part in
10^3, fail that bar."""

import math

import numpy as np
import pytest
import torch

from benchmark.models import probit as bm
from benchmark.reference import gvamp, gvamp_probit
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import probit as tprob
from vampomi_tpu_torch.glm.probit import g1_bin_class, g1d_bin_class
from vampomi_tpu_torch.ops.operator import build_design, design_from_codes

SETTINGS = dict(rho=0.5, gam1=1e-6, learn_vars=1, probit_var=1.0)
CONFIG = {"h2": 0.8, "run_config": dict(SETTINGS, stop_criteria_thr=0.0)}
SEED = 2**33 + 17
# the cell's head: the params rows and correlations of iterations 1-4,
# |port - reference| / max(1, |reference|).  The float32 port reads ~1e-6
# here (float32's 6e-8 grown by the LMMSE steps at M/N ~ 100: beta2 =
# (M/N)(1 - alpha2) multiplies alpha2's error by ~100 / (1 - alpha2)); the
# TF32 control, one step below float32, reads 1e-2 and more from iteration 2
INT8_BAR = 1e-4


def _codes(m, n, seed):
    return torch.randint(-127, 128, (m, n), dtype=torch.int8,
                         generator=torch.Generator().manual_seed(seed))


def _labels(codes, per_causal):
    return bm.phenotype(codes, False, codes.shape[1], SEED, 0, CONFIG,
                        {"markers_per_causal": per_causal})


def _port(dm, ph, iterations):
    cfg = RunConfig(model="bin_class", iterations=iterations, lmmse_solver="eigen",
                    device="cpu", seed=SEED, probs=ph.probs, vars=ph.vars,
                    stop_criteria_thr=0.0, **SETTINGS)
    return tprob.infere_bin_class(dm, ph.y, cfg, true_signal=ph.beta, write_outputs=False)


def _inputs(ph):
    return bm.Inputs(y=ph.y, beta=ph.beta, probs=ph.probs, vars=ph.vars, seed=SEED)


def _distance(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_float64_trajectory_follows_the_reference():
    """10 iterations at M = 2,048 x N = 256 in float64: every params row
    (rtol 1e-6 an entry), both correlations, and the returned x1 and r1
    (relative distance 1e-6), the bar of the port against JAX."""
    codes = _codes(2048, 256, 3)
    ph = _labels(codes, 64)
    dm = build_design(codes.numpy().astype(np.float64), compute_dtype=torch.float64)
    res = _port(dm, ph, 10)
    ref = bm.Reference(codes, False)
    want = ref.fits([_inputs(ph)], CONFIG, 10)[0]
    got = bm.answer_of(res)
    assert res.iterations_run == 10 and len(res.params_history) == 10
    np.testing.assert_allclose(np.asarray(got.rows), np.asarray(want.rows), rtol=1e-6,
                               atol=1e-300)
    assert _distance(got.x1, want.x1) < 1e-6
    assert _distance(got.r1, want.r1) < 1e-6
    assert got.last == pytest.approx(want.last, rel=1e-9)


@pytest.fixture(scope="module")
def int8_case():
    """The small cell's design (26,112 x 256, the full size's M/N) in int8,
    its labels, the port's 4 iterations and the reference's."""
    torch.set_num_threads(4)
    codes = _codes(26_112, 256, 5)
    ph = _labels(codes, 1024)
    ref = bm.Reference(codes, False)
    follow = ref.fits([_inputs(ph)], CONFIG, 4)
    return codes, ph, ref, follow


def _head_gap(answer, case):
    codes, ph, ref, follow = case
    return bm.readings([answer], [_inputs(ph)], ref, CONFIG, 4, follow)["head_gap"]


def test_int8_port_within_the_cells_bar(int8_case):
    codes, ph, _, _ = int8_case
    res = _port(design_from_codes(codes), ph, 4)
    assert 0 < _head_gap(bm.answer_of(res), int8_case) < INT8_BAR / 10


def test_the_tf32_control_fails_the_bar(int8_case):
    codes, ph, _, _ = int8_case
    control = bm.Reference(codes, False, "tf32").fits([_inputs(ph)], CONFIG, 4)[0]
    assert _head_gap(control, int8_case) > INT8_BAR


def test_beta1_moved_fails_the_bar(int8_case, monkeypatch):
    codes, ph, _, _ = int8_case
    monkeypatch.setattr(tprob, "g1d_bin_class", lambda *a: g1d_bin_class(*a) * (1 + 1e-3))
    res = _port(design_from_codes(codes), ph, 4)
    assert _head_gap(bm.answer_of(res), int8_case) > INT8_BAR


@pytest.mark.parametrize("tau1", [1e-6, 0.3, 40.0])
def test_z_denoiser_against_the_ports(tau1):
    """The reference's erfcx form of phi/Phi and the port's log_ndtr form,
    both float64, over labels that agree and disagree with p far into the
    tails."""
    p = torch.linspace(-60.0, 60.0, 2001, dtype=torch.float64)
    for label in (0.0, 1.0):
        y = torch.full_like(p, label)
        g, gd_sum = gvamp_probit.z_denoise(p, tau1, y, 1.0)
        np.testing.assert_allclose(g.numpy(), g1_bin_class(p, tau1, y).numpy(), rtol=1e-12,
                                   atol=1e-12)
        # far below t = 0 the sum t + m cancels (m -> -t): there each form
        # keeps ~10 digits of g' (the two read at most 1e-10 apart an entry)
        gd = g1d_bin_class(p, tau1, y)
        assert gd_sum == pytest.approx(float(gd.sum()), abs=1e-9 * p.numel())


def test_the_starting_p1_is_the_engines_draw():
    gen = torch.Generator().manual_seed(SEED)
    want = tprob._draw_p1(gen, 300, torch.float64, torch.device("cpu"))
    assert torch.equal(gvamp_probit.start_p1(SEED, 300), want)


def test_tail_row_against_dense():
    m, n = 300, 48
    codes = _codes(m, n, 9)
    c = codes.double()
    A = ((c - c.mean(1, keepdim=True)) / c.std(1, keepdim=True)).T / math.sqrt(n)
    rng = np.random.default_rng(4)
    x1, ts = torch.as_tensor(rng.normal(size=m)), torch.as_tensor(rng.normal(size=m))
    y = torch.as_tensor((rng.normal(size=n) > 0).astype(np.float64))
    z = A @ x1
    want = [float(((z >= 0).double() == y).double().mean()),
            float(x1 @ ts / math.sqrt(float(x1 @ x1) * float(ts @ ts)))]
    got = gvamp_probit.tail_row(gvamp.Design(codes, False), x1, y, ts)
    assert got == pytest.approx(want, rel=1e-12)
