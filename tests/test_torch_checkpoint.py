"""Exact-state checkpoint/resume in the port (vampomi_tpu_torch/engine/
checkpoint.py and both engines), the counterparts of
tests/test_checkpoint_telemetry.py:28-160, and a JAX-written checkpoint
resumed in the port (convert.py checkpoint_from_jax).

A resumed run is held BITWISE to the uninterrupted one (the state is saved
in f64 and every kernel and draw is repeatable); the run resumed from a JAX
checkpoint is held to JAX's own uninterrupted f64 run at the eigen
trajectory tolerance of test_torch_engine_linear.py (rtol 1e-6: two eigh
implementations)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.config import RunConfig as JConfig
from vampomi_tpu.engine import linear as jlin
from vampomi_tpu.engine import probit as jprob
from vampomi_tpu.ops import operator as jop
from vampomi_tpu_torch import api, convert
from vampomi_tpu_torch.config import RunConfig
from vampomi_tpu_torch.engine import checkpoint as tck
from vampomi_tpu_torch.engine import linear as tlin
from vampomi_tpu_torch.engine import probit as tprob
from vampomi_tpu_torch.io.csv_writer import read_positional_csv
from vampomi_tpu_torch.ops.operator import build_design
from vampomi_tpu_torch.sim.data_sim import simulate_iid

torch.set_num_threads(2)

PROBS3 = [0.9, 0.07, 0.03]
VARS3 = [0.0, 1e-3, 1e-2]


def kw(tmp, **extra):
    d = dict(out_dir=str(tmp), out_name="ck", iterations=6, h2=0.8, probs=list(PROBS3),
             vars=list(VARS3), stop_criteria_thr=1e-9, seed=5, trace=0)
    d.update(extra)
    return d


@pytest.fixture(scope="module")
def fx():
    return simulate_iid(n=240, m=400, lam=0.1, h2=0.8, seed=42)


@pytest.fixture(scope="module")
def dm(fx):
    return build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def probit_problem():
    fx = simulate_iid(n=200, m=150, lam=0.15, h2=0.9, seed=20)
    return fx, (fx.X @ fx.beta > 0).astype(float)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _run_pair(tmp_path, engine, dm, y, cfg_kw, split, total, **call):
    """(full run dir, its result, resumed run dir, its result): `total`
    iterations straight, and `split` iterations with a checkpoint followed
    by a resume to `total` in another directory."""
    d_full, d_a, d_b = (tmp_path / s for s in ("full", "a", "b"))
    for d in (d_full, d_a, d_b):
        d.mkdir()
    full = engine(dm, y, RunConfig(**{**cfg_kw, "out_dir": str(d_full), "iterations": total}),
                  **call)
    ck = str(tmp_path / "state.npz")
    engine(dm, y, RunConfig(**{**cfg_kw, "out_dir": str(d_a), "iterations": split,
                               "checkpoint_file": ck}), **call)
    assert os.path.exists(ck)
    res = engine(dm, y, RunConfig(**{**cfg_kw, "out_dir": str(d_b), "iterations": total,
                                     "resume_file": ck}), **call)
    return d_full, full, d_b, res


# ---------------------------------------------------------------------------
# the file


def test_checkpoint_round_trip_and_no_tmp_left(tmp_path):
    path = str(tmp_path / "c.npz")
    g = torch.Generator()
    g.manual_seed(3)
    torch.randint(0, 2, (17,), generator=g)
    prior = dict(probs=np.array([0.9, 0.1]), vars=np.array([0.0, 2.0]),
                 active=np.array([True, False]))
    tck.save_checkpoint(path, iteration=4, arrays=dict(x1_hat=np.arange(5.0)),
                        scalars=dict(gam1=0.25), prior=prior, rng_state=g.get_state(),
                        meta=dict(model="linear", n=7))
    assert os.listdir(tmp_path) == ["c.npz"]  # the per-pid tmp file was renamed
    ck = tck.load_checkpoint(path)
    assert ck["version"] == tck.FORMAT_VERSION == 2 and ck["iteration"] == 4
    np.testing.assert_array_equal(ck["arrays"]["x1_hat"], np.arange(5.0))
    assert ck["scalars"] == {"gam1": 0.25}
    for k in ("probs", "vars", "active"):
        np.testing.assert_array_equal(ck["prior"][k], prior[k])
    assert ck["rng_key"] is None
    g2 = torch.Generator()
    g2.set_state(torch.as_tensor(ck["rng_state"]))
    assert torch.equal(torch.rand(8, generator=g), torch.rand(8, generator=g2))
    tck.check_meta(ck, model="linear", n=7, absent_field=1)
    with pytest.raises(ValueError, match="does not match"):
        tck.check_meta(ck, model="bin_class")


def test_checkpoint_other_version_raises(tmp_path):
    path = str(tmp_path / "v.npz")
    np.savez(path, __version__=np.asarray(3), __iteration__=np.asarray(1),
             prior_probs=np.ones(1), prior_vars=np.ones(1), prior_active=np.ones(1, bool))
    with pytest.raises(ValueError, match="format version 3"):
        tck.load_checkpoint(path)


# ---------------------------------------------------------------------------
# resume in the port


@pytest.mark.parametrize("solver", ["cg", "spectral", "eigen"])
def test_linear_resume_is_bitwise(fx, dm, tmp_path, solver):
    """3 iterations + resume to 6 == 6 straight: estimates, the CSV rows
    4-6 and the .bin dumps of iterations 4-6, byte for byte."""
    d_full, full, d_b, res = _run_pair(tmp_path, tlin.infere_linear, dm, fx.y,
                                       kw(tmp_path, lmmse_solver=solver, device="cpu"),
                                       3, 6, true_signal=fx.beta)
    assert res.iterations_run == full.iterations_run == 6
    np.testing.assert_array_equal(res.x1_hat_scaled, full.x1_hat_scaled)
    assert res.gamw == full.gamw
    pf = read_positional_csv(str(d_full / "ck_params.csv"))
    pb = read_positional_csv(str(d_b / "ck_params.csv"))
    assert [r[0] for r in pb] == [4.0, 5.0, 6.0] and pb == pf[3:]
    for it in (4, 5, 6):
        for kind in ("it", "r1_it"):
            assert _bytes(d_b / f"ck_{kind}_{it}.bin") == _bytes(d_full / f"ck_{kind}_{it}.bin")


@pytest.mark.parametrize("solver", ["cg", "eigen"])
def test_probit_resume_is_bitwise(probit_problem, tmp_path, solver):
    fx, ybin = probit_problem
    dmp = build_design(fx.X.T, compute_dtype=torch.float64, device="cpu")
    d_full, full, d_b, res = _run_pair(
        tmp_path, tprob.infere_bin_class, dmp, ybin,
        kw(tmp_path, model="bin_class", gam1=1e-2, rho=0.3, lmmse_solver=solver, device="cpu"),
        2, 4, true_signal=fx.beta)
    np.testing.assert_array_equal(res.x1_hat_scaled, full.x1_hat_scaled)
    assert res.tau1 == full.tau1
    for name in ("ck_params.csv", "ck_metrics.csv", "ck_prior.csv"):
        assert read_positional_csv(str(d_b / name)) == read_positional_csv(str(d_full / name))[2:]


def test_int8_and_bf16_resume_is_bitwise(fx, tmp_path):
    """The f32 work dtype survives the f64 round trip of the state."""
    for dt in (torch.int8, torch.bfloat16):
        dmq = build_design(fx.X.T, compute_dtype=dt, device="cpu")
        sub = tmp_path / str(dt).split(".")[-1]
        sub.mkdir()
        _, full, _, res = _run_pair(sub, tlin.infere_linear, dmq, fx.y,
                                    kw(sub, lmmse_solver="cg", device="cpu"), 2, 4,
                                    true_signal=fx.beta)
        np.testing.assert_array_equal(res.x1_hat_scaled, full.x1_hat_scaled)


def test_resume_appends_to_the_earlier_csv_rows(fx, dm, tmp_path):
    ck = str(tmp_path / "state.npz")
    common = kw(tmp_path, device="cpu", lmmse_solver="eigen")
    tlin.infere_linear(dm, fx.y, RunConfig(**{**common, "iterations": 3, "checkpoint_file": ck}),
                       true_signal=fx.beta)
    before = read_positional_csv(str(tmp_path / "ck_params.csv"))
    assert len(before) == 3
    tlin.infere_linear(dm, fx.y, RunConfig(**{**common, "iterations": 5, "resume_file": ck}),
                       true_signal=fx.beta)
    after = read_positional_csv(str(tmp_path / "ck_params.csv"))
    assert len(after) == 5 and after[:3] == before


def test_resume_rejects_a_mismatched_dataset(fx, dm, tmp_path):
    ck = str(tmp_path / "s.npz")
    cfg = kw(tmp_path, device="cpu", iterations=1, checkpoint_file=ck)
    tlin.infere_linear(dm, fx.y, RunConfig(**cfg), write_outputs=False)
    small = build_design(fx.X.T[:100], compute_dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tlin.infere_linear(small, fx.y, RunConfig(**{**cfg, "checkpoint_file": "",
                                                     "resume_file": ck}), write_outputs=False)
    with pytest.raises(ValueError, match="does not match"):
        tprob.infere_bin_class(dm, (fx.y > 0).astype(float),
                               RunConfig(**{**cfg, "checkpoint_file": "", "resume_file": ck,
                                            "model": "bin_class"}), write_outputs=False)


def test_generator_advances_alike_under_every_solver(fx, dm, tmp_path):
    """One probe an iteration is drawn or skipped whatever the solver, so
    the generator state after k iterations (saved in the checkpoint) is the
    same under cg, spectral and eigen."""
    states = []
    for solver in ("cg", "spectral", "eigen"):
        ck = str(tmp_path / f"{solver}.npz")
        tlin.infere_linear(dm, fx.y, RunConfig(**kw(tmp_path, device="cpu", iterations=3,
                                                    lmmse_solver=solver, checkpoint_file=ck)),
                           write_outputs=False)
        states.append(tck.load_checkpoint(ck)["rng_state"])
    g = torch.Generator()
    g.manual_seed(5)
    for _ in range(3):
        tlin._skip_probe(g, dm)
    for s in states:
        np.testing.assert_array_equal(s, g.get_state().numpy())


@pytest.fixture(scope="module")
def probit_dm(probit_problem):
    return build_design(probit_problem[0].X.T, compute_dtype=torch.float64, device="cpu")


def _fit_model(model, fx, dm, probit_problem, probit_dm, tmp, **extra):
    """(the design, the result) of a `model` fit with kw's seed, no outputs."""
    if model == "linear":
        return dm, tlin.infere_linear(dm, fx.y, RunConfig(**kw(tmp, device="cpu", **extra)),
                                      write_outputs=False)
    cfg = RunConfig(**kw(tmp, device="cpu", model="bin_class", gam1=1e-2, rho=0.3, **extra))
    return probit_dm, tprob.infere_bin_class(probit_dm, probit_problem[1], cfg,
                                             write_outputs=False)


def _replayed(model, dm, skips):
    """A generator seeded as kw seeds a fit, past probit's p1 draw and
    `skips` plain probe skips."""
    g = torch.Generator()
    g.manual_seed(5)
    if model == "bin_class":
        tprob._draw_p1(g, int(dm.n), torch.float64, torch.device("cpu"))
    for _ in range(skips):
        tlin._skip_probe(g, dm)
    return g


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("solver", ["cg", "spectral", "eigen"])
@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_probes_are_drawn_only_where_something_reads_them(
        fx, dm, probit_problem, probit_dm, tmp_path, monkeypatch, model, solver, checkpoint):
    """An exact solver's probes are owed and never drawn (`probe_draws` 0
    an iteration) unless a checkpoint reads the generator's state; CG draws
    its probe every iteration.  Every iteration's saved `rng_state` is that
    of a generator that drew (or skipped) every probe in its iteration."""
    saved = {}
    real_save = tlin.save_checkpoint

    def keep(path, *, iteration, rng_state, **rest):
        saved[iteration] = np.asarray(rng_state, dtype=np.uint8).copy()
        real_save(path, iteration=iteration, rng_state=rng_state, **rest)

    monkeypatch.setattr(tlin, "save_checkpoint", keep)
    extra = dict(checkpoint_file=str(tmp_path / "s.npz")) if checkpoint else {}
    d, res = _fit_model(model, fx, dm, probit_problem, probit_dm, tmp_path, iterations=3,
                        lmmse_solver=solver, **extra)
    assert res.solver == solver and res.iterations_run == 3
    want = 1 if solver == "cg" or checkpoint else 0
    assert [p["probe_draws"] for p in res.iter_phases] == [want] * 3
    assert sorted(saved) == ([1, 2, 3] if checkpoint else [])
    for k, state in saved.items():
        np.testing.assert_array_equal(state, _replayed(model, d, k).get_state().numpy())


@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_cg_resumed_from_an_eigen_checkpoint_draws_the_replayed_probes(
        fx, dm, probit_problem, probit_dm, tmp_path, monkeypatch, model):
    """The eigen run owed its two probes until the checkpoint read the
    state; the CG run resumed from it draws the third and fourth probes of
    the seed's stream."""
    ck = str(tmp_path / "e.npz")
    d, _ = _fit_model(model, fx, dm, probit_problem, probit_dm, tmp_path, iterations=2,
                      lmmse_solver="eigen", checkpoint_file=ck)
    drawn = []
    real_draw = tlin._draw_probe

    def keep(gen, dm_):
        drawn.append(real_draw(gen, dm_))
        return drawn[-1]

    monkeypatch.setattr(tlin if model == "linear" else tprob, "_draw_probe", keep)
    _, res = _fit_model(model, fx, dm, probit_problem, probit_dm, tmp_path, iterations=4,
                        lmmse_solver="cg", resume_file=ck)
    assert res.iterations_run == 4 and [p["probe_draws"] for p in res.iter_phases] == [1, 1]
    g = _replayed(model, d, 2)
    want = [real_draw(g, d) for _ in range(2)]
    assert len(drawn) == 2 and all(torch.equal(a, b) for a, b in zip(drawn, want))


def test_api_passes_the_checkpoint_file_through(fx, tmp_path):
    ck = str(tmp_path / "api.npz")
    fit = api.fit_linear(fx.X, fx.y, device="cpu", iterations=2, h2=0.8, probs=PROBS3,
                         vars=VARS3, lmmse_solver="eigen", checkpoint_file=ck, quiet=True)
    assert tck.load_checkpoint(ck)["iteration"] == fit.iterations_run == 2


# ---------------------------------------------------------------------------
# a JAX-written checkpoint in the port


@pytest.fixture(scope="module")
def jax_linear(fx, tmp_path_factory):
    """JAX's uninterrupted 6-iteration eigen run and its checkpoint after 3."""
    tmp = tmp_path_factory.mktemp("jax_ck")
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    (tmp / "full").mkdir()
    full = jlin.infere_linear(jdm, fx.y, JConfig(**kw(tmp / "full", lmmse_solver="eigen")),
                              true_signal=fx.beta)
    ck = str(tmp / "jax.npz")
    jlin.infere_linear(jdm, fx.y, JConfig(**kw(tmp, iterations=3, lmmse_solver="eigen",
                                               checkpoint_file=ck)),
                       true_signal=fx.beta, write_outputs=False)
    return tmp, full, ck


@pytest.mark.parametrize("solver", ["eigen", "spectral"])
def test_jax_checkpoint_resumes_in_the_port(fx, dm, jax_linear, tmp_path, solver):
    tmp, jfull, ck = jax_linear
    assert tck.load_checkpoint(ck)["version"] == tck.JAX_FORMAT_VERSION
    res = tlin.infere_linear(dm, fx.y, RunConfig(**kw(tmp_path, lmmse_solver=solver,
                                                      device="cpu", resume_file=ck)),
                             true_signal=fx.beta)
    assert res.iterations_run == 6
    np.testing.assert_allclose(res.x1_hat_scaled, jfull.x1_hat_scaled, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(res.gamw, jfull.gamw, rtol=1e-6)
    got = np.asarray(read_positional_csv(str(tmp_path / "ck_params.csv")))
    want = np.asarray(read_positional_csv(str(tmp / "full" / "ck_params.csv")))[3:]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_jax_checkpoint_under_cg_raises(fx, dm, jax_linear, tmp_path):
    _, _, ck = jax_linear
    with pytest.raises(ValueError, match="cannot be replayed"):
        tlin.infere_linear(dm, fx.y, RunConfig(**kw(tmp_path, lmmse_solver="cg", device="cpu",
                                                    resume_file=ck)), write_outputs=False)
    with pytest.raises(ValueError, match="cannot be replayed"):
        convert.checkpoint_from_jax(ck, model="linear", solver="cg")
    assert convert.checkpoint_from_jax(ck, model="linear", solver="eigen")["rng_state"] is None


def test_jax_probit_checkpoint_resumes_under_eigen(probit_problem, tmp_path):
    """The probit checkpoint holds p1, so after it nothing drawn feeds an
    exact solver's result: JAX's 2 + the port's 2 == JAX's 4."""
    fx, ybin = probit_problem
    jdm = jop.build_design(fx.X.T, mesh=None, compute_dtype=jnp.float64)
    common = kw(tmp_path, model="bin_class", gam1=1e-2, rho=0.3, lmmse_solver="eigen")
    jfull = jprob.infere_bin_class(jdm, ybin, JConfig(**{**common, "iterations": 4}),
                                   true_signal=fx.beta, write_outputs=False)
    ck = str(tmp_path / "jp.npz")
    jprob.infere_bin_class(jdm, ybin, JConfig(**{**common, "iterations": 2,
                                                 "checkpoint_file": ck}),
                           true_signal=fx.beta, write_outputs=False)
    res = tprob.infere_bin_class(
        build_design(fx.X.T, compute_dtype=torch.float64, device="cpu"), ybin,
        RunConfig(**{**common, "iterations": 4, "resume_file": ck, "device": "cpu"}),
        true_signal=fx.beta, write_outputs=False)
    np.testing.assert_allclose(res.x1_hat_scaled, jfull.x1_hat_scaled, rtol=1e-6,
                               atol=1e-9 * np.abs(jfull.x1_hat_scaled).max())
