"""chip_smoke.py on the CPU: it refuses to run without a card, and the
planted problem its main phases drive is a function of the seed."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vampomi_tpu_torch.ops.operator import design_from_codes
from vampomi_tpu_torch.tools import random_codes

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


def test_chip_smoke_without_a_card_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code == 2
    out = capsys.readouterr()
    assert "is_available" in out.err
    assert not [line for line in out.out.splitlines() if line.startswith("{")]  # no result


def test_planted_problem_is_seeded():
    """The same seed gives the same phenotype, effects and prior; the
    prior is fixed at the truth (`causal` markers)."""
    dm = design_from_codes(random_codes(2048, 256, torch.int8, 3, "cpu"))
    a = chip_smoke.planted_problem(dm, 2)
    b = chip_smoke.planted_problem(dm, 2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert np.count_nonzero(a[1]) == 2 and a[2]["probs"][1] == 2 / 2048
    assert a[2]["vars"] == [0.0, 0.8 / 2] and a[2]["h2"] == 0.8
    assert a[0].shape == (256,) and abs(np.var(a[0], ddof=1) - 1.0) < 1e-9


@pytest.mark.parametrize("model,c", [("bin_class", 0), ("bin_class", 2), ("linear", 2)])
def test_parity_problem_is_seeded(model, c):
    """The parity phase's fixture: 0/1 labels for probit, the read_phen
    scaling for linear, c covariates; the same seed gives the same data."""
    fx, y, Z = chip_smoke.parity_problem(300, 128, model, c)
    fx2, y2, Z2 = chip_smoke.parity_problem(300, 128, model, c)
    np.testing.assert_array_equal(y, y2)
    if model == "bin_class":
        assert set(np.unique(y)) == {0.0, 1.0}
    else:
        assert abs(np.sum((y - y.mean()) ** 2) - 127.0) < 1e-9
    assert (Z is None) == (c == 0) and (Z is None or Z.shape == (128, c))


def test_probit_cli_phase_runs_on_the_cpu(tmp_path):
    """The probit CLI phase at a toy size with --device cpu: every file it
    checks is written and finite (the card runs it at N = 2,000)."""
    chip_smoke.phase_cli_probit("cpu", str(tmp_path), n=120, m=300, iters=3)
    assert (tmp_path / "cli_bin_int8_cg.log").exists()


def test_resume_phase_runs_on_the_cpu(tmp_path, capsys):
    """The CLI resume phase at a toy size with --device cpu: every
    configuration byte-identical (the card runs it at N = 2,000)."""
    chip_smoke.phase_resume("cpu", str(tmp_path), n=120, m=300, iters=4, split=2)
    out = capsys.readouterr().out
    assert out.count("byte-identical") == len(chip_smoke.RESUME_RUNS)
    assert "NOT byte-identical" not in out


@pytest.mark.parametrize("solver", ["eigen", "spectral", "cg"])
def test_exact_launches_count_the_engines_passes(tmp_path, monkeypatch, solver):
    """The launch counts chip_smoke.py holds the bf16 main path to are the
    calls the linear engine makes to the three bf16 wrappers (counted here
    on the CPU, where the wrappers run their plain versions), and the Gram
    kernel's two launches a block of each Gram it builds (on the CPU the
    Gram takes gram_blocks, counted as the kernel would launch)."""
    from vampomi_tpu_torch.config import RunConfig
    from vampomi_tpu_torch.engine.linear import infere_linear
    from vampomi_tpu_torch.ops import operator as top
    from vampomi_tpu_torch.ops import spectral
    from vampomi_tpu_torch.sim.data_sim import simulate_iid

    calls = {}
    for name in ("atx_bf16", "atx_batch_bf16", "ax_batch_bf16"):
        orig = getattr(top, name)

        def counted(*a, _name=name, _orig=orig):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a)

        monkeypatch.setattr(top, name, counted)
    gram_blocks = spectral.gram_blocks

    def gram_counted(X, w2, u, n, block):
        calls["gram_tc"] = calls.get("gram_tc", 0) + 2 * -(-X.shape[0] // block)
        return gram_blocks(X, w2, u, n, block)

    monkeypatch.setattr(spectral, "gram_blocks", gram_counted)
    fx = simulate_iid(n=200, m=800, lam=0.05, h2=0.8, seed=1)
    dm = top.build_design(fx.X.T, compute_dtype=torch.bfloat16, device="cpu")
    k = 3
    res = infere_linear(dm, fx.y, RunConfig(out_dir=str(tmp_path), out_name="x", iterations=k,
                                            lmmse_solver=solver, stop_criteria_thr=0.0,
                                            device="cpu", probs=[0.95, 0.05],
                                            vars=[0.0, 1e-2]))
    steps = chip_smoke._trace_steps(str(tmp_path / "x_trace.jsonl")) if solver == "cg" else []
    assert res.solver == solver and (solver != "cg" or sum(steps) > 0)
    assert calls == chip_smoke.exact_launches("bf16", solver, k, steps, dm.m_pad)
