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
