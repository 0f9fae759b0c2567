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
