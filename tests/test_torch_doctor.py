"""The port's doctor (vampomi_tpu_torch/doctor.py) on a machine without a
card: the host check PASSes, every CUDA check FAILs, exit 1; and a probe
that hangs becomes a FAIL line within its deadline.  On the card the doctor
runs from chip_smoke.py."""

import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from vampomi_tpu_torch import doctor

ROOT = Path(__file__).resolve().parent.parent


def test_without_a_card_host_checks_pass_and_cuda_checks_fail(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA checks would pass")
    assert doctor.main([]) == 1
    lines = {ln[7:30].strip(): ln[:6] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[")}
    assert lines["python deps"] == "[PASS]"
    for name in ("cuda device", "nvcc", "kernel builds", "kernel launches"):
        assert lines[name] == "[FAIL]", name
    assert lines["power limit"] in ("[WARN]", "[FAIL]")


def test_doctor_module_exits_1_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "vampomi_tpu_torch.doctor"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert out.stdout.strip().splitlines()[-1] == "doctor: PROBLEMS FOUND"
    assert "jax" not in out.stdout


def test_a_hanging_probe_is_a_fail_line(capsys):
    t0 = time.time()
    assert doctor._probe_line("slow probe", "import time; time.sleep(30)", 1.0) is False
    assert time.time() - t0 < 20
    assert "hang" in capsys.readouterr().out


def test_probe_reports_its_ok_line_and_errors(capsys):
    assert doctor._probe_line("ok probe", "print('OK all good')", 60.0)
    assert not doctor._probe_line("bad probe", "raise SystemExit('broken thing')", 60.0)
    out = capsys.readouterr().out
    assert "[PASS] ok probe" in out and "all good" in out and "broken thing" in out


def test_every_kernel_source_is_checked():
    names = doctor.kernel_names()
    assert {"atx_int8", "gibbs_block", "atx_bf16", "atx_batch_bf16", "ax_batch_bf16"} <= set(names)
    assert len(names) == len(list((ROOT / "vampomi_tpu_torch" / "csrc").glob("*.cu")))
