"""A configuration's `model` names its module, benchmark/models/<model>.py,
and the harness takes from it all that depends on the model: every
configuration names a module that holds the four parts; a second model,
given as a file of its own in another directory, runs through the harness
with no other file changed; and the linear module gives the readings that
the harness gave before the model had a module of its own."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import cell, spec

PARTS = ("phenotype", "inputs", "fit", "answer_of", "finite_and_whole", "Reference",
         "readings")


def _bench() -> dict:
    with open(spec.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _model_of(config: dict) -> str:
    with open(spec.ROOT / config["file"]) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("config", [c["name"] for c in _bench()["configs"]])
def test_every_configuration_names_a_model_with_its_four_parts(config):
    name = _model_of(next(c for c in _bench()["configs"] if c["name"] == config))
    assert (spec.MODELS / f"{name}.py").is_file(), name
    mod = spec.model(name)
    for part in PARTS:
        assert callable(getattr(mod, part, None)), (name, part)
    assert callable(mod.Reference.fits) and callable(mod.Reference.tail)


STUB = '''
"""A second model: the linear engine under another name, with a phenotype
recipe of its own (a fixed number of causal markers, effects of one size
and random signs)."""

import math

import numpy as np
import torch

from benchmark.design import subseed
from benchmark.models.linear import (Inputs, Phenotype, Reference, answer_of,
                                     finite_and_whole, fit, inputs, readings)
from benchmark.reference.gvamp import unpack_codes

CALLS = []


def phenotype(codes, packed, n, seed, index, config, traffic):
    m, h2, causal = codes.shape[0], float(config["run_config"]["h2"]), int(traffic["causal"])
    rng = np.random.default_rng(subseed(seed, 9, index))
    idx = np.sort(rng.choice(m, causal, replace=False))
    effects = rng.choice([-1.0, 1.0], causal) * math.sqrt(h2 / causal)
    rows = codes[torch.as_tensor(idx)]
    c = unpack_codes(rows, torch.float64) if packed else rows.double()
    c = (c - c.mean(dim=1, keepdim=True)) / c.std(dim=1, keepdim=True)
    y = (c * torch.as_tensor(effects)[:, None]).sum(dim=0).numpy()
    y = y + rng.normal(0.0, math.sqrt(1.0 - h2), n)
    y = y * math.sqrt((n - 1.0) / np.sum((y - y.mean()) ** 2))
    beta = np.zeros(m)
    beta[idx] = effects
    CALLS.append(index)
    return Phenotype(y=y, beta=beta, probs=[1.0 - causal / m, causal / m],
                     vars=[0.0, h2 / causal])
'''


def test_a_second_model_comes_as_new_files_only(tmp_path, monkeypatch):
    (tmp_path / "stub.py").write_text(textwrap.dedent(STUB))
    monkeypatch.setattr(spec, "MODELS", tmp_path)
    torch.set_num_threads(4)
    c = spec.cell("ns_int8.eigen_fits")
    stub = c._replace(config=dict(c.config, model="stub", markers=26_112, samples=256,
                                  iterations=4),
                      traffic=dict(c.traffic, phenotypes=2, causal=40))
    setup = cell.prepare(stub, 2**33 + 7, torch.device("cpu"))
    assert setup.model.__file__ == str(tmp_path / "stub.py")
    assert sorted(setup.model.CALLS) == [0, 1, 2]  # the pool and the set-up fit's phenotype
    assert int((setup.pool[0].beta != 0).sum()) == 40
    line = cell.run_cell(stub, 2**33 + 7, 0.0, False, torch.device("cpu"), 0.0)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["checks"]) == {"head_gap", "failed_fits"}


# The readings of a small seeded run of each cell, taken with the harness
# as it stood before each model had a module of its own.  One thread, and
# the CPU kernels that MKL and ATen choose alike on every x86 CPU, so that
# the run's bits do not depend on the machine.
PINNED_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from benchmark import cell, spec
torch.set_num_threads(1)
name, seed = sys.argv[2], int(sys.argv[3])
c = spec.cell(name)
c = c._replace(config=dict(c.config, markers=26_112, samples=256, iterations=4),
               traffic=dict(c.traffic, phenotypes=2))
line = cell.run_cell(c, seed, 0.0, False, torch.device("cpu"), 0.0)
print(json.dumps({"correct": line["correct"], "attempted": line["attempted"],
                  "failed": line["failed"],
                  "checks": {k: v["value"] for k, v in line["checks"].items()}}))
"""
PINNED_ENV = {"MKL_CBWR": "COMPATIBLE", "ATEN_CPU_CAPABILITY": "default",
              "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
PINNED = {
    "ns_int8.eigen_fits": {"correct": True, "attempted": 1, "failed": 0,
                           "checks": {"head_gap": 2.3392932416863516e-05, "failed_fits": 0}},
    "ns_int4.eigen_fits": {"correct": True, "attempted": 1, "failed": 0,
                           "checks": {"head_gap": 3.3339515489559005e-05,
                                      "tail_gap": 3.7425078913688736e-07, "failed_fits": 0}},
}


@pytest.mark.parametrize("name", list(PINNED))
def test_the_linear_module_reads_what_the_harness_read_before(name):
    out = subprocess.run([sys.executable, "-c", PINNED_RUN, str(spec.ROOT), name, str(2**33 + 5)],
                         capture_output=True, text=True, timeout=300, check=True,
                         env={**os.environ, **PINNED_ENV})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == PINNED[name]
