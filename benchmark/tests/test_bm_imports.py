"""What a run loads: nothing of JAX or of the JAX package `vampomi_tpu`,
compared by whole top-level names (the port, `vampomi_tpu_torch`, begins
with the JAX package's name); and the reference nothing of the port."""

import ast
import json
import shutil
import subprocess
import sys

from benchmark import cell, spec

BANNED = {"jax", "jaxlib", "flax", "vampomi_tpu"}

_RUN_IMPORTS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch.profiler
from benchmark import calibrate, cell, check, design, roofline, spec, trace
from vampomi_tpu_torch.config import RunConfig, resolve_device
from vampomi_tpu_torch.engine.linear import infere_linear
from vampomi_tpu_torch.ops.operator import design_from_codes, design_from_packed
with open(spec.ROOT / "BENCHMARK.json") as f:
    bench = json.load(f)
for m in bench["per_layer"]:
    spec.reader(m["name"])
for c in bench["configs"]:
    with open(spec.ROOT / c["file"]) as f:
        spec.model(json.load(f)["model"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE_IMPORTS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import benchmark.reference.gvamp
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _top_level_names(_RUN_IMPORTS)
    assert "vampomi_tpu_torch" in names and "torch" in names
    assert not names & BANNED, names & BANNED


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names(_REFERENCE_IMPORTS)
    assert "torch" in names
    assert not names & (BANNED | {"vampomi_tpu_torch"})


def test_the_references_sources_import_only_torch_and_the_standard_library():
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= {"__future__", "math", "typing", "torch"}, (path.name, tops)


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vampomi_tpu_torch_extra", sys)
    assert cell.loaded_banned() == []
    monkeypatch.setitem(sys.modules, "vampomi_tpu.ops", sys)
    assert cell.loaded_banned() == ["vampomi_tpu"]


def _run(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ns_int8.eigen_fits", "--seed",
         "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_a_run_without_enough_cards_prints_no_result(tmp_path):
    if cell.torch.cuda.is_available():
        return  # the card's machine: the cell runs (chip tests)
    out = _run(spec.ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
