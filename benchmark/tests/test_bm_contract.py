"""BENCHMARK.json keeps the form the benchmark's runs rely on: names and
units of the allowed characters, the keys of each entry, files under
`paths`, every configuration used, and every per-layer metric moving an
end-to-end metric that each of its cells reports."""

import json
import re

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(spec.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith(b["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [x["name"] for x in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_its_metrics_move():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    assert e2e["setup_s"] == cells
    for cell in cells:
        assert sum(cell in ws for n, ws in e2e.items() if n != "setup_s") >= 1
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
    for m in b["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]]


def test_paths_hold_the_benchmark_and_the_command_stays_inside():
    b = _bench()
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    for c in b["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
