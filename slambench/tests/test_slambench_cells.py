"""Every cell of BENCHMARK.json resolves its configuration, traffic,
limits and per-layer readers by name, and the file keeps to the shapes
the benchmark's contract sets."""

import json
import re
from pathlib import Path

import pytest

import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.load_cell(BENCH, cell, harness.HERE)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["splice"] and c["limits"] and c["run"]["warmup_frames"] >= 0
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s", "frames_per_s"}
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_benchmark_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith("slambench/")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    assert layers
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert 1 <= BENCH["run_seconds"] <= 51
