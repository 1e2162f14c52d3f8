"""Whole runs of the harness on the CPU at a test size: the result line,
the blocked modules, the faults that `correct` must catch, and a run
without a card or without the program."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = BENCH / "tests" / "data"

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu"):
    sys.modules[name] = None
sys.path[:0] = [{bench!r}, {root!r}]
from pathlib import Path
import torch
torch.set_num_threads(2)
import harness
{fault}
sys.exit(harness.main(["--workload", "tiny-rgbd-room", "--seed", "{seed}", "--seconds", "2",
                       "--trace", "{trace}"], base=Path({data!r}),
                      bench_file=Path({data!r}) / "BENCHMARK.json", device="cpu", fault=fault))
"""

FAULTS = {"none": "fault = None"} | {
    name: f"import control\nfault = control.CONTROLS[{name!r}]"
    for name in ("state_unchanged", "answer_altered")}


def run_tiny(fault: str = "none", trace: int = 0, seed: int = 2**31 + 7) -> tuple[int, dict, str]:
    code = SCRIPT.format(bench=str(BENCH), root=str(ROOT), data=str(DATA), seed=seed,
                         trace=trace, fault=FAULTS[fault])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    lines = res.stdout.strip().splitlines()
    return res.returncode, (json.loads(lines[-1]) if lines else {}), res.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_result_line(trace):
    rc, out, err = run_tiny(trace=trace)
    assert rc == 0, err
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] or \
        set(keys[:6]) == {"correct", "attempted", "failed", "metrics", "device", "breakdown"}
    assert keys[-1] == "checks"  # the numbers compared, each beside its limit, last
    assert out["correct"] is True, err
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        assert "tracking.build_ms" in out["metrics"]
    else:
        assert set(out["metrics"]) >= {"frames_per_s", "frame_ms_p50", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_fault_makes_correct_false(fault):
    rc, out, err = run_tiny(fault)
    assert rc == 0, err
    assert out["correct"] is False, err


def test_blocked_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["jaxfake_pkg"] = sys
        sys.modules["orbslam_mapsave_tpu_torchlike"] = sys
        assert harness.loaded_blocked() == []
        sys.modules["jax"] = None  # a blocked placeholder is no module
        assert harness.loaded_blocked() == []
        sys.modules["orbslam_mapsave_tpu.pipeline"] = sys
        assert harness.loaded_blocked() == ["orbslam_mapsave_tpu.pipeline"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_no_source_imports_jax():
    for path in BENCH.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in harness.BLOCKED, f"{path}: {line}"


def test_reference_imports_nothing_of_the_program():
    text = (BENCH / "reference.py").read_text()
    assert "import numpy as np" in text
    imports = [l.split()[1] for l in text.splitlines() if l.startswith(("import ", "from "))]
    assert set(imports) <= {"__future__", "numpy"}


def test_run_without_card_or_program_prints_no_result(tmp_path):
    """run.py needs the card: here it exits non-zero and prints nothing on
    stdout; so does a directory that holds only BENCHMARK.json and the
    benchmark's folder (no program)."""
    res = subprocess.run([sys.executable, "slambench/run.py", "--workload", "rgbd-room-loop",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
    shutil.copytree(BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "slambench/run.py", "--workload", "rgbd-room-loop",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
