"""Each cell's control and the faults it can have, run on the card at the
cell's own size with a short window, come out not correct (its readings, and the limits set
between them, are in PERF.md). Card only: `python -m pytest
slambench/tests -m cuda -q` from the root of the repository."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
# cell -> the controls whose readings set an upper end of one of its limits
CONTROLS = {
    "rgbd-room-loop": ["no_loop", "state_unchanged", "answer_altered"],
}
SEED = 2**31 + 977  # a seed no limit was set from
SECONDS = 5


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run the cells at their own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", [(c, k) for c, ks in CONTROLS.items() for k in ks])
def test_control_is_not_correct(card, cell, control):
    res = subprocess.run([sys.executable, "slambench/control.py", "--control", control,
                          "--workload", cell, "--seed", str(SEED), "--seconds", str(SECONDS)],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is False, res.stderr[-2000:]
