"""The readers of the program's own spans (`programtrace.py` and the six
`metrics/` files that use it): the window's records, the idle time of a
hand-made stretch put down to the innermost span, and a traced run of the
tiny cell on the CPU in which each reader returns a number exactly where
its span ran."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import harness
import layertrace
import programtrace
from orbslam_mapsave_tpu_torch.utils import metrics

# importing programtrace turned the program's tracer on in this process; the
# tests here read hand-made records, and the traced run has its own process
metrics.disable()

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = BENCH / "tests" / "data"
READERS = ["tracking.host_syncs_per_frame", "orb.idle_ms_per_frame",
           "mapping.host_syncs_per_step", "mapping.local_ba_ms", "loop.sim3_lane_ms",
           "loop.gba_iter_ms"]
US = 1_000_000.0  # the hand-made clock's origin, in microseconds


class FakeTracer:
    """The tracer's read side over hand-made records (number, name, parent,
    frame, start ns, end ns, syncs)."""

    def __init__(self, records):
        self._records = records

    def records(self):
        return list(self._records)

    def summary(self):
        return dict(frames=1, records=len(self._records), dropped=0, counters={},
                    host_syncs=dict(total=0, by_site={}, by_span={}))


def _ns(us):
    return int((US + us) * 1e3)


def _rec(no, name, parent, a_us, b_us, syncs=0, frame=0):
    return (no, name, parent, frame, _ns(a_us), _ns(b_us), syncs)


def _cpu(name, start, end, corr=0):
    return dict(name=name, device="cpu", kind="", start=US + start, end=US + end, corr=corr)


def _dev(name, start, end, corr):
    return dict(name=name, device="cuda", kind="kernel", start=US + start, end=US + end,
                corr=corr)


def _run(events, track_calls):
    spans = layertrace.Spans()
    spans.ms["tracking.track"] = [1.0] * track_calls
    run = harness.Run(spans, layertrace.reduce(events))
    return run


@pytest.fixture()
def fake(monkeypatch):
    def use(records):
        monkeypatch.setattr(programtrace, "TRACER", FakeTracer(records))
    return use


def _reader(name):
    return harness.load_reader(name)


def test_idle_goes_to_the_innermost_span(fake):
    fake([
        _rec(0, "system.reset", -1, -50, -40),
        _rec(2, "orb.pyramid", 1, 20, 90),
        _rec(3, "orb.fast_nms", 1, 210, 400),
        _rec(5, "mapping.local_ba", 4, 520, 580),
        _rec(4, "mapping.step", 1, 500, 700, syncs=2),
        _rec(1, "system.frame", -1, 5, 950, syncs=3),
    ])
    run = _run([
        _cpu(layertrace.STRETCH, 0.0, 1000.0),
        _cpu("tracking.track", 10.0, 900.0),
        _cpu("cudaLaunchKernel", 50.0, 51.0, corr=1),
        _cpu("cudaLaunchKernel", 550.0, 551.0, corr=2),
        _dev("k1", 100.0, 200.0, 1),
        _dev("k2", 600.0, 650.0, 2),
    ], track_calls=1)
    idle = programtrace.idle(run)
    # the stretch [5, 1005) us from the first frame's span: busy 100-200 and
    # 600-650, idle 850 us
    assert idle.total_ns == 850_000 and idle.frames == 1
    assert idle.by_span == {"system.frame": 385_000, "orb.pyramid": 70_000,
                            "orb.fast_nms": 190_000, "mapping.step": 90_000,
                            "mapping.local_ba": 60_000, programtrace.OUTSIDE: 55_000}
    assert idle.gaps[0][0] == 400_000  # [200, 600): mostly in orb.fast_nms
    assert idle.gaps[0][1][0] == ("orb.fast_nms", 190_000)
    assert _reader("orb.idle_ms_per_frame")(run) == pytest.approx(0.26)
    win = programtrace.window(run)
    assert win.frames == 1 and len(win.records) == 6  # from the reset on
    assert _reader("tracking.host_syncs_per_frame")(run) == 3  # not the mapping step's
    assert _reader("mapping.host_syncs_per_step")(run) == 2
    assert _reader("mapping.local_ba_ms")(run) == pytest.approx(0.06)
    assert _reader("loop.sim3_lane_ms")(run) is None  # the span never ran
    assert _reader("loop.gba_iter_ms")(run) is None


def test_window_starts_at_its_episodes_reset_and_counts_its_frames(fake):
    fake([
        _rec(0, "system.reset", -1, -900, -890),  # the warm-up's episode
        _rec(1, "system.frame", -1, -880, -800, syncs=7),
        _rec(2, "system.reset", -1, -500, -490),  # the window's first episode
        _rec(3, "system.frame", -1, -480, -400, syncs=1),
        _rec(4, "system.frame", -1, 5, 100, syncs=2),
        _rec(6, "gba.iterate", 5, 300, 340),
        _rec(5, "system.frame", -1, 200, 400, syncs=4),  # after the window's frames
    ])
    run = _run([_cpu(layertrace.STRETCH, 0.0, 1000.0),
               _cpu("tracking.track", 10.0, 90.0)], track_calls=2)
    win = programtrace.window(run)
    assert [r[0] for r in win.records] == [2, 3, 4]
    assert _reader("tracking.host_syncs_per_frame")(run) == 1.5
    assert _reader("loop.gba_iter_ms")(run) is None  # outside the window
    assert _reader("orb.idle_ms_per_frame")(run) is None  # no device operation


def test_no_profile_or_no_tracer_reads_nothing(fake, monkeypatch):
    fake([_rec(0, "system.reset", -1, 0, 1)])
    run = harness.Run(layertrace.Spans(), None)
    assert all(_reader(n)(run) is None for n in READERS)
    monkeypatch.setattr(programtrace, "TRACER", None)  # a program without spans
    run = _run([_cpu(layertrace.STRETCH, 0.0, 10.0),
               _cpu("tracking.track", 1.0, 9.0)], track_calls=1)
    assert all(_reader(n)(run) is None for n in READERS)


SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu"):
    sys.modules[name] = None
sys.path[:0] = [{bench!r}, {root!r}]
import json
from pathlib import Path
import torch
torch.set_num_threads(2)
import harness
runs = []
class KeptRun(harness.Run):
    def __init__(self, *a):
        super().__init__(*a)
        runs.append(self)
harness.Run = KeptRun
rc = harness.main(["--workload", "tiny-rgbd-room", "--seed", "{seed}", "--seconds", "3",
                   "--trace", "1"], base=Path({data!r}), bench_file=Path({bench_file!r}),
                  device="cpu")
import programtrace
win = programtrace.window(runs[0])
print("WINDOW " + json.dumps(sorted({{r[1] for r in win.records}}) if win else None),
      file=sys.stderr)
sys.exit(rc)
"""


def test_tiny_traced_run_reads_each_span_that_ran(tmp_path):
    """The tiny cell with its profiled frames moved to the first two of the
    window's first episode, so that the window holds the stretch's start
    however slow the CPU (a stretch profiled after the window has no
    benchmark spans to anchor the window on)."""
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    cell_file = data / "cells" / f"{cell}.json"
    cell_file.write_text(json.dumps(dict(json.loads(cell_file.read_text()),
                                         profile_frames=[0, 2])))
    for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]:
        if m["name"] in READERS:
            bench["per_layer"].append(dict(m, workloads=[cell]))
    (data / "BENCHMARK.json").write_text(json.dumps(bench))
    code = SCRIPT.format(bench=str(BENCH), root=str(ROOT), data=str(data), seed=2**31 + 11,
                         bench_file=str(data / "BENCHMARK.json"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    (line,) = [l for l in res.stderr.splitlines() if l.startswith("WINDOW ")]
    ran = json.loads(line.split(" ", 1)[1])
    assert ran is not None, res.stderr
    ran = set(ran)
    assert {"system.reset", "system.frame", "build.frame", "orb.pyramid"} <= ran
    got = {n: out["metrics"].get(n, {}).get("value") for n in READERS}
    spans = {"tracking.host_syncs_per_frame": "system.frame",
             "mapping.host_syncs_per_step": "mapping.step",
             "mapping.local_ba_ms": "mapping.local_ba", "loop.sim3_lane_ms": "loop.sim3_lane",
             "loop.gba_iter_ms": "gba.iterate"}
    for name, span in spans.items():
        assert (got[name] is not None) == (span in ran), (name, got, ran)
    assert got["tracking.host_syncs_per_frame"] == 0.0  # the CPU makes no host sync
    assert got["loop.sim3_lane_ms"] is None  # the tiny deployment closes no loops
    assert got["orb.idle_ms_per_frame"] is None  # no device timeline on the CPU
    assert out["correct"] is True
    # the program's spans never reach the profile: no name of theirs is an operation
    assert not any(op[0].split(".")[0] in ("orb", "build", "system", "track", "mapping")
                   for op in out["breakdown"]["device_ops"])
