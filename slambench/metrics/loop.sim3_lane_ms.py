"""loop.sim3_lane_ms: mean host milliseconds of one Sim3 chain lane
(program span `loop.sim3_lane`: the matches, RANSAC Sim3, the guided
search, OptimizeSim3 and the projection search for one candidate) over
the measured window."""

import programtrace


def read(run):
    win = programtrace.window(run)
    lanes = win.named("loop.sim3_lane") if win is not None else []
    if not lanes:
        return None
    return sum(r[5] - r[4] for r in lanes) / 1e6 / len(lanes)
