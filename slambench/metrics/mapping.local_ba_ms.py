"""mapping.local_ba_ms: host milliseconds of the local BA (program span
`mapping.local_ba`: window, problem, LM and write-back) per mapping step
of the measured window."""

import programtrace


def read(run):
    win = programtrace.window(run)
    if win is None:
        return None
    ba, steps = win.named("mapping.local_ba"), win.named("mapping.step")
    if not ba or not steps:
        return None
    return sum(r[5] - r[4] for r in ba) / 1e6 / len(steps)
