"""device.idle_pct: the share of the profiled stretch (host clock of the
range around it) in which no operation ran on the device, in percent."""


def read(run):
    p = run.profile
    if p is None or not p.ops or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
