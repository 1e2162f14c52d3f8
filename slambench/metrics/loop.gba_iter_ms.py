"""loop.gba_iter_ms: mean host milliseconds of one LM iteration of the
loop's global BA (program span `gba.iterate`, `global_ba.gba_iterate`)
over the measured window."""

import programtrace


def read(run):
    win = programtrace.window(run)
    iters = win.named("gba.iterate") if win is not None else []
    if not iters:
        return None
    return sum(r[5] - r[4] for r in iters) / 1e6 / len(iters)
