"""orb.idle_ms_per_frame: milliseconds of the profiled stretch in which
the device was idle while an ORB stage (a program span `orb.*`: the
pyramid, FAST score and NMS, top-k selection, patches, angles and BRIEF)
was the innermost span open, per frame of the stretch: the card waiting
on the host's ORB launches and reads."""

import programtrace


def read(run):
    idle = programtrace.idle(run)
    if idle is None or not idle.frames:
        return None
    ns = [v for name, v in idle.by_span.items() if name.startswith("orb.")]
    if not ns:
        return None
    return sum(ns) / 1e6 / idle.frames
