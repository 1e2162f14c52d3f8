"""tracking.host_syncs_per_frame: host syncs the program made per tracked
frame of the measured window: those charged to its spans under
`system.frame` (`SLAMSystem.track_*`) but outside the mapping step and
relocalization (`mapping.*`, `reloc.*`), over the window's frames. Each
is a point where the host waits for the card, and one that a CUDA graph
capture cannot cross."""

import programtrace


def read(run):
    win = programtrace.window(run)
    if win is None or not win.frames:
        return None
    return win.syncs("system.frame", outside=("mapping.", "reloc.")) / win.frames
