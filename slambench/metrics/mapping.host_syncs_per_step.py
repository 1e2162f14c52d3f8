"""mapping.host_syncs_per_step: host syncs the program made inside the
local-mapping step (span `mapping.step`, `LocalMapper._map_step`, and the
spans under it), per mapping step of the measured window."""

import programtrace


def read(run):
    win = programtrace.window(run)
    if win is None:
        return None
    steps = win.named("mapping.step")
    if not steps:
        return None
    return win.syncs("mapping.step") / len(steps)
