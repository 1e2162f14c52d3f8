"""tracking.kernels_per_frame: device kernels launched inside the tracker's
call (`Tracker.track_*`) but outside the mapping step it runs on keyframe
frames and outside relocalization, per frame of the profiled stretch."""


def read(run):
    p = run.profile
    if p is None or not p.ops or not p.calls("tracking.track"):
        return None
    tracking = p.kernels_in("tracking.track", outside=("mapping.step", "reloc.relocalize"))
    return tracking / p.calls("tracking.track")
