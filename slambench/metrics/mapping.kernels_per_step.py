"""mapping.kernels_per_step: device kernels launched inside the span
`mapping.step`, per mapping step of the profiled stretch."""


def read(run):
    p = run.profile
    if p is None or not p.ops or not p.calls("mapping.step"):
        return None
    return p.kernels_in("mapping.step") / p.calls("mapping.step")
