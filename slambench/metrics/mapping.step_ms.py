"""mapping.step_ms: mean host milliseconds of one local-mapping step
(`LocalMapper._map_step`: culling, triangulation, fuse, local BA, keyframe
culling), the synced span `mapping.step`, over the traced window."""


def read(run):
    return run.spans.mean("mapping.step")
