"""tracking.build_ms: mean host milliseconds of one frame build
(`FrameBuilder.build`: ORB and the RGB-D pseudo-stereo), the synced span
`tracking.build`, over the traced window."""


def read(run):
    return run.spans.mean("tracking.build")
