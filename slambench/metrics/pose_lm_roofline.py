"""pose_lm_roofline: the pose-LM kernel's share of its roofline over
the profiled stretch: the least time the chip could take for each launch's
inputs (`roofline.pose_lm_bound_s`, a lower bound of the work; at the
tracker's sizes its bytes bound it) summed, over the summed device time of the
`pose_lm_kernel` launches the profile recorded, in percent."""

import roofline


def read(run):
    p = run.profile
    if p is None:
        return None
    times = p.kernel_times("pose_lm_kernel")
    if not times or len(times) != len(p.pose_lm):
        return None
    least = sum(roofline.pose_lm_bound_s(*launch)[0] for launch in p.pose_lm)
    return 100.0 * least / sum(times)
