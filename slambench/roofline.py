"""Peaks of the chip and the frozen operation and byte count of the
pose-LM kernel (`csrc/pose_lm.cu`), for `pose_lm_roofline`.

The count is a copy of the one a smoke test kept beside the kernel,
counted from the kernel's source: FLOPs per edge without the products of
the Jacobians' zero entries; a division or square root counts one. A
launch runs `n_rounds` rounds; each opens with a pass that reads the
residual of every valid edge, and one more pass after the last round
classifies the output. Those passes are what the launch's inputs alone
fix, so the count takes them and leaves out the rounds' iterations, whose
edges are the inliers of each round: the count is a lower bound of the
work, and the share it gives is a lower bound of the kernel's share.
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet): f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# FLOP of one residual pass over an edge: (mono, stereo)
FLOP_RESIDUAL = (31, 36)
BYTES_PER_EDGE = 12 + 8 + 4 + 4 + 1 + 1  # pt_w uv ur inv_sigma2 valid in, inlier out
BYTES_PER_PROBLEM = 64 + 64 + 4  # pose in, pose and inlier count out
N_ROUNDS = 4  # the tracker's and the relocalizer's calls: 4 rounds of 10 iterations


def pose_lm_bound_s(problems: int, edges: int, mono: int, stereo: int) -> tuple[float, str]:
    """(least seconds the chip could take, what bounds it) for one launch
    of `problems` problems of `edges` edge slots, `mono` and `stereo` of
    them valid over all problems."""
    flops = (1 + N_ROUNDS) * (FLOP_RESIDUAL[0] * mono + FLOP_RESIDUAL[1] * stereo)
    nbytes = problems * edges * BYTES_PER_EDGE + problems * BYTES_PER_PROBLEM
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
