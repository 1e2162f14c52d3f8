"""Seeded synthetic pose-optimization problems for kernel checks.

The same problem shape as the JAX package's Pallas-kernel parity test
(`tests/test_pose_opt_pallas.py`): M world points in front of a 520 px
camera, a small true motion, 0.5 px pixel noise, 10% gross outliers, 30%
stereo edges (none for a monocular frame's problem) and 5% invalid edges. Built in numpy from a seed, so the JAX
reference, the plain PyTorch version and the CUDA kernel all see the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import projection, se3

CAM = projection.Camera.create(520.0, 520.0, 320.0, 240.0, bf=41.6,
                               width=640, height=480)


def make_problem(M: int, seed: int = 7, stereo: float = 0.3) -> dict:
    """Returns numpy arrays pt_w (M,3), uv (M,2), ur (M,), inv_sigma2 (M,),
    valid (M,) bool, and the true pose T_true (4,4) f32. `stereo` is the
    share of stereo edges (0: every edge mono, ur = -1)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 1.5], [2, 2, 6], (M, 3)).astype(np.float32)
    xi = np.array([0.04, -0.02, 0.03, 0.012, -0.018, 0.01], np.float32)
    T_true = se3.se3_exp(torch.from_numpy(xi)).numpy()
    p_cam = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([520 * p_cam[:, 0] / p_cam[:, 2] + 320,
                   520 * p_cam[:, 1] / p_cam[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    out = rng.random(M) < 0.1
    uv[out] += rng.uniform(20, 60, (out.sum(), 2)).astype(np.float32)
    ur = np.full(M, -1.0, np.float32)
    st = rng.random(M) < stereo
    ur[st] = (uv[st, 0] - 41.6 / p_cam[st, 2]).astype(np.float32)
    valid = rng.random(M) > 0.05
    return dict(pt_w=pts, uv=uv, ur=ur, inv_sigma2=np.ones(M, np.float32),
                valid=valid, T_true=T_true.astype(np.float32))


def batch_obs(problems: list[dict], device) -> "PoseObs":
    """Stack problems into a PoseObs with a leading batch dim on `device`."""
    from .pose_opt import PoseObs

    return PoseObs(*[
        torch.from_numpy(np.stack([p[k] for p in problems])).to(device)
        for k in ("pt_w", "uv", "ur", "inv_sigma2", "valid")
    ])
