"""Parity: the port's plain pose optimization against the JAX package's XLA
schedule and its Pallas kernel (interpret mode on the CPU).

The problem is the one of `test_pose_opt_pallas.py` (10% outliers, 30%
stereo, 5% invalid), built in numpy from a seed, at M = 900, 1024, 2048.
Pose tolerance 1e-5; inlier sets and counts identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.optim import pose_opt as jpo
from orbslam_mapsave_tpu.optim import pose_opt_pallas
from orbslam_mapsave_tpu_torch.optim import pose_opt as tpo
from orbslam_mapsave_tpu_torch.optim.pose_problem import CAM, make_problem

torch.set_num_threads(2)
FIELDS = ("pt_w", "uv", "ur", "inv_sigma2", "valid")
JCAM = jproj.Camera.create(CAM.fx, CAM.fy, CAM.cx, CAM.cy, bf=CAM.bf,
                           width=CAM.width, height=CAM.height)


def _both(p, pose0=None):
    pose0 = np.eye(4, dtype=np.float32) if pose0 is None else pose0
    jobs = jpo.PoseObs(*[jnp.asarray(p[k]) for k in FIELDS])
    tobs = tpo.PoseObs(*[torch.from_numpy(p[k]) for k in FIELDS])
    return jobs, tobs, jnp.asarray(pose0), torch.from_numpy(pose0)


@pytest.mark.parametrize("M", [900, 1024, 2048])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_plain_matches_jax(M, ref):
    p = make_problem(M)
    jobs, tobs, jp0, tp0 = _both(p)
    if ref == "xla":
        pj, ij, nj = jpo.pose_optimization_xla(JCAM, jp0, jobs)
    else:
        pj, ij, nj = pose_opt_pallas.pose_optimization_pallas(
            JCAM, jp0, jobs, interpret=True)
    pt, it, nt = tpo.pose_optimization(CAM, tp0, tobs)
    assert np.abs(np.asarray(pj) - pt.numpy()).max() <= 1e-5
    assert np.array_equal(np.asarray(ij), it.numpy())
    assert int(nj) == int(nt)
    assert np.abs(pt.numpy() - p["T_true"]).max() < 5e-3


@pytest.mark.parametrize("case", ["all_invalid", "all_behind"])
def test_degenerate_returns_input_pose(case):
    p = make_problem(1024, seed=3)
    if case == "all_invalid":
        p["valid"][:] = False
    else:  # every point behind the camera: H = 0 on the active set
        p["pt_w"][:, 2] *= -1.0
    pose0 = np.eye(4, dtype=np.float32)
    jobs, tobs, jp0, tp0 = _both(p, pose0)
    pj, _, nj = jpo.pose_optimization_xla(JCAM, jp0, jobs)
    pt, it, nt = tpo.pose_optimization(CAM, tp0, tobs)
    np.testing.assert_array_equal(pt.numpy(), pose0)
    np.testing.assert_array_equal(np.asarray(pj), pose0)
    assert int(nt) == int(nj) == 0 and not bool(it.any())


def test_cpu_dispatch_uses_plain_version():
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda

    p = make_problem(512)
    _, tobs, _, tp0 = _both(p)
    pose_opt_cuda.reset_launches()
    a = tpo.pose_optimization(CAM, tp0, tobs)
    b = tpo.pose_optimization_ref(CAM, tp0, tobs)
    assert pose_opt_cuda.launches == 0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
