"""Motion-only pose optimization (the per-frame hot optimizer).

Port of `orbslam_mapsave_tpu/optim/pose_opt.py`, `Optimizer::PoseOptimization`
parity (`src/Optimizer.cc:239-451`): 4 rounds x 10 LM iterations, Huber
(sqrt 5.991 mono / sqrt 7.815 stereo) on the first two rounds only, and
inter-round outlier reclassification on raw chi2.

`pose_optimization` (one problem) and `pose_optimization_batched` (B problems
with a leading batch dimension, relocalization's candidates) dispatch on the
device of their inputs: CPU tensors take the plain PyTorch schedule
(`pose_optimization_ref`, once per problem), CUDA tensors the hand-written
kernel in `pose_opt_cuda.py`, one launch for all B problems. There is no
fallback between the two: a CUDA input launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import projection, se3
from . import lm


class PoseObs(NamedTuple):
    """Fixed-capacity match set for one frame."""

    pt_w: torch.Tensor  # (M,3) world points
    uv: torch.Tensor  # (M,2) observed undistorted pixels
    ur: torch.Tensor  # (M,) observed right-u; < 0 -> mono edge
    inv_sigma2: torch.Tensor  # (M,) per-octave information
    valid: torch.Tensor  # (M,) bool candidate mask


def _residuals(cam: projection.Camera, pose_cw: torch.Tensor, obs: PoseObs):
    """Residuals + chi2 per edge. Stereo edges get a 3rd (uR) component."""
    p_cam = se3.transform_points(pose_cw, obs.pt_w)
    uv_hat, z = projection.project(cam, p_cam)
    zsafe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    ur_hat = uv_hat[..., 0] - cam.bf / zsafe
    is_stereo = obs.ur >= 0
    e_uv = obs.uv - uv_hat
    e_ur = torch.where(is_stereo, obs.ur - ur_hat, torch.zeros_like(ur_hat))
    chi2 = (torch.sum(e_uv * e_uv, -1) + e_ur * e_ur) * obs.inv_sigma2
    behind = z <= 0
    return p_cam, e_uv, e_ur, chi2, is_stereo, behind


def _normal_system(cam: projection.Camera, pose_cw: torch.Tensor, obs: PoseObs,
                   active: torch.Tensor, robust: bool):
    """Accumulate H (6,6), g (6,) over active edges with optional Huber, and
    the acceptance cost (edges behind the camera pay a fixed 1e7)."""
    p_cam, e_uv, e_ur, chi2, is_stereo, behind = _residuals(cam, pose_cw, obs)
    active_in = active
    active = active & ~behind
    delta2 = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO).to(chi2.dtype)
    w_rob = lm.huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
    w = obs.inv_sigma2 * w_rob * active.to(pose_cw.dtype)

    J_proj = lm.proj_jacobian(p_cam, cam.fx, cam.fy)  # (M,2,3)
    J_pt = lm.point_pose_jacobian(p_cam)  # (M,3,6)
    J_uv = -torch.einsum("mij,mjk->mik", J_proj, J_pt)  # (M,2,6)
    z = p_cam[..., 2]
    zi2 = 1.0 / torch.square(torch.where(torch.abs(z) < 1e-9,
                                         torch.full_like(z, 1e-9), z))
    dur_dp = J_proj[:, 0, :] + torch.stack(
        [torch.zeros_like(z), torch.zeros_like(z), cam.bf * zi2], dim=-1)
    J_ur = -torch.einsum("mj,mjk->mk", dur_dp, J_pt)  # (M,6)
    J_ur = torch.where(is_stereo[:, None], J_ur, torch.zeros_like(J_ur))

    Hm = torch.einsum("mia,mib->mab", J_uv, J_uv) + torch.einsum(
        "ma,mb->mab", J_ur, J_ur)
    gm = torch.einsum("mia,mi->ma", J_uv, e_uv) + J_ur * e_ur[:, None]
    H = torch.einsum("mab,m->ab", Hm, w)
    g = -torch.einsum("ma,m->a", gm, w)
    val = torch.where(behind, torch.full_like(chi2, 1e7), chi2 * w_rob)
    val = torch.where(torch.isfinite(val), val, torch.full_like(val, 1e7))
    total_chi2 = torch.sum(torch.where(active_in, val, torch.zeros_like(val)))
    return H, g, total_chi2


def _reclassify(cam, pose, obs):
    """Inliers against raw chi2 (no robust weight), Optimizer.cc:396-430."""
    _, _, _, chi2, is_stereo, behind = _residuals(cam, pose, obs)
    gate = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO).to(chi2.dtype)
    return obs.valid & (chi2 <= gate) & ~behind


def _lm_rounds(cam, pose0, obs, n_rounds=4, n_iters=10):
    """The reference's 4x10 schedule with inter-round outlier reclassification.

    One normal system per LM iteration, as the CUDA kernel runs it: the
    candidate's H, g and cost come from one evaluation. Its cost decides
    acceptance; an accepted candidate's system is the next one, and a
    rejected step keeps the current system (pose, inliers and robust flag
    are unchanged), so only lambda moves. This equals the reference's
    two evaluations per iteration (its cost-only pass is the cost term of
    the normal system)."""
    pose = pose0
    inlier = obs.valid
    for rnd in range(n_rounds):
        robust = rnd < 2  # kernels dropped from round 2 (Optimizer.cc:434-437)
        if rnd > 0:
            inlier = _reclassify(cam, pose, obs)
        lam = torch.tensor(1e-4, dtype=pose0.dtype, device=pose0.device)
        H, g, chi2 = _normal_system(cam, pose, obs, inlier, robust)
        for _ in range(n_iters):
            dx = lm.solve_spd(H, g, lam)
            new_pose = se3.se3_exp(dx) @ pose
            new_H, new_g, new_chi2 = _normal_system(cam, new_pose, obs, inlier,
                                                    robust)
            accept = new_chi2 < chi2
            pose = torch.where(accept, new_pose, pose)
            H = torch.where(accept, new_H, H)
            g = torch.where(accept, new_g, g)
            chi2 = torch.where(accept, new_chi2, chi2)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-10, 1e6)
    return pose, _reclassify(cam, pose, obs) if n_rounds else inlier


def pose_optimization_ref(cam: projection.Camera, pose0_cw: torch.Tensor,
                          obs: PoseObs):
    """The plain PyTorch schedule; returns (pose_cw, inlier_mask, n_inliers).

    ~40 f32 exp()@pose products leave the rotation slightly off SO(3), so
    the result is projected back every call (see se3.orthonormalize)."""
    pose, inlier = _lm_rounds(cam, pose0_cw, obs)
    pose = se3.orthonormalize(pose)
    return pose, inlier, torch.sum(inlier.to(torch.int32))


def pose_optimization(cam: projection.Camera, pose0_cw: torch.Tensor,
                      obs: PoseObs):
    """Run the full schedule; returns (pose_cw, inlier_mask, n_inliers).

    CPU tensors run the plain schedule; CUDA tensors run the hand-written
    kernel (`pose_opt_cuda.pose_optimization_cuda`) and raise if it cannot
    build or launch."""
    if pose0_cw.device.type == "cpu":
        return pose_optimization_ref(cam, pose0_cw, obs)
    from . import pose_opt_cuda

    pose, inlier, n = pose_opt_cuda.pose_optimization_cuda(
        cam, pose0_cw[None], PoseObs(*[x[None] for x in obs]))
    return pose[0], inlier[0], n[0]


def pose_optimization_batched(cam: projection.Camera, pose0_cw: torch.Tensor,
                              obs: PoseObs):
    """B independent problems: pose0_cw (B,4,4), obs with a leading B on
    every field. Returns (pose_cw (B,4,4), inlier (B,M), n_inliers (B,)).

    The JAX relocalizer runs `vmap(pose_optimization_xla)` over its
    candidates (`relocalization.py:80-89,164-165`); here CUDA tensors make
    ONE kernel launch for all B problems and CPU tensors run the plain
    schedule per problem."""
    if pose0_cw.device.type == "cpu":
        outs = [pose_optimization_ref(cam, pose0_cw[b], PoseObs(*[x[b] for x in obs]))
                for b in range(pose0_cw.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    from . import pose_opt_cuda

    return pose_opt_cuda.pose_optimization_cuda(cam, pose0_cw, obs)
