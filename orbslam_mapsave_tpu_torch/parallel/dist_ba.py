"""Distributed bundle adjustment: landmarks sharded over the ranks.

Port of `orbslam_mapsave_tpu/parallel/dist_ba.py`. Each rank owns L/n
landmarks and their observation rows (`shard_problem`); the cameras are
replicated. The reduced camera system S = Hcc - W Hpp^-1 W^T is a sum over
landmarks, so each rank reduces its shard (`_local_reduced_system`) and
one `psum` of the (C, C, 6, 6) system and its right-hand side gives every
rank the same system. The dense solve is replicated and landmark
back-substitution stays local. The LM accept test reads the whole
problem's robust cost, the `psum` of each rank's, so every rank accepts the
same steps. Per iteration: one psum of C^2 * 36 + C * 6 floats, plus two
scalars for the cost.

As in the JAX version (and unlike local BA) the damping is absolute: lam I
on each landmark block and on each free camera's rows of S. The JAX
`lax.scan` over `n_iters` is a Python loop with no early exit, so no host
test reads a value and every rank runs the same trip count.
"""

from __future__ import annotations

import torch

from ..geometry import projection, se3
from ..optim import lm
from ..optim.local_ba import BAProblem, BAResult, _edge_terms, _robust_chi2
from .mesh import Mesh, local_rows


def shard_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """This rank's part of the problem on its device: the landmark-major
    arrays' block of rows, the camera arrays whole."""
    dev = mesh.device
    return BAProblem(
        cam_pose=prob.cam_pose.to(dev), cam_fixed=prob.cam_fixed.to(dev),
        cam_valid=prob.cam_valid.to(dev),
        **{f: local_rows(getattr(prob, f), mesh).to(dev) for f in (
            "pt_pos", "pt_valid", "obs_cam", "obs_uv", "obs_ur", "obs_inv_sigma2",
            "obs_valid")})


def _local_reduced_system(cam, poses, pts, prob: BAProblem, active, robust: bool, lam):
    """One rank's landmark blocks and its share of the reduced camera
    system. Returns (S (C,C,6,6), rhs (C,6), Hpp_inv (L,3,3), gp (L,3),
    W (L,O,6,3), pt_has (L,), ok (L,O)). The JAX version scatter-adds the
    per-lane blocks; here each camera-side sum is a contraction against the
    (L,O,C) one-hot of the observing camera, as in local BA."""
    C = prob.cam_pose.shape[0]
    r, Jc, Jp, chi2, ok, is_st = _edge_terms(cam, poses, pts, prob)
    ok = ok & active
    delta2 = torch.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO).to(chi2.dtype)
    w_rob = lm.huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
    w = torch.where(ok, prob.obs_inv_sigma2 * w_rob, torch.zeros_like(chi2))
    free = prob.cam_valid & ~prob.cam_fixed
    safe_cam = torch.clamp(prob.obs_cam, min=0).long()
    Jc = torch.where(free[safe_cam][..., None, None], Jc, torch.zeros_like(Jc))

    wJp = Jp * w[..., None, None]
    wJc = Jc * w[..., None, None]
    Hpp = torch.sum(wJp[..., :, :, None] * Jp[..., :, None, :], dim=(1, 2))  # (L,3,3)
    gp = -torch.sum(wJp * r[..., None], dim=(1, 2))  # (L,3)
    Hcc_e = torch.sum(wJc[..., :, :, None] * Jc[..., :, None, :], dim=-3)  # (L,O,6,6)
    gc_e = -torch.sum(wJc * r[..., None], dim=-2)  # (L,O,6)
    W = torch.sum(wJc[..., :, :, None] * Jp[..., :, None, :], dim=-3)  # (L,O,6,3)

    eye3 = torch.eye(3, dtype=pts.dtype, device=pts.device)
    pt_has = torch.sum(w, -1) > 0
    # unchecked, as jnp.linalg.inv: a singular block's non-finite step is zeroed below
    Hpp_inv = torch.linalg.inv_ex(torch.where(pt_has[:, None, None], Hpp + lam * eye3, eye3))[0]

    # the JAX scatter-adds at clip(obs_cam, 0): a dead lane's blocks are zero
    cams = torch.arange(C, device=pts.device)
    oh = (safe_cam[..., None] == cams).to(pts.dtype)  # (L,O,C)
    Hcc = torch.einsum("loc,loab->cab", oh, Hcc_e)
    gc = torch.einsum("loc,loa->ca", oh, gc_e)
    WHinv = torch.einsum("loab,lbc->loac", W, Hpp_inv)  # (L,O,6,3)
    T1 = torch.einsum("loc,loak->lcak", oh, WHinv)
    T2 = torch.einsum("loc,loak->lcak", oh, W)
    S = -torch.einsum("lcak,ldbk->cdab", T1, T2)  # (C,C,6,6)
    S[cams, cams] += Hcc
    rhs_corr = torch.einsum("loab,lb->loa", WHinv, gp)
    rhs = gc - torch.einsum("loc,loa->ca", oh, rhs_corr)
    return S, rhs, Hpp_inv, gp, W, pt_has, ok


def _cost(cam, poses, pts, prob: BAProblem, active, mesh: Mesh) -> torch.Tensor:
    """The whole problem's robust chi2: each rank's share, summed."""
    _, _, _, chi2, ok, is_st = _edge_terms(cam, poses, pts, prob)
    return mesh.psum(_robust_chi2(chi2, is_st, ok & active, True))


def make_distributed_ba(cam: projection.Camera, mesh: Mesh, n_iters: int = 10):
    """run(prob) -> BAResult: `n_iters` damped robust LM iterations over a
    problem placed by `shard_problem`. The result is whole on every rank:
    the cameras replicated, the landmarks and inlier flags gathered in
    rank order; chi2 is the inliers' total (JAX `dist_ba.py:187-193`)."""

    def one_iteration(poses, pts, prob: BAProblem, active, lam):
        S, rhs, Hpp_inv, gp, W, pt_has, ok = _local_reduced_system(
            cam, poses, pts, prob, active, True, lam)
        S, rhs = mesh.psum(S), mesh.psum(rhs)
        C = S.shape[0]
        free = prob.cam_valid & ~prob.cam_fixed
        Sf = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
        mask = torch.repeat_interleave(free, 6)
        Sf = torch.where(mask[:, None] & mask[None, :], Sf, torch.zeros_like(Sf))
        Sf = Sf + torch.diag(torch.where(mask, lam, torch.ones_like(Sf[0])))
        rhs_f = torch.where(mask, rhs.reshape(-1), torch.zeros_like(Sf[0]))
        dx_cam, info = torch.linalg.solve_ex(Sf, rhs_f)
        dx_cam = dx_cam.reshape(C, 6)
        dx_cam = torch.where(torch.isfinite(dx_cam) & (info == 0), dx_cam,
                             torch.zeros_like(dx_cam))
        # local landmark back-substitution
        safe_cam = torch.clamp(prob.obs_cam, min=0).long()
        Wt_dx = torch.einsum("loab,loa->lb", W, dx_cam[safe_cam] * ok[..., None])
        dx_pt = torch.einsum("lab,lb->la", Hpp_inv, gp - Wt_dx)
        keep = (pt_has & prob.pt_valid)[:, None] & torch.isfinite(dx_pt)
        dx_pt = torch.where(keep, dx_pt, torch.zeros_like(dx_pt))
        new_poses = se3.se3_exp(torch.where(free[:, None], dx_cam,
                                            torch.zeros_like(dx_cam))) @ poses
        return new_poses, pts + dx_pt

    def run(prob: BAProblem) -> BAResult:
        poses, pts, active = prob.cam_pose, prob.pt_pos, prob.obs_valid
        lam = torch.tensor(1e-4, dtype=pts.dtype, device=pts.device)
        for _ in range(n_iters):
            cur = _cost(cam, poses, pts, prob, active, mesh)
            new_poses, new_pts = one_iteration(poses, pts, prob, active, lam)
            accept = _cost(cam, new_poses, new_pts, prob, active, mesh) < cur
            poses = torch.where(accept, new_poses, poses)
            pts = torch.where(accept, new_pts, pts)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
        _, _, _, chi2, ok, is_st = _edge_terms(cam, poses, pts, prob)
        inlier = prob.obs_valid & ok & (chi2 <= torch.where(is_st, lm.CHI2_STEREO,
                                                            lm.CHI2_MONO))
        total = mesh.psum(_robust_chi2(chi2, is_st, inlier, False))
        return BAResult(cam_pose=poses, pt_pos=mesh.all_gather(pts),
                        obs_inlier=mesh.all_gather(inlier), chi2=total)

    return run
