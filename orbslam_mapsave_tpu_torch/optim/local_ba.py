"""Levenberg-Marquardt bundle adjustment with an explicit Schur complement.

Port of `orbslam_mapsave_tpu/optim/local_ba.py`: g2o's `BlockSolver_6_3` +
`OptimizationAlgorithmLevenberg` as used by
`Optimizer::LocalBundleAdjustment` (`src/Optimizer.cc:453-779`) and
`Optimizer::GlobalBundleAdjustemnt` (`:41-47`), plus the gathered-pose
edge terms and robust cost that the distributed BA (`parallel/dist_ba.py`)
runs on its point shards.

- The solve runs on the point-major (L points x O lanes) observation
  table; padded lanes carry zero weight.
- Landmark blocks Hpp are 3x3 lane-local sums, inverted in closed form.
- Every camera-side reduction is a product with the (L,O,C) one-hot of
  obs_cam (exact in float32 for 0/1 operands with TF32 off), and the
  reduced camera system S = Hcc - W Hpp^-1 W^T is assembled densely
  through per-point camera stacks T[l,c,6,3], then solved by Cholesky.
- Huber IRLS with deltas sqrt(5.991) / sqrt(7.815); fixed cameras enter the
  residuals and get identity rows in the solve.
- The 5-then-10 iteration schedule with outlier pruning between phases and
  an abort flag that skips the second phase (`src/Optimizer.cc:660-717`).

The JAX version's `lax.while_loop` / `lax.cond` become Python loops and
`if`s on values read from the device: one read per LM iteration. Each LM
iteration (`_lm_step`) runs over static buffers (`_LMGraphs`) kept per
camera, device and problem shape (C, L, O), as one `cudagraph.Graph` per
robust flag: on a CUDA device one graph replay.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..geometry import projection, se3
from ..utils import cudagraph
from . import global_ba, lm


class BAProblem(NamedTuple):
    cam_pose: torch.Tensor  # (C,4,4) initial Tcw
    cam_fixed: torch.Tensor  # (C,) bool — pose held constant
    cam_valid: torch.Tensor  # (C,) bool
    pt_pos: torch.Tensor  # (L,3) initial world positions
    pt_valid: torch.Tensor  # (L,) bool
    obs_cam: torch.Tensor  # (L,O) i32 camera index or -1
    obs_uv: torch.Tensor  # (L,O,2) undistorted pixels
    obs_ur: torch.Tensor  # (L,O) right-u, <0 mono
    obs_inv_sigma2: torch.Tensor  # (L,O)
    obs_valid: torch.Tensor  # (L,O) bool


class BAResult(NamedTuple):
    cam_pose: torch.Tensor  # (C,4,4)
    pt_pos: torch.Tensor  # (L,3)
    obs_inlier: torch.Tensor  # (L,O) bool — final classification
    chi2: torch.Tensor  # () total chi2 of the inliers


# Cost charged to an edge a candidate step pushed behind the camera: g2o
# keeps such edges with huge residuals, so a divergent step must not look
# like an improvement (see the JAX module).
_BEHIND_PENALTY = 1e7
# An LM phase ends after two consecutive steps that each change the cost
# by less than this share of it.
_RTOL = 1e-6


def _onehot_cam(prob: BAProblem) -> torch.Tensor:
    """(L,O,C) f32 one-hot of obs_cam: the dense reduction operator,
    constant over the LM iterations of one problem."""
    C = prob.cam_pose.shape[0]
    cams = torch.arange(C, dtype=torch.int32, device=prob.obs_cam.device)
    oh = (prob.obs_cam[..., None] == cams) & (prob.obs_cam >= 0)[..., None]
    return oh.to(prob.pt_pos.dtype)


def _edge_terms_po(cam: projection.Camera, poses: torch.Tensor, pts: torch.Tensor,
                   prob: BAProblem, oh: torch.Tensor):
    """Residuals / Jacobians per (L,O) lane. Returns r (L,O,3), Jc (L,O,3,6),
    Jp (L,O,3,3), chi2 (L,O), ok_struct (L,O), ok_z (L,O), is_st (L,O); the
    third residual row is the stereo uR term, zero for mono edges."""
    ok_struct = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    R = torch.einsum("loc,cjk->lojk", oh, poses[:, :3, :3])
    t = torch.einsum("loc,cj->loj", oh, poses[:, :3, 3])
    p_cam = torch.sum(R * pts[:, None, None, :], dim=-1) + t
    z = p_cam[..., 2]
    ok_z = z > 1e-6
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    ur = u - cam.bf / zs
    is_st = prob.obs_ur >= 0
    r = torch.stack([prob.obs_uv[..., 0] - u, prob.obs_uv[..., 1] - v,
                     torch.where(is_st, prob.obs_ur - ur, torch.zeros_like(ur))], dim=-1)
    J_proj = lm.proj_jacobian(p_cam, cam.fx, cam.fy)  # (L,O,2,3)
    zi2 = 1.0 / (zs * zs)
    zero = torch.zeros_like(z)
    dur_dp = J_proj[..., 0, :] + torch.stack([zero, zero, cam.bf * zi2], dim=-1)
    dur_dp = torch.where(is_st[..., None], dur_dp, torch.zeros_like(dur_dp))
    A = torch.cat([J_proj, dur_dp[..., None, :]], dim=-2)  # (L,O,3,3)
    Jc_pt = lm.point_pose_jacobian(p_cam)  # (L,O,3,6)
    Jc = -torch.sum(A[..., :, :, None] * Jc_pt[..., None, :, :], dim=-2)
    Jp = -torch.sum(A[..., :, :, None] * R[..., None, :, :], dim=-2)
    chi2 = torch.sum(r * r, -1) * prob.obs_inv_sigma2
    return r, Jc, Jp, chi2, ok_struct, ok_z, is_st


def _delta2(is_st: torch.Tensor) -> torch.Tensor:
    return torch.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO).to(torch.float32)


def _huber_rho(chi2, is_st) -> torch.Tensor:
    """Huber's rho on chi2 (squared residual over its sigma): chi2 inside
    the gate, 2 d |e| - d^2 outside."""
    delta2 = _delta2(is_st)
    return torch.where(chi2 <= delta2, chi2,
                       2.0 * torch.sqrt(delta2) * torch.sqrt(torch.clamp(chi2, min=0)) - delta2)


def _accept_cost_po(chi2, is_st, ok_z, active, robust: bool) -> torch.Tensor:
    """LM acceptance objective: Huber chi2 over active lanes; a lane behind
    the camera (or non-finite) pays _BEHIND_PENALTY."""
    val = _huber_rho(chi2, is_st) if robust else chi2
    pen = torch.full_like(val, _BEHIND_PENALTY)
    val = torch.where(ok_z, val, pen)
    val = torch.where(torch.isfinite(val), val, pen)
    return torch.sum(torch.where(active, val, torch.zeros_like(val)))


def _edge_terms(cam: projection.Camera, poses: torch.Tensor, pts: torch.Tensor,
                prob: BAProblem):
    """Per-lane residuals / Jacobians over the padded (L,O) table with each
    lane's pose gathered by its camera index (JAX `local_ba._edge_terms`,
    the distributed BA's layout: no one-hot, so the point axis shards).
    Returns r (L,O,3), Jc (L,O,3,6), Jp (L,O,3,3), chi2 (L,O), ok (L,O):
    a live lane in front of its camera, is_st (L,O)."""
    r, Jc, Jp, chi2, ok_z, is_st = global_ba._edge_terms(
        cam, poses[torch.clamp(prob.obs_cam, min=0).long()], pts[:, None, :],
        prob.obs_uv, prob.obs_ur, prob.obs_inv_sigma2)
    ok = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None] & ok_z
    return r, Jc, Jp, chi2, ok, is_st


def _robust_chi2(chi2, is_st, ok, robust: bool) -> torch.Tensor:
    """Sum over the `ok` lanes of Huber's rho (robust) or of chi2: the
    distributed BA's cost, with no penalty for lanes behind the camera."""
    val = _huber_rho(chi2, is_st) if robust else chi2
    return torch.sum(torch.where(ok, val, torch.zeros_like(val)))


def _cost_at(cam, poses, pts, prob, oh, active, robust: bool) -> torch.Tensor:
    _, _, _, chi2, _, ok_z, is_st = _edge_terms_po(cam, poses, pts, prob, oh)
    return _accept_cost_po(chi2, is_st, ok_z, active, robust)


def _build_and_solve(cam, poses, pts, prob, oh, active, robust: bool, lam):
    """One damped LM step. Returns (dx_cam (C,6), dx_pt (L,3)).

    With OH the (L,O,C) one-hot: Hcc = OH^T Hcc_lo, T1 = OH^T (W Hpp^-1),
    T2 = OH^T W per point, S = diag(Hcc) - sum_l T1 T2^T, all dense."""
    C = prob.cam_pose.shape[0]
    r, Jc, Jp, chi2, ok_s, ok_z, is_st = _edge_terms_po(cam, poses, pts, prob, oh)
    ok = active & ok_s & ok_z
    w_rob = lm.huber_weight(chi2, _delta2(is_st)) if robust else torch.ones_like(chi2)
    w = torch.where(ok, prob.obs_inv_sigma2 * w_rob, torch.zeros_like(chi2))  # (L,O)

    free = prob.cam_valid & ~prob.cam_fixed  # (C,)
    # fixed cameras contribute no derivatives
    free_lane = torch.einsum("loc,c->lo", oh, free.to(oh.dtype)) > 0.5
    Jc = torch.where(free_lane[..., None, None], Jc, torch.zeros_like(Jc))

    wJp = Jp * w[..., None, None]
    wJc = Jc * w[..., None, None]
    Hpp = torch.sum(wJp[..., :, :, None] * Jp[..., :, None, :], dim=(1, 2))  # (L,3,3)
    gp = -torch.sum(wJp * r[..., None], dim=(1, 2))  # (L,3)
    Hcc_lo = torch.sum(wJc[..., :, :, None] * Jc[..., :, None, :], dim=-3)  # (L,O,6,6)
    gc_lo = -torch.sum(wJc * r[..., None], dim=-2)  # (L,O,6)
    W_lo = torch.sum(wJc[..., :, :, None] * Jp[..., :, None, :], dim=-3)  # (L,O,6,3)
    pt_has_obs = torch.sum(w, dim=-1) > 0

    # Marquardt-damped landmark blocks, inverted in closed form
    eye3 = torch.eye(3, dtype=pts.dtype, device=pts.device)
    Hpp_diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_d = Hpp + eye3 * (lam * Hpp_diag + 1e-8)[..., None]
    Hpp_inv = lm.inv3x3(torch.where(pt_has_obs[:, None, None], Hpp_d, eye3))

    L, O = w.shape
    cam_flat = torch.cat([Hcc_lo.reshape(L, O, 36), gc_lo], dim=-1)  # (L,O,42)
    red = torch.einsum("loc,loz->cz", oh, cam_flat)
    Hcc = red[:, :36].reshape(C, 6, 6)
    gc = red[:, 36:42]

    WHinv_lo = torch.sum(W_lo[..., :, :, None] * Hpp_inv[:, None, None, :, :], dim=-2)
    rhs_corr_lo = torch.sum(WHinv_lo * gp[:, None, None, :], dim=-1)  # (L,O,6)
    rhs_corr = torch.einsum("loc,loa->ca", oh, rhs_corr_lo)

    T1 = torch.einsum("loc,loak->lcak", oh, WHinv_lo)
    T2 = torch.einsum("loc,loak->lcak", oh, W_lo)
    S = -torch.einsum("lcak,ldbk->cadb", T1, T2)  # (C,6,C,6)
    idx = torch.arange(C, device=pts.device)
    Hcc_diag = torch.diagonal(Hcc, dim1=-2, dim2=-1)
    eye6 = torch.eye(6, dtype=pts.dtype, device=pts.device)
    S[idx, :, idx, :] += Hcc + eye6 * (lam * Hcc_diag + 1e-8)[..., None]
    rhs = gc - rhs_corr

    # flatten to (6C,6C); fixed / invalid cameras get identity rows
    Sf = S.reshape(C * 6, C * 6)
    mask = torch.repeat_interleave(free, 6)
    Sf = torch.where(mask[:, None] & mask[None, :], Sf, torch.zeros_like(Sf))
    Sf = Sf + torch.diag((~mask).to(Sf.dtype))
    rhs_f = torch.where(mask, rhs.reshape(-1), torch.zeros_like(mask, dtype=rhs.dtype))
    # S is SPD by construction; a failed factorization (info != 0) gives a
    # zero step, as the JAX version's NaN -> 0 rule does
    chol, info = torch.linalg.cholesky_ex(Sf)
    dx_cam = torch.cholesky_solve(rhs_f[:, None], chol)[:, 0].reshape(C, 6)
    good = torch.isfinite(dx_cam) & (info == 0)
    dx_cam = torch.where(good, dx_cam, torch.zeros_like(dx_cam))

    # back-substitute landmarks: dx_p = Hpp^-1 (gp - W^T dx_cam)
    dx_lane = torch.einsum("loc,ca->loa", oh, dx_cam)
    Wt_dx = torch.sum(W_lo * dx_lane[..., :, None], dim=(1, 2))  # (L,3)
    dx_pt = torch.sum(Hpp_inv * (gp - Wt_dx)[:, None, :], dim=-1)
    keep = (pt_has_obs & prob.pt_valid)[:, None] & torch.isfinite(dx_pt)
    return dx_cam, torch.where(keep, dx_pt, torch.zeros_like(dx_pt))


def _lm_step(cam, prob, oh, active, robust: bool, free, poses, pts, lam, cur, small):
    """One damped LM iteration: (poses, pts, lam, cur, small) -> the next.
    A rejected step keeps the state and raises lam; `small` counts the
    consecutive steps that changed the cost by < _RTOL * cost."""
    dxc, dxp = _build_and_solve(cam, poses, pts, prob, oh, active, robust, lam)
    new_poses = se3.se3_exp(torch.where(free, dxc, torch.zeros_like(dxc))) @ poses
    new_pts = pts + dxp
    new = _cost_at(cam, new_poses, new_pts, prob, oh, active, robust)
    accept = new < cur
    small = torch.where((cur - new) < _RTOL * cur, small + 1, torch.zeros_like(small))
    poses = torch.where(accept, new_poses, poses)
    pts = torch.where(accept, new_pts, pts)
    cur = torch.where(accept, new, cur)
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
    return poses, pts, lam, cur, small


class _LMGraphs:
    """`_lm_step` over static buffers for one camera, device and problem
    shape: the problem, its one-hot, the active lanes and the free cameras
    as inputs, and the iteration state (poses, pts, lam, cur, small),
    which each step writes in place. `steps[robust]` is one step as a
    `cudagraph.Graph` ("mapping.ba_graph")."""

    def __init__(self, cam: projection.Camera, prob: BAProblem):
        self.cam = cam
        self.prob = BAProblem(*[torch.empty_like(x) for x in prob])
        (L, O), C = prob.obs_cam.shape, prob.cam_pose.shape[0]
        x = prob.pt_pos
        self.oh = x.new_empty((L, O, C))
        self.active = torch.empty((L, O), dtype=torch.bool, device=x.device)
        self.free = torch.empty((C, 1), dtype=torch.bool, device=x.device)
        self.state = (x.new_empty((C, 4, 4)), x.new_empty((L, 3)), x.new_empty(()),
                      x.new_empty(()), torch.empty((), dtype=torch.int32, device=x.device))
        self.steps = {robust: cudagraph.Graph("mapping.ba_graph", x.device,
                                              functools.partial(self._body, robust),
                                              into=self.state)
                      for robust in (True, False)}

    def _body(self, robust: bool):
        return _lm_step(self.cam, self.prob, self.oh, self.active, robust, self.free,
                        *self.state)

    def load(self, prob: BAProblem, oh: torch.Tensor) -> "_LMGraphs":
        """Copy one problem and its one-hot into the static inputs."""
        for dst, src in zip(self.prob, prob):
            dst.copy_(src)
        self.oh.copy_(oh)
        self.free.copy_((prob.cam_valid & ~prob.cam_fixed)[:, None])
        return self


# (camera, device, dtype, C, L, O) -> the static buffers and graphs of that shape
_GRAPHS: dict[tuple, _LMGraphs] = {}


def _graphs_for(cam: projection.Camera, prob: BAProblem, oh: torch.Tensor) -> _LMGraphs:
    """The static buffers of prob's shape on its device, holding prob."""
    x = prob.pt_pos
    key = (cam, x.device, x.dtype, prob.cam_pose.shape[0]) + tuple(prob.obs_cam.shape)
    graphs = _GRAPHS.get(key)
    if graphs is None:
        graphs = _GRAPHS[key] = _LMGraphs(cam, prob)
    return graphs.load(prob, oh)


def _run_phase(static: _LMGraphs, poses, pts, active, robust: bool, n_iters: int,
               lam0: torch.Tensor):
    """Up to n_iters damped LM steps on the problem `static` holds, from
    (poses, pts), ending early once two consecutive steps each change the
    cost by < _RTOL * cost. As in the JAX version a rejected step counts as
    a small gain (ROADMAP queue 3). Returns poses, pts and the cost, copied
    out of the buffers."""
    cur = _cost_at(static.cam, poses, pts, static.prob, static.oh, active, robust)
    small = torch.zeros((), dtype=torch.int32, device=pts.device)
    static.active.copy_(active)
    for dst, src in zip(static.state, (poses, pts, lam0, cur, small)):
        dst.copy_(src)
    step = static.steps[robust]
    for _ in range(n_iters):
        step()
        if int(static.state[4]) >= 2:
            break
    poses, pts, cur = (static.state[i].clone() for i in (0, 1, 3))
    # project the rotations back onto SO(3) (chained f32 products drift)
    return se3.orthonormalize(poses), pts, cur


def _inliers(cam, poses, pts, prob, oh, struct):
    _, _, _, chi2, _, ok_z, is_st = _edge_terms_po(cam, poses, pts, prob, oh)
    return struct & ok_z & (chi2 <= _delta2(is_st)), chi2


def local_bundle_adjustment(cam: projection.Camera, prob: BAProblem,
                            n_iters_a: int = 5, n_iters_b: int = 10,
                            abort: bool = False) -> BAResult:
    """The reference schedule: 5 robust iterations, outlier pruning (chi2
    over its gate or behind the camera), 10 more without the robust kernel
    (`src/Optimizer.cc:660-717`); `abort` skips the second phase like
    `mbAbortBA` (`src/LocalMapping.cc:118`)."""
    oh = _onehot_cam(prob)
    static = _graphs_for(cam, prob, oh)
    struct = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    lam0 = torch.full((), 1e-4, dtype=prob.pt_pos.dtype, device=prob.pt_pos.device)
    poses, pts, _ = _run_phase(static, prob.cam_pose, prob.pt_pos, struct, True, n_iters_a,
                               lam0)
    if not abort:
        active, _ = _inliers(cam, poses, pts, prob, oh, struct)
        poses, pts, _ = _run_phase(static, poses, pts, active, False, n_iters_b, lam0)
    inlier, chi2 = _inliers(cam, poses, pts, prob, oh, struct)
    total = torch.sum(torch.where(inlier, chi2, torch.zeros_like(chi2)))
    return BAResult(cam_pose=poses, pt_pos=pts, obs_inlier=inlier, chi2=total)


def global_bundle_adjustment(cam: projection.Camera, prob: BAProblem,
                             n_iters: int = 20) -> BAResult:
    """`Optimizer::GlobalBundleAdjustemnt` [sic] (`src/Optimizer.cc:41-47`):
    one robust phase of up to n_iters LM iterations over the whole problem,
    the first camera fixed by the caller through cam_fixed."""
    oh = _onehot_cam(prob)
    struct = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    lam0 = torch.full((), 1e-4, dtype=prob.pt_pos.dtype, device=prob.pt_pos.device)
    poses, pts, _ = _run_phase(_graphs_for(cam, prob, oh), prob.cam_pose, prob.pt_pos,
                               struct, True, n_iters, lam0)
    inlier, chi2 = _inliers(cam, poses, pts, prob, oh, struct)
    total = torch.sum(torch.where(inlier, chi2, torch.zeros_like(chi2)))
    return BAResult(cam_pose=poses, pt_pos=pts, obs_inlier=inlier, chi2=total)
