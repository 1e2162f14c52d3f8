"""Full-map bundle adjustment: the reduced camera system solved densely or
by preconditioned conjugate gradients.

Port of `orbslam_mapsave_tpu/optim/global_ba.py`
(`Optimizer::GlobalBundleAdjustemnt`, `src/Optimizer.cc:41-237`): every
valid keyframe and point in one problem, laid out point-major (P points x
O_GBA observation lanes) and camera-major (K keyframes x N feature lanes),
both holding the same edge set. Three solvers of the camera system:

- `"dense"` (K <= 384): every camera-side sum (Hcc, gc, the Schur
  complement S = Hcc - W Hpp^-1 W^T) is a contraction against the (P,O,K)
  one-hot of the observing camera; S is assembled in 8 point chunks and
  solved by Cholesky.
- `"pcg"` (more live keyframes): the same one-hot sums, S applied
  implicitly inside block-Jacobi PCG (the 6x6 diagonal of S).
- `"pcg_dual"` (whenever the one-hot would take 2 GiB or more): no one-hot
  at all; point-side sums run over the O axis of the point-major lanes,
  camera-side sums over the N axis of the camera-major lanes, and the
  Schur product chains the two through row gathers; damped-Hcc
  block-Jacobi PCG. (The JAX version stores these lanes as flat 1-D
  planes for the TPU's tiling; here they keep their (P,O) and (K,N)
  shapes.)

Every sum is a contraction or a reduction over a lane axis, never a float
scatter-add, so card runs repeat bit for bit. LM damping, gauge fixing on
keyframe slot 0 and the small-gain stop match the JAX version. The
incremental form (`gba_init` + one `gba_iterate` per LM iteration) is what
the loop closer's global-BA job pumps; the one-shot form
(`full_bundle_adjustment`) is the monocular bootstrap's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import projection, se3
from ..slammap import mapstate as ms
from . import lm

_BEHIND_PENALTY = 1e7  # see local_ba._BEHIND_PENALTY
O_GBA = 16  # observation lanes per point in the full-map problem (of MAX_OBS)
GBA_RTOL = 1e-5  # an accepted step gaining less than this share of the cost is small
DENSE_MAX_K = 384  # solver="auto": dense up to this many keyframe slots, pcg above
SOLVERS = ("dense", "pcg", "pcg_dual")


def _route(solver: str, K: int) -> str:
    """The solver a call runs: "auto" is dense up to DENSE_MAX_K keyframe
    slots and pcg above (JAX `full_bundle_adjustment`)."""
    if solver == "auto":
        return "dense" if K <= DENSE_MAX_K else "pcg"
    if solver not in SOLVERS:
        raise ValueError(f"unknown global-BA solver {solver!r}")
    return solver


class FullBATables(NamedTuple):
    """Static structure of the full-map problem in both layouts."""

    po_cam: torch.Tensor  # (P,O) i32 observing KF slot, -1 pad
    po_uv: torch.Tensor  # (P,O,2) undistorted pixels
    po_ur: torch.Tensor  # (P,O) right-u, <0 mono
    po_is2: torch.Tensor  # (P,O) inv sigma^2
    po_valid: torch.Tensor  # (P,O) bool
    cm_pt: torch.Tensor  # (K,N) i32 observed point slot, -1 pad
    cm_uv: torch.Tensor  # (K,N,2)
    cm_ur: torch.Tensor  # (K,N)
    cm_is2: torch.Tensor  # (K,N)
    cm_valid: torch.Tensor  # (K,N) bool
    cam_free: torch.Tensor  # (K,) bool — valid and not gauge-fixed
    cam_valid: torch.Tensor  # (K,) bool
    pt_valid: torch.Tensor  # (P,) bool


def _c0(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0).long()


def build_tables(state: ms.MapState, inv_level_sigma2: torch.Tensor) -> FullBATables:
    """Both edge layouts from the map state; keyframe slot 0 is held fixed.
    A forward edge whose reverse lane lies past O_GBA (or was dropped at
    MAX_OBS) is masked out of the camera-major layout, so both layouts hold
    the same edge set."""
    K, N = state.kf_kp_point.shape
    n_lv = inv_level_sigma2.shape[0]
    o_kf = state.pt_obs_kf[:, :O_GBA]
    o_ix = state.pt_obs_idx[:, :O_GBA]
    po_live = (o_kf >= 0) & state.pt_valid[:, None] & state.kf_valid[_c0(o_kf)]
    sk, si = _c0(o_kf), _c0(o_ix)
    po_is2 = inv_level_sigma2[torch.clamp(state.kf_kp_octave[sk, si], 0, n_lv - 1).long()]
    c_pt = state.kf_kp_point
    cm_live = (c_pt >= 0) & state.kf_valid[:, None] & state.pt_valid[_c0(c_pt)]
    rev_kf = o_kf[_c0(c_pt)]  # (K,N,O_GBA)
    rev_ix = o_ix[_c0(c_pt)]
    k_ids = torch.arange(K, dtype=torch.int32, device=c_pt.device)[:, None, None]
    n_ids = torch.arange(N, dtype=torch.int32, device=c_pt.device)[None, :, None]
    cm_live = cm_live & ((rev_kf == k_ids) & (rev_ix == n_ids)).any(-1)
    fixed_mask = torch.zeros(K, dtype=torch.bool, device=c_pt.device)
    fixed_mask[0] = True
    return FullBATables(
        po_cam=torch.where(po_live, o_kf, -1), po_uv=state.kf_kp_xy[sk, si],
        po_ur=state.kf_kp_ur[sk, si], po_is2=po_is2, po_valid=po_live,
        cm_pt=torch.where(cm_live, c_pt, -1), cm_uv=state.kf_kp_xy,
        cm_ur=state.kf_kp_ur,
        cm_is2=inv_level_sigma2[torch.clamp(state.kf_kp_octave, 0, n_lv - 1).long()],
        cm_valid=cm_live, cam_free=state.kf_valid & ~fixed_mask,
        cam_valid=state.kf_valid, pt_valid=state.pt_valid)


def _edge_terms(cam: projection.Camera, pose_lane, pt_lane, uv, ur, is2):
    """Residual/Jacobian blocks per lane (g2o's mono/stereo projection
    edges, the stereo row zeroed for mono). pose_lane (...,4,4), pt_lane
    (...,3). Returns r (...,3), Jc (...,3,6), Jp (...,3,3), chi2, ok_z, is_st."""
    R = pose_lane[..., :3, :3]
    p_cam = torch.sum(R * pt_lane[..., None, :], dim=-1) + pose_lane[..., :3, 3]
    z = p_cam[..., 2]
    ok_z = z > 1e-6
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    ur_pred = u - cam.bf / zs
    is_st = ur >= 0
    r = torch.stack([uv[..., 0] - u, uv[..., 1] - v,
                     torch.where(is_st, ur - ur_pred, torch.zeros_like(u))], dim=-1)
    J_proj = lm.proj_jacobian(p_cam, cam.fx, cam.fy)  # (...,2,3)
    zero = torch.zeros_like(z)
    dur_dp = J_proj[..., 0, :] + torch.stack([zero, zero, cam.bf / (zs * zs)], dim=-1)
    dur_dp = torch.where(is_st[..., None], dur_dp, torch.zeros_like(dur_dp))
    A = torch.cat([J_proj, dur_dp[..., None, :]], dim=-2)  # (...,3,3)
    Jc = -torch.sum(A[..., :, :, None] * lm.point_pose_jacobian(p_cam)[..., None, :, :], dim=-2)
    Jp = -torch.sum(A[..., :, :, None] * R[..., None, :, :], dim=-2)
    chi2 = torch.sum(r * r, -1) * is2
    return r, Jc, Jp, chi2, ok_z, is_st


def _onehot_po(tb: FullBATables, K: int) -> torch.Tensor:
    """(P,O,K) f32 one-hot of each lane's observing camera (all-zero rows
    for dead lanes): the operator of every camera-side sum."""
    ids = torch.arange(K, dtype=torch.int32, device=tb.po_cam.device)
    return (tb.po_cam[..., None] == ids).to(torch.float32)


def _po_terms(cam, poses, pts, tb: FullBATables):
    """Edge terms over the point-major lanes. Each lane's pose is a row
    gather (the zero matrix on dead lanes), which selects exactly what the
    JAX version's one-hot contraction does."""
    live = (tb.po_cam >= 0)[..., None, None]
    pose_lane = torch.where(live, poses[_c0(tb.po_cam)], torch.zeros((), device=poses.device))
    return _edge_terms(cam, pose_lane, pts[:, None, :], tb.po_uv, tb.po_ur, tb.po_is2)


def _accept_cost(cam, poses, pts, tb: FullBATables, robust: bool) -> torch.Tensor:
    """LM acceptance objective over the point-major lanes (Huber chi2 with a
    fixed penalty for behind-camera projections)."""
    _, _, _, chi2, ok_z, is_st = _po_terms(cam, poses, pts, tb)
    delta2 = torch.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO).to(chi2.dtype)
    rho = torch.where(chi2 <= delta2, chi2,
                      2.0 * torch.sqrt(delta2) * torch.sqrt(torch.clamp(chi2, min=0)) - delta2)
    val = rho if robust else chi2
    pen = torch.full_like(val, _BEHIND_PENALTY)
    val = torch.where(ok_z, val, pen)
    val = torch.where(torch.isfinite(val), val, pen)
    return torch.sum(torch.where(tb.po_valid, val, torch.zeros_like(val)))


def _weights(chi2, ok_z, live, is2, is_st, robust: bool):
    delta2 = torch.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO).to(chi2.dtype)
    w_rob = lm.huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
    return torch.where(live & ok_z, is2 * w_rob, torch.zeros_like(chi2))


def _point_blocks(cam, poses, pts, tb: FullBATables, robust: bool, lam):
    """The point-major lanes reduced per point: (r, Jc, w Jc, W (P,O,6,3),
    Hpp^-1 (P,3,3) damped, gp (P,3), pt_has). Camera Jacobians are zeroed
    on lanes of fixed or dead keyframes."""
    r_po, Jc_po, Jp_po, chi2_po, okz_po, st_po = _po_terms(cam, poses, pts, tb)
    free_lane = tb.cam_free[_c0(tb.po_cam)] & (tb.po_cam >= 0) & tb.po_valid
    Jc_po = torch.where(free_lane[..., None, None], Jc_po, torch.zeros_like(Jc_po))
    w_po = _weights(chi2_po, okz_po, tb.po_valid, tb.po_is2, st_po, robust)
    wJp = Jp_po * w_po[..., None, None]
    wJc = Jc_po * w_po[..., None, None]
    Hpp = torch.sum(wJp[..., :, :, None] * Jp_po[..., :, None, :], dim=(1, 2))  # (P,3,3)
    gp = -torch.sum(wJp * r_po[..., None], dim=(1, 2))  # (P,3)
    W_po = torch.sum(wJc[..., :, :, None] * Jp_po[..., :, None, :], dim=-3)  # (P,O,6,3)
    pt_has = (torch.sum(w_po, -1) > 0) & tb.pt_valid
    eye3 = torch.eye(3, dtype=pts.dtype, device=pts.device)
    Hpp_d = Hpp + eye3 * (lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8)[..., None]
    Hpp_inv = lm.inv3x3(torch.where(pt_has[:, None, None], Hpp_d, eye3))
    Hpp_inv = torch.where(pt_has[:, None, None], Hpp_inv, torch.zeros_like(Hpp_inv))
    return r_po, Jc_po, wJc, W_po, Hpp_inv, gp, pt_has


def _damped_cams(Hcc: torch.Tensor, lam, cam_free: torch.Tensor) -> torch.Tensor:
    """Hcc with lam-scaled diagonal damping; identity blocks for fixed and
    invalid keyframes."""
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Hcc_d = Hcc + eye6 * (lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8)[..., None]
    return torch.where(cam_free[:, None, None], Hcc_d, eye6)


def _schur_blocks(cam, poses, pts, tb: FullBATables, robust: bool, lam, oh: torch.Tensor):
    """The one-hot routes' LM-step prologue: per-lane blocks reduced to
    (W_po, WH, Hpp_inv, Hcc_d, rhs, gp, pt_has)."""
    K = poses.shape[0]
    P, O = tb.po_cam.shape
    r_po, Jc_po, wJc, W_po, Hpp_inv, gp, pt_has = _point_blocks(cam, poses, pts, tb, robust,
                                                                lam)
    # camera blocks: one-hot contractions over the same lanes
    JcwJc = torch.sum(wJc[..., :, :, None] * Jc_po[..., :, None, :], dim=-3)  # (P,O,6,6)
    oh_f = oh.reshape(P * O, K).T  # (K,P*O)
    Hcc = (oh_f @ JcwJc.reshape(P * O, 36)).reshape(K, 6, 6)
    gc = -(oh_f @ torch.sum(wJc * r_po[..., None], dim=-2).reshape(P * O, 6))
    Hcc_d = _damped_cams(Hcc, lam, tb.cam_free)

    WH = torch.einsum("poab,pbc->poac", W_po, Hpp_inv)  # (P,O,6,3)
    gp_z = torch.sum(Hpp_inv * gp[:, None, :], dim=-1)  # (P,3)
    rhs = gc - oh_f @ torch.sum(W_po * gp_z[:, None, None, :], dim=-1).reshape(P * O, 6)
    rhs = torch.where(tb.cam_free[:, None], rhs, torch.zeros_like(rhs))
    return W_po, WH, Hpp_inv, Hcc_d, rhs, gp, pt_has


def _backsub_points(tb, W_po, Hpp_inv, gp, pt_has, dx_cam):
    """dx_p = Hpp^-1 (gp - W^T dx_cam); each lane's camera step by a row
    gather (zero on dead lanes)."""
    live = (tb.po_cam >= 0)[..., None]
    dx_lane = torch.where(live, dx_cam[_c0(tb.po_cam)], torch.zeros((), device=dx_cam.device))
    Wt_dx = torch.sum(W_po * dx_lane[..., :, None], dim=(1, 2))  # (P,3)
    dx_pt = torch.sum(Hpp_inv * (gp - Wt_dx)[:, None, :], dim=-1)
    keep = (pt_has & tb.pt_valid)[:, None] & torch.isfinite(dx_pt)
    return torch.where(keep, dx_pt, torch.zeros_like(dx_pt))


def _solve_dense(cam, poses, pts, tb: FullBATables, robust: bool, lam, oh: torch.Tensor,
                 n_chunks: int = 8):
    """One damped LM step with the reduced camera system materialized and
    Cholesky-solved. The off-diagonal assembly S -= sum_p A_p B_p^T runs
    in n_chunks point chunks, in chunk order, as the JAX version's scan;
    a failed factorization gives a zero camera step (JAX: NaN -> 0)."""
    K = poses.shape[0]
    W_po, WH, Hpp_inv, Hcc_d, rhs, gp, pt_has = _schur_blocks(
        cam, poses, pts, tb, robust, lam, oh)
    P, O = W_po.shape[:2]
    nc = n_chunks if P % n_chunks == 0 else 1
    pc = P // nc
    S = torch.zeros((K, 6, K, 6), dtype=pts.dtype, device=pts.device)
    idx = torch.arange(K, device=pts.device)
    S[idx, :, idx, :] = Hcc_d
    for c in range(nc):
        sl = slice(c * pc, (c + 1) * pc)
        oh_t = oh[sl].transpose(1, 2)  # (pc,K,O)
        A = torch.bmm(oh_t, WH[sl].reshape(pc, O, 18)).reshape(pc, K * 6, 3)
        B = torch.bmm(oh_t, W_po[sl].reshape(pc, O, 18)).reshape(pc, K * 6, 3)
        S = S - (A.transpose(0, 1).reshape(K * 6, pc * 3)
                 @ B.transpose(0, 1).reshape(K * 6, pc * 3).T).reshape(K, 6, K, 6)
    Sf = S.reshape(K * 6, K * 6)
    mask = torch.repeat_interleave(tb.cam_free, 6)
    Sf = torch.where(mask[:, None] & mask[None, :], Sf, torch.zeros_like(Sf))
    Sf = Sf + torch.diag((~mask).to(Sf.dtype))
    L, info = torch.linalg.cholesky_ex(Sf)
    dx_cam = torch.cholesky_solve(rhs.reshape(-1, 1), L).reshape(K, 6)
    dx_cam = torch.where(torch.isfinite(dx_cam) & (info == 0) & tb.cam_free[:, None],
                         dx_cam, torch.zeros_like(dx_cam))
    return dx_cam, _backsub_points(tb, W_po, Hpp_inv, gp, pt_has, dx_cam)


def _inv_blocks(D: torch.Tensor) -> torch.Tensor:
    """Inverse of each (6,6) block; a block that does not invert gives the
    identity (the JAX non-finite -> identity rule)."""
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    Minv, info = torch.linalg.inv_ex(D)
    return torch.where(torch.isfinite(Minv) & (info == 0)[:, None, None], Minv, eye6)


def _solve_pcg(cam, poses, pts, tb: FullBATables, robust: bool, lam, oh: torch.Tensor,
               cg_iters: int, cg_tol: float):
    """One damped LM step by PCG on the implicit Schur complement (JAX
    `_solve_pcg`): camera-side sums against the one-hot, the exact 6x6
    diagonal of S as block-Jacobi preconditioner, stopping at
    |r| <= cg_tol * |rhs|."""
    K = poses.shape[0]
    W_po, WH, Hpp_inv, Hcc_d, rhs, gp, pt_has = _schur_blocks(
        cam, poses, pts, tb, robust, lam, oh)
    P, O = W_po.shape[:2]
    oh_f = oh.reshape(P * O, K).T  # (K,P*O)
    live = (tb.po_cam >= 0)[..., None]
    cam_ix = _c0(tb.po_cam)

    def matvec(x):  # (K,6) -> (K,6)
        x_lane = torch.where(live, x[cam_ix], torch.zeros((), device=x.device))
        t = torch.sum(W_po * x_lane[..., :, None], dim=(1, 2))  # (P,3)
        z = torch.sum(Hpp_inv * t[:, None, :], dim=-1)
        contrib = torch.sum(W_po * z[:, None, None, :], dim=-1)  # (P,O,6)
        return (Hcc_d @ x[..., None])[..., 0] - oh_f @ contrib.reshape(P * O, 6)

    WHW = torch.einsum("poac,podc->poad", WH, W_po)  # (P,O,6,6)
    S_diag = Hcc_d - (oh_f @ WHW.reshape(P * O, 36)).reshape(K, 6, 6)
    S_diag = torch.where(tb.cam_free[:, None, None], S_diag,
                         torch.eye(6, dtype=pts.dtype, device=pts.device))
    Minv = _inv_blocks(S_diag)
    tol = cg_tol * torch.clamp(torch.sqrt(torch.sum(rhs * rhs)), min=1e-20)
    dx_cam = lm.pcg(matvec, lambda v: (Minv @ v[..., None])[..., 0], rhs, cg_iters,
                    lambda r: torch.sqrt(torch.sum(r * r)) > tol)
    dx_cam = torch.where(torch.isfinite(dx_cam) & tb.cam_free[:, None], dx_cam,
                         torch.zeros_like(dx_cam))
    return dx_cam, _backsub_points(tb, W_po, Hpp_inv, gp, pt_has, dx_cam)


def _solve_pcg_dual(cam, poses, pts, tb: FullBATables, robust: bool, lam,
                    cg_iters: int, cg_tol: float):
    """One damped LM step by PCG with no one-hot (JAX `_solve_pcg_planar`):
    point-side blocks summed over the O axis of the point-major lanes,
    camera-side blocks over the N axis of the camera-major lanes; the Schur
    product gathers x to the point lanes (W^T x, Hpp^-1) and the result to
    the camera lanes (W z). Preconditioner: the damped Hcc blocks; stops at
    |r| / |rhs| <= cg_tol."""
    _, _, _, W_po, Hpp_inv, gp, pt_has = _point_blocks(cam, poses, pts, tb, robust, lam)
    cam_ix = _c0(tb.po_cam)

    # camera-major blocks: each keyframe's pose broadcast over its lanes
    pt_ix = _c0(tb.cm_pt)
    r_cm, Jc_cm, Jp_cm, chi2_cm, okz_cm, st_cm = _edge_terms(
        cam, poses[:, None], pts[pt_ix], tb.cm_uv, tb.cm_ur, tb.cm_is2)
    w_cm = _weights(chi2_cm, okz_cm, tb.cm_valid, tb.cm_is2, st_cm, robust)
    w_cm = torch.where(tb.cam_free[:, None] & tb.cm_valid, w_cm, torch.zeros_like(w_cm))
    wJc = Jc_cm * w_cm[..., None, None]
    Hcc = torch.sum(wJc[..., :, :, None] * Jc_cm[..., :, None, :], dim=(1, 2))  # (K,6,6)
    gc = -torch.sum(wJc * r_cm[..., None], dim=(1, 2))
    W_cm = torch.sum(wJc[..., :, :, None] * Jp_cm[..., :, None, :], dim=-3)  # (K,N,6,3)
    Hcc_d = _damped_cams(Hcc, lam, tb.cam_free)

    def hpp_apply(v):  # (P,3)
        return torch.sum(Hpp_inv * v[:, None, :], dim=-1)

    def cam_side(z):  # sum_N W_cm z_lane: (P,3) -> (K,6)
        return torch.sum(W_cm * z[pt_ix][..., None, :], dim=(1, 3))

    rhs = gc - cam_side(hpp_apply(gp))
    rhs = torch.where(tb.cam_free[:, None], rhs, torch.zeros_like(rhs))

    def matvec(x):  # (K,6)
        t = torch.sum(W_po * x[cam_ix][..., :, None], dim=(1, 2))  # (P,3)
        return (Hcc_d @ x[..., None])[..., 0] - cam_side(hpp_apply(t))

    Minv = _inv_blocks(Hcc_d)
    rhs_norm = torch.sqrt(torch.sum(rhs * rhs)) + 1e-30
    dx_cam = lm.pcg(matvec, lambda v: (Minv @ v[..., None])[..., 0], rhs, cg_iters,
                    lambda r: torch.sqrt(torch.sum(r * r)) / rhs_norm > cg_tol,
                    safe_pAp=lambda d: torch.clamp(d, min=1e-30))
    dx_cam = torch.where(torch.isfinite(dx_cam) & tb.cam_free[:, None], dx_cam,
                         torch.zeros_like(dx_cam))
    return dx_cam, _backsub_points(tb, W_po, Hpp_inv, gp, pt_has, dx_cam)


def _lm_step(cam, poses, pts, tb: FullBATables, robust: bool, lam, solver: str,
             cg_iters: int, cg_tol: float, oh: torch.Tensor | None = None):
    """(dx_cam, dx_pt) of one damped LM step by the named solver; the
    one-hot routes build `oh` unless given it."""
    if solver == "pcg_dual":
        return _solve_pcg_dual(cam, poses, pts, tb, robust, lam, cg_iters, cg_tol)
    if oh is None:
        oh = _onehot_po(tb, poses.shape[0])
    if solver == "dense":
        return _solve_dense(cam, poses, pts, tb, robust, lam, oh)
    return _solve_pcg(cam, poses, pts, tb, robust, lam, oh, cg_iters, cg_tol)


def full_bundle_adjustment(cam: projection.Camera, state: ms.MapState,
                           inv_level_sigma2: torch.Tensor, n_iters: int = 10,
                           robust: bool = False, solver: str = "auto", cg_iters: int = 100,
                           cg_tol: float = 1e-3):
    """Full-map BA over every valid keyframe and point, n_iters damped LM
    iterations in one call (the monocular bootstrap runs 20 robust ones,
    `src/Tracking.cc:931`). Unlike `gba_iterate` there is no small-gain
    stop, and the poses come back orthonormalized, as in the JAX version.
    `solver` is "dense", "pcg", "pcg_dual" or "auto" (`_route`).
    Returns (kf_pose (K,4,4), pt_pos (P,3), final cost)."""
    inv_level_sigma2 = torch.as_tensor(inv_level_sigma2, device=state.device)
    tb = build_tables(state, inv_level_sigma2)
    poses, pts = state.kf_pose, state.pt_pos
    solver = _route(solver, poses.shape[0])
    oh = _onehot_po(tb, poses.shape[0]) if solver != "pcg_dual" else None
    cur = _accept_cost(cam, poses, pts, tb, robust)
    lam = torch.tensor(1e-4, dtype=pts.dtype, device=state.device)
    for _ in range(n_iters):
        dxc, dxp = _lm_step(cam, poses, pts, tb, robust, lam, solver, cg_iters, cg_tol, oh)
        new_poses = se3.se3_exp(dxc) @ poses
        new_pts = pts + dxp
        new = _accept_cost(cam, new_poses, new_pts, tb, robust)
        accept = new < cur
        poses = torch.where(accept, new_poses, poses)
        pts = torch.where(accept, new_pts, pts)
        cur = torch.where(accept, new, cur)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
    return se3.orthonormalize(poses), pts, cur


def gba_init(cam: projection.Camera, state: ms.MapState, inv_level_sigma2: torch.Tensor,
             robust: bool = False, solver: str = "dense"):
    """Problem tables + initial carry (poses, pts, lam, cost, small-gain
    streak) of an incremental global BA. Every solver shares the tables:
    both lane layouts, which pcg_dual reads and the one-hot routes rebuild
    their operator from at each iteration."""
    _route(solver, state.kf_capacity)
    tb = build_tables(state, inv_level_sigma2)
    cur0 = _accept_cost(cam, state.kf_pose, state.pt_pos, tb, robust)
    lam0 = torch.tensor(1e-4, dtype=state.pt_pos.dtype, device=state.device)
    small = torch.zeros((), dtype=torch.int32, device=state.device)
    return tb, (state.kf_pose, state.pt_pos, lam0, cur0, small)


def gba_iterate(cam: projection.Camera, tb: FullBATables, poses, pts, lam, cur, small,
                robust: bool = False, solver: str = "dense", cg_iters: int = 100,
                cg_tol: float = 1e-3):
    """One damped LM iteration (the JAX `gba_iterate`). `small` counts
    consecutive accepted steps that gain < GBA_RTOL * cost; from 2 on, the
    carry passes through untouched. That test is a host `if` on one read."""
    solver = _route(solver, poses.shape[0])
    if int(small) >= 2:
        return poses, pts, lam, cur, small
    dxc, dxp = _lm_step(cam, poses, pts, tb, robust, lam, solver, cg_iters, cg_tol)
    new_poses = se3.se3_exp(dxc) @ poses
    new_pts = pts + dxp
    new = _accept_cost(cam, new_poses, new_pts, tb, robust)
    accept = new < cur
    gain_small = accept & ((cur - new) < GBA_RTOL * cur)
    small_ = torch.where(gain_small, small + 1, torch.where(accept, torch.zeros_like(small),
                                                            small))
    return (torch.where(accept, new_poses, poses), torch.where(accept, new_pts, pts),
            torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8),
            torch.where(accept, new, cur), small_)
