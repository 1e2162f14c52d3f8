"""Vectorized EPnP + RANSAC for relocalization.

Port of `orbslam_mapsave_tpu/ops/epnp.py` (`PnPsolver`, `src/PnPsolver.cc`):
EPnP (Lepetit et al.) with 4 control points from PCA
(`choose_control_points`, `PnPsolver.cc:378`), barycentric coordinates,
the 2n x 12 M system reduced to M^T M (12x12) and its eigenvectors
(`compute_pose:480`), beta cases N=1/2/3 with Gauss-Newton refinement over
the L_6x10 system (`gauss_newton:843`), closed-form R,t (Horn), and a few
Gauss-Newton pose steps on the reprojection residual. RANSAC solves all
hypotheses as one batch with the reference's gates (minInliers,
maxIterations, per-scale chi2 thresholds, `PnPsolver.cc:121-157`).

The JAX version draws its 4-point sets with `jax.random.choice` from a
PRNGKey; that stream cannot be reproduced here. `ransac_pnp` takes the
(n_hyp, 4) hypothesis indices as an argument (`draw_hypotheses` draws them
from a `torch.Generator`), so a test can hand both sides the same ones.

The eigenvectors of `eigh` differ in sign, and within a repeated
eigenvalue in basis, between LAPACK, cuSOLVER and XLA. On a minimal 4-point
set (every RANSAC hypothesis) M^T M has a 4-dimensional null space, and the
beta approximations are not invariant to the basis chosen in it: the two
packages then give different poses for the same set about as often as not,
while each recovers the true pose equally often (tests/test_torch_epnp.py).
With more points the null space is one vector and the poses agree; compare
poses, never eigenvectors. `inv` / `solve` of a singular system give
non-finite values as in JAX instead of raising; a hypothesis whose M^T M is
not finite (a degenerate draw) yields a NaN pose and so no inliers, as
there.
"""

from __future__ import annotations

import torch

from ..geometry import se3
from ..optim import lm as lm_mod


def _eigh(A: torch.Tensor):
    """Ascending eigh of symmetric (...,k,k); non-finite rows come back as
    NaN instead of making LAPACK / cuSOLVER raise."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    evals, evecs = torch.linalg.eigh(torch.where(bad[..., None, None], eye, A))
    nan = torch.full_like(evecs, float("nan"))
    return (torch.where(bad[..., None], torch.full_like(evals, float("nan")), evals),
            torch.where(bad[..., None, None], nan, evecs))


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.solve` (LU): a singular system gives non-finite values."""
    return torch.linalg.solve_ex(A, b)[0]


def _choose_control_points(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,n,3), weights (B,n) -> control points (B,4,3): the weighted
    centroid, then centroid + sqrt(eig/n) * eigvec in descending order
    (`choose_control_points`, `PnPsolver.cc:378-410`)."""
    wn = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    c = torch.einsum("bn,bni->bi", wn, pts)
    d = (pts - c[:, None]) * torch.sqrt(torch.clamp(w, min=0.0))[..., None]
    n_eff = torch.clamp(torch.sum(w, -1), min=1e-9)
    cov = torch.einsum("bni,bnj->bij", d, d) / n_eff[:, None, None]
    evals, evecs = _eigh(cov)
    evals = torch.flip(evals, [-1])
    evecs = torch.flip(evecs, [-1])
    scale = torch.sqrt(torch.clamp(evals, min=1e-12))
    cws_rest = c[:, None, :] + scale[..., None] * evecs.transpose(-1, -2)
    return torch.cat([c[:, None, :], cws_rest], dim=1)


def _barycentric(pts: torch.Tensor, cws: torch.Tensor) -> torch.Tensor:
    """alphas (B,n,4) with sum 1 (`compute_barycentric_coordinates`)."""
    CC = (cws[:, 1:4] - cws[:, 0:1]).transpose(-1, -2)
    CCinv = torch.linalg.inv_ex(CC + 1e-12 * torch.eye(3, dtype=CC.dtype, device=CC.device))[0]
    rel = pts - cws[:, 0:1]
    a123 = torch.einsum("bij,bnj->bni", CCinv, rel)
    a0 = 1.0 - torch.sum(a123, -1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _fill_MtM(alphas: torch.Tensor, uv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """M^T M (B,12,12) from normalized pixels uv (fu = fv = 1, uc = vc = 0)
    and per-point weights."""
    B, n, _ = alphas.shape
    u, v = uv[..., 0], uv[..., 1]
    zeros = torch.zeros_like(alphas)
    Mu = torch.stack([alphas, zeros, -alphas * u[..., None]], dim=-1).reshape(B, n, 12)
    Mv = torch.stack([zeros, alphas, -alphas * v[..., None]], dim=-1).reshape(B, n, 12)
    return (torch.einsum("bni,bn,bnj->bij", Mu, w, Mu)
            + torch.einsum("bni,bn,bnj->bij", Mv, w, Mv))


_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _compute_L6x10(V: torch.Tensor) -> torch.Tensor:
    """V (B,4,12): the 4 smallest eigenvectors. L (B,6,10) over the 6
    control-point pairs and the 10 beta products [b11,b12,b22,b13,b23,b33,
    b14,b24,b34,b44] (`compute_L_6x10`, `PnPsolver.cc:778-841`)."""
    v = V.reshape(V.shape[0], 4, 4, 3)
    dv = torch.stack([v[:, :, a] - v[:, :, b] for a, b in _PAIRS], dim=2)

    def dot(i, j):
        return torch.sum(dv[:, i] * dv[:, j], -1)

    cols = [dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2),
            dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3)]
    return torch.stack(cols, dim=-1)


def _compute_rho(cws: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.sum((cws[:, a] - cws[:, b]) ** 2, -1) for a, b in _PAIRS],
                       dim=-1)


def _lstsq_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    AtA = torch.einsum("bri,brj->bij", A, A)
    Atb = torch.einsum("bri,br->bi", A, b)
    k = AtA.shape[-1]
    return _solve(AtA + 1e-9 * torch.eye(k, dtype=A.dtype, device=A.device),
                  Atb[..., None])[..., 0]


def _betas_approx_1(L: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """N=4 case via columns [0,1,3,6] (`find_betas_approx_1`)."""
    x = _lstsq_small(L[..., [0, 1, 3, 6]], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    sgn = torch.sign(torch.where(x[..., 0] == 0, torch.ones_like(x[..., 0]), x[..., 0]))
    den = torch.clamp(b1, min=1e-12)
    return torch.stack([b1, x[..., 1] / den * sgn, x[..., 2] / den * sgn,
                        x[..., 3] / den * sgn], dim=-1)


def _betas_approx_2(L: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Columns [0,1,2] (`find_betas_approx_2`)."""
    x = _lstsq_small(L[..., [0, 1, 2]], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    b2 = torch.sqrt(torch.abs(x[..., 2]))
    b2 = torch.where(x[..., 1] < 0, -b2, b2)
    b2 = torch.where(x[..., 0] < 0, -b2, b2)
    z = torch.zeros_like(b1)
    return torch.stack([torch.abs(b1), b2, z, z], dim=-1)


def _betas_approx_3(L: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Columns [0,1,2,3,4] (`find_betas_approx_3`)."""
    x = _lstsq_small(L[..., [0, 1, 2, 3, 4]], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    b2 = torch.sqrt(torch.abs(x[..., 2]))
    b2 = torch.where(x[..., 1] < 0, -b2, b2)
    b2 = torch.where(x[..., 0] < 0, -b2, b2)
    b3 = x[..., 3] / torch.clamp(b1, min=1e-12)
    return torch.stack([b1, b2, b3, torch.zeros_like(b1)], dim=-1)


def _gauss_newton_betas(L: torch.Tensor, rho: torch.Tensor, betas: torch.Tensor,
                        iters: int = 5) -> torch.Tensor:
    """Refine betas (B,4) minimizing ||L b10(b) - rho|| (`gauss_newton`,
    `PnPsolver.cc:843-861`, 5 iterations); a non-finite step is dropped."""
    eye4 = torch.eye(4, dtype=L.dtype, device=L.device)
    b = betas
    for _ in range(iters):
        b1, b2, b3, b4 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        b10 = torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3,
                           b1 * b4, b2 * b4, b3 * b4, b4 * b4], dim=-1)
        z = torch.zeros_like(b1)
        J10 = torch.stack([
            torch.stack([2 * b1, z, z, z], -1), torch.stack([b2, b1, z, z], -1),
            torch.stack([z, 2 * b2, z, z], -1), torch.stack([b3, z, b1, z], -1),
            torch.stack([z, b3, b2, z], -1), torch.stack([z, z, 2 * b3, z], -1),
            torch.stack([b4, z, z, b1], -1), torch.stack([z, b4, z, b2], -1),
            torch.stack([z, z, b4, b3], -1), torch.stack([z, z, z, 2 * b4], -1),
        ], dim=-2)
        r = rho - torch.einsum("bij,bj->bi", L, b10)
        J = torch.einsum("bij,bjk->bik", L, J10)
        JtJ = torch.einsum("bri,brj->bij", J, J)
        Jtr = torch.einsum("bri,br->bi", J, r)
        db = _solve(JtJ + 1e-9 * eye4, Jtr[..., None])[..., 0]
        b = b + torch.where(torch.isfinite(db), db, torch.zeros_like(db))
    return b


def _pose_from_betas(V, betas, alphas, pts3d, w) -> torch.Tensor:
    """Control points in the camera frame -> R,t by Horn (`compute_ccs`,
    `estimate_R_and_t`, `PnPsolver.cc:580-650`). Returns (B,4,4)."""
    ccs = torch.einsum("bk,bkj->bj", betas, V).reshape(betas.shape[0], 4, 3)
    pcs = torch.einsum("bnk,bkj->bnj", alphas, ccs)
    # sign fix: depths must be positive (solve_for_sign)
    flip = torch.sum(torch.where(w > 0, pcs[..., 2], torch.zeros_like(pcs[..., 2])), -1) < 0
    pcs = torch.where(flip[:, None, None], -pcs, pcs)
    wn = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    c_w = torch.einsum("bn,bni->bi", wn, pts3d)
    c_c = torch.einsum("bn,bni->bi", wn, pcs)
    P = (pts3d - c_w[:, None]) * w[..., None]
    Q = pcs - c_c[:, None]
    H = torch.einsum("bni,bnj->bij", P, Q)
    # a non-finite H (a degenerate draw) gives a NaN pose, as XLA's svd does,
    # instead of making LAPACK / cuSOLVER raise
    bad = ~torch.isfinite(H).all(-1).all(-1)
    U, _, Vt = torch.linalg.svd(torch.where(bad[:, None, None],
                                            torch.eye(3, dtype=H.dtype, device=H.device), H))
    d = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = torch.einsum("bji,bj,bjk->bik", Vt, D, U.transpose(-1, -2))
    t = c_c - torch.einsum("bij,bj->bi", R, c_w)
    R = torch.where(bad[:, None, None], torch.full_like(R, float("nan")), R)
    return se3.rt_to_mat(R, t)


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _reproj_err2(pose, pts3d, uv_norm, w) -> torch.Tensor:
    pc = se3.transform_points(pose, pts3d)
    pr = pc[..., :2] / _safe_z(pc[..., 2])[..., None]
    e2 = torch.sum((pr - uv_norm) ** 2, -1)
    return (torch.sum(torch.where(w > 0, e2, torch.zeros_like(e2)), -1)
            / torch.clamp(torch.sum(w > 0, -1), min=1))


def _gn_pose_polish(pose, pts3d, uv_norm, w, iters: int = 3) -> torch.Tensor:
    """Batched Gauss-Newton on the normalized reprojection residual, a step
    kept only where it lowers the error (the JAX version's recovery of the
    f32 eigh's lost tangent accuracy on minimal sets)."""
    eye6 = torch.eye(6, dtype=pose.dtype, device=pose.device)
    ww = (w > 0).to(pose.dtype)
    for _ in range(iters):
        pc = se3.transform_points(pose, pts3d)
        r = uv_norm - pc[..., :2] / _safe_z(pc[..., 2])[..., None]
        J_proj = lm_mod.proj_jacobian(pc, 1.0, 1.0)
        Jc = -torch.einsum("bnij,bnjk->bnik", J_proj, lm_mod.point_pose_jacobian(pc))
        Hm = torch.einsum("bnia,bn,bnic->bac", Jc, ww, Jc) + 1e-8 * eye6
        g = -torch.einsum("bnia,bn,bni->ba", Jc, ww, r)
        dx = _solve(Hm, g[..., None])[..., 0]
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        new_pose = se3.se3_exp(dx) @ pose
        better = _reproj_err2(new_pose, pts3d, uv_norm, w) < _reproj_err2(
            pose, pts3d, uv_norm, w)
        pose = torch.where(better[:, None, None], new_pose, pose)
    return pose


def _null_space(pts3d: torch.Tensor, uv_norm: torch.Tensor, w: torch.Tensor):
    """Control points (B,4,3), barycentric coordinates (B,n,4) and the 4
    eigenvectors of M^T M with the smallest eigenvalues, V (B,4,12),
    smallest first (`compute_pose`, `PnPsolver.cc:480-500`). On a minimal
    4-point set M^T M has a 4-dimensional null space, and any basis of it
    is an equally valid V: LAPACK, cuSOLVER and XLA each return another."""
    cws = _choose_control_points(pts3d, w)
    alphas = _barycentric(pts3d, cws)
    _, evecs = _eigh(_fill_MtM(alphas, uv_norm, w))
    return cws, alphas, evecs[..., :4].transpose(-1, -2)


def _pose_from_null_space(cws, alphas, V, pts3d, uv_norm, w) -> torch.Tensor:
    """Beta cases 1..3 over V, the best by reprojection (`compute_pose`,
    `PnPsolver.cc:500-532`), then a few Gauss-Newton steps
    (`_gn_pose_polish`). Returns (B,4,4) Tcw."""
    L = _compute_L6x10(V)
    rho = _compute_rho(cws)
    poses, errs = [], []
    for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
        b = _gauss_newton_betas(L, rho, approx(L, rho))
        pose = _pose_from_betas(V, b, alphas, pts3d, w)
        poses.append(pose)
        errs.append(_reproj_err2(pose, pts3d, uv_norm, w))
    errs = torch.stack(errs)  # (3,B)
    poses = torch.stack(poses)  # (3,B,4,4)
    # argmin with NaN like jnp.argmin: the first NaN wins
    key = torch.where(torch.isnan(errs), torch.full_like(errs, -float("inf")), errs)
    best = torch.argmin(key, dim=0)
    pose = poses[best, torch.arange(poses.shape[1], device=poses.device)]
    return _gn_pose_polish(pose, pts3d, uv_norm, w)


def epnp(pts3d: torch.Tensor, uv_norm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched EPnP: (B,n,3) world points, (B,n,2) normalized image
    coordinates, (B,n) weights -> (B,4,4) Tcw."""
    cws, alphas, V = _null_space(pts3d, uv_norm, w)
    return _pose_from_null_space(cws, alphas, V, pts3d, uv_norm, w)


def draw_hypotheses(valid: torch.Tensor, n_hyp: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """(n_hyp, 4) row indices, each row 4 distinct valid rows drawn
    uniformly (the 4 largest of iid uniform keys; invalid rows rank last,
    as `jax.random.choice(..., replace=False, p=valid/n)` gives them zero
    probability)."""
    u = torch.rand((n_hyp, valid.shape[-1]), generator=generator, device=valid.device)
    key = torch.where(valid[None, :], u, torch.full_like(u, -1.0))
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][:, :4]


def _pixel_err2(pcam, uv, fx, fy, cx, cy):
    z = _safe_z(pcam[..., 2])
    return (((pcam[..., 0] / z * fx + cx) - uv[..., 0]) ** 2
            + ((pcam[..., 1] / z * fy + cy) - uv[..., 1]) ** 2)


def ransac_pnp(pts3d: torch.Tensor, uv: torch.Tensor, max_err2: torch.Tensor,
               valid: torch.Tensor, hyp_idx: torch.Tensor,
               fx: float = 1.0, fy: float = 1.0, cx: float = 0.0, cy: float = 0.0,
               min_inliers: int = 10):
    """Batched RANSAC EPnP (`PnPsolver::iterate`, `PnPsolver.cc:165-260`, +
    `Refine`, `:262-307`): every 4-point hypothesis of hyp_idx (n_hyp,4)
    solved at once, inliers by the per-point pixel chi2 gate max_err2
    (sigma-scaled, `SetRansacParameters`, `:154-156`) in front of the
    camera, then one all-inlier EPnP refinement of the best hypothesis,
    kept if it holds at least as many inliers.

    pts3d (M,3), uv (M,2) pixels, max_err2 (M,), valid (M,); a leading
    batch dimension on all five (C problems) solves C problems in one pass.
    Returns (pose (4,4), inliers (M,), n_inliers, ok), batched alike."""
    if pts3d.dim() == 2:
        out = ransac_pnp(pts3d[None], uv[None], max_err2[None], valid[None], hyp_idx[None],
                         fx, fy, cx, cy, min_inliers)
        return tuple(x[0] for x in out)
    C, M = valid.shape
    n_hyp = hyp_idx.shape[1]
    dev = pts3d.device
    uv_norm = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    idx = hyp_idx.to(dev).long()
    rows = torch.arange(C, device=dev)[:, None, None]
    h_pts = pts3d[rows, idx].reshape(C * n_hyp, 4, 3)
    h_uv = uv_norm[rows, idx].reshape(C * n_hyp, 4, 2)
    poses = epnp(h_pts, h_uv, torch.ones((C * n_hyp, 4), dtype=pts3d.dtype, device=dev))
    poses = poses.reshape(C, n_hyp, 4, 4)
    pcam = (torch.einsum("chij,cnj->chni", poses[..., :3, :3], pts3d)
            + poses[:, :, None, :3, 3])
    e2 = _pixel_err2(pcam, uv[:, None], fx, fy, cx, cy)
    inl = valid[:, None] & (e2 <= max_err2[:, None]) & (pcam[..., 2] > 0)
    counts = torch.sum(inl.to(torch.int32), -1)  # (C,n_hyp)
    best = torch.argmax(counts, dim=-1)
    ar = torch.arange(C, device=dev)
    best_inl, n_best = inl[ar, best], counts[ar, best]
    w_ref = torch.where(best_inl, 1.0, 0.0).to(pts3d.dtype)
    pose_ref = epnp(pts3d, uv_norm, w_ref)
    pcam2 = se3.transform_points(pose_ref, pts3d)
    e2r = _pixel_err2(pcam2, uv, fx, fy, cx, cy)
    inl_ref = valid & (e2r <= max_err2) & (pcam2[..., 2] > 0)
    n_ref = torch.sum(inl_ref.to(torch.int32), -1)
    use_ref = n_ref >= n_best
    pose_out = torch.where(use_ref[:, None, None], pose_ref, poses[ar, best])
    inl_out = torch.where(use_ref[:, None], inl_ref, best_inl)
    n_out = torch.maximum(n_ref, n_best)
    return pose_out, inl_out, n_out, n_out >= min_inliers
