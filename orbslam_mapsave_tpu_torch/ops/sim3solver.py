"""Closed-form Sim3 between point sets (Horn 1987) + batched RANSAC.

Port of `orbslam_mapsave_tpu/ops/sim3solver.py` (`Sim3Solver`,
`src/Sim3Solver.cc`): 3-point minimal sets, rotation from the
max-eigenvalue eigenvector of Horn's 4x4 N matrix (`:226-337`), scale =
sum(Pr2 . R Pr1) / sum(|R Pr1|^2) or fixed (stereo / RGB-D), and RANSAC
with both-direction pixel gates 9.210 * sigma^2 per octave
(`CheckInliers`, `:340-365`); all hypotheses are solved as one batch.

The JAX version draws each hypothesis with `jax.random.choice` from a
PRNGKey; that stream cannot be reproduced here. `ransac_sim3` takes the
hypotheses as an argument (so a test can hand both sides the same ones) or
draws them from a `torch.Generator`: 3 indices without replacement,
uniform over the valid matches, as the 3 largest of iid uniform keys.
"""

from __future__ import annotations

import torch

from ..geometry import se3

CHI2_SIM3 = 9.210  # Sim3Solver ctor per-scale threshold


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (...,4) (x,y,z,w) -> rotation matrix (...,3,3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.where(n > 0, n, torch.ones_like(n)),
                    torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], -2)


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor,
              fix_scale: bool = False) -> torch.Tensor:
    """Batched Horn alignment: s, R, t with p2 ~ s R p1 + t. p1, p2 (B,n,3),
    w (B,n) weights/mask. Returns the Sim3 (B,4,4) taking frame-1 to
    frame-2 coordinates (sR in the rotation block)."""
    wn = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    o1 = torch.einsum("bn,bni->bi", wn, p1)
    o2 = torch.einsum("bn,bni->bi", wn, p2)
    pr1 = (p1 - o1[:, None]) * w[..., None]
    pr2 = (p2 - o2[:, None]) * w[..., None]
    M = torch.einsum("bni,bnj->bij", pr2, pr1)  # (B,3,3)
    # Horn's N matrix (Sim3Solver.cc:247-265)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N11, N12, N13, N14 = Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx
    N22, N23, N24 = Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz
    N33, N34, N44 = -Sxx + Syy - Szz, Syz + Szy, -Sxx - Syy + Szz
    N = torch.stack([
        torch.stack([N11, N12, N13, N14], -1),
        torch.stack([N12, N22, N23, N24], -1),
        torch.stack([N13, N23, N33, N34], -1),
        torch.stack([N14, N24, N34, N44], -1),
    ], -2)
    _, evecs = torch.linalg.eigh(N)  # ascending
    q = evecs[..., -1]  # max eigenvalue -> quaternion (w,x,y,z); sign free
    # the conjugate rotates frame-1 residuals onto frame-2 (see JAX version)
    R = _quat_to_rot(torch.cat([-q[..., 1:4], q[..., 0:1]], -1))
    p3 = torch.einsum("bij,bnj->bni", R, pr1)
    if fix_scale:
        s = torch.ones(p1.shape[0], dtype=p1.dtype, device=p1.device)
    else:
        s = torch.sum(pr2 * p3, dim=(-1, -2)) / torch.clamp(
            torch.sum(p3 * p3, dim=(-1, -2)), min=1e-12)
    t = o2 - s[:, None] * torch.einsum("bij,bj->bi", R, o1)
    return se3.sim3_make(s, R, t)


def _project_pix(pts_cam: torch.Tensor, fx, fy, cx, cy):
    zc = pts_cam[..., 2]
    z = torch.where(torch.abs(zc) < 1e-9, torch.full_like(zc, 1e-9), zc)
    return torch.stack([fx * pts_cam[..., 0] / z + cx,
                        fy * pts_cam[..., 1] / z + cy], -1), zc


def draw_hypotheses(valid: torch.Tensor, n_hyp: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """(n_hyp, 3) match indices, each row 3 distinct valid matches drawn
    uniformly (the 3 largest of iid uniform keys; invalid matches rank
    last, as `jax.random.choice(..., replace=False, p=valid/n)` gives them
    zero probability)."""
    u = torch.rand((n_hyp, valid.shape[0]), generator=generator, device=valid.device)
    key = torch.where(valid[None, :], u, torch.full_like(u, -1.0))
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][:, :3]


def ransac_sim3(pc1: torch.Tensor, pc2: torch.Tensor, uv1: torch.Tensor,
                uv2: torch.Tensor, n_hyp: int = 300, fix_scale: bool = False,
                max_err1: torch.Tensor | None = None,
                max_err2: torch.Tensor | None = None,
                valid: torch.Tensor | None = None,
                fx: float = 1.0, fy: float = 1.0, cx: float = 0.0, cy: float = 0.0,
                min_inliers: int = 20, hyp_idx: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
    """Batched RANSAC over 3-point Horn hypotheses. pc1/pc2 (M,3): matched
    points in the camera frames of KF1/KF2; uv1/uv2 (M,2) their observed
    pixels; max_err1/2 (M,) squared pixel gates. hyp_idx (n_hyp,3) fixes the
    hypotheses, else they are drawn from `generator`. Returns (S12 (4,4)
    mapping camera-2 to camera-1 coordinates, inliers (M,), n_inliers, ok)."""
    M = pc1.shape[0]
    dev = pc1.device
    if valid is None:
        valid = torch.ones(M, dtype=torch.bool, device=dev)
    if max_err1 is None:
        max_err1 = torch.full((M,), CHI2_SIM3, dtype=pc1.dtype, device=dev)
    if max_err2 is None:
        max_err2 = torch.full((M,), CHI2_SIM3, dtype=pc1.dtype, device=dev)
    idx = (draw_hypotheses(valid, n_hyp, generator) if hyp_idx is None
           else hyp_idx.to(dev)).long()
    S12 = horn_sim3(pc2[idx], pc1[idx], torch.ones(idx.shape, dtype=pc1.dtype, device=dev),
                    fix_scale=fix_scale)  # maps cam2 -> cam1 coords
    S21 = se3.sim3_inv(S12)
    # both directions in pixels (CheckInliers, Sim3Solver.cc:340-365)
    p2in1 = torch.einsum("bij,nj->bni", S12[:, :3, :3], pc2) + S12[:, None, :3, 3]
    p1in2 = torch.einsum("bij,nj->bni", S21[:, :3, :3], pc1) + S21[:, None, :3, 3]
    pr1, _ = _project_pix(p2in1, fx, fy, cx, cy)
    pr2, _ = _project_pix(p1in2, fx, fy, cx, cy)
    e1 = torch.sum((pr1 - uv1[None]) ** 2, -1)
    e2 = torch.sum((pr2 - uv2[None]) ** 2, -1)
    inl = valid[None] & (e1 < max_err1[None]) & (e2 < max_err2[None])
    counts = torch.sum(inl.to(torch.int32), -1)
    best = torch.argmax(counts)
    # refine the best hypothesis on its inliers with a full Horn solve
    w_ref = inl[best].to(pc1.dtype)[None]
    S12r = horn_sim3(pc2[None], pc1[None], w_ref, fix_scale=fix_scale)[0]
    S21r = se3.sim3_inv(S12r)
    pr1r, _ = _project_pix(se3.sim3_transform_points(S12r, pc2), fx, fy, cx, cy)
    pr2r, _ = _project_pix(se3.sim3_transform_points(S21r, pc1), fx, fy, cx, cy)
    e1r = torch.sum((pr1r - uv1) ** 2, -1)
    e2r = torch.sum((pr2r - uv2) ** 2, -1)
    inl_r = valid & (e1r < max_err1) & (e2r < max_err2)
    n_r = torch.sum(inl_r.to(torch.int32))
    use_r = n_r >= counts[best]
    S_out = torch.where(use_r, S12r, S12[best])
    inl_out = torch.where(use_r, inl_r, inl[best])
    n_out = torch.maximum(n_r, counts[best])
    return S_out, inl_out, n_out, n_out >= min_inliers
