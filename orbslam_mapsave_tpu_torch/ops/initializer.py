"""Two-view geometry: the monocular H / F bootstrap and triangulation.

Port of `orbslam_mapsave_tpu/ops/initializer.py` (`Initializer`,
`src/Initializer.cc`): the reference runs homography and fundamental
RANSAC in two threads (`Initializer.cc:104-105`); here both model families
and all their hypotheses are one batch.

- 8-point sets, 200 iterations, sigma = 1.0 (`Tracking.cc:820`);
- Hartley normalization (`Normalize`, `Initializer.cc:770-820`);
- H scored by symmetric transfer error, both gates 5.991
  (`CheckHomography`, `:310-393`); F by epipolar distance, gate 3.841 with
  score cap 5.991 (`CheckFundamental`, `:395-473`);
- model choice RH = SH / (SH + SF) > 0.40 -> H (`Initialize`, `:112-124`);
- the 4 (R, t) of E = K^T F K (`DecomposeE`, `:883-905`) and the 8 of the
  Faugeras homography decomposition (`ReconstructH`, `:540-638`) are checked
  as one batch of 12 by triangulation, cheirality, parallax and
  reprojection (`CheckRT`, `:640-768`), with the winner-uniqueness gates of
  `ReconstructF/H`.

The JAX version draws each 8-point set with `jax.random.choice` from a
PRNGKey; that stream cannot be reproduced here. `initialize_two_view` takes
the (n_hyp, 8) hypothesis indices as an argument (so a test can hand both
sides the same ones) or draws them from a `torch.Generator`
(`draw_hypotheses`). SVDs, `inv` and the 3x3 solves give non-finite values
on degenerate input, as in JAX, instead of raising.
"""

from __future__ import annotations

import torch

from ..optim.lm import inv3x3

TH_H = 5.991
TH_F = 3.841
TH_SCORE = 5.991


def normalize_points(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization with the mean absolute deviation (Normalize,
    `Initializer.cc:770-820`). Returns (normalized pts, T (3,3))."""
    w = valid.to(pts.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(pts * w[:, None], 0) / n
    mdev = torch.sum(torch.abs(pts - mean) * w[:, None], 0) / n
    s = 1.0 / torch.clamp(mdev, min=1e-9)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (pts - mean) * s, T


def _svd(A: torch.Tensor, full_matrices: bool = True):
    """Batched SVD; a non-finite matrix gives NaN factors instead of making
    LAPACK / cuSOLVER raise."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    U, S, Vt = torch.linalg.svd(torch.where(bad[..., None, None], torch.zeros_like(A), A),
                                full_matrices=full_matrices)
    nan = float("nan")
    return (torch.where(bad[..., None, None], nan, U), torch.where(bad[..., None], nan, S),
            torch.where(bad[..., None, None], nan, Vt))


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of (B,m,9)."""
    return _svd(A, full_matrices=False)[2][..., -1, :]


def _dlt_h(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor | None = None):
    """Batched homography DLT: (B,n,2) x 2 [+ row weights (B,n)] -> (B,3,3)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    if w is not None:
        r1, r2 = r1 * w[..., None], r2 * w[..., None]
    return _null_vector(torch.cat([r1, r2], dim=-2)).reshape(-1, 3, 3)


def _dlt_f(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor | None = None):
    """Batched 8-point fundamental matrix (+ row weights), rank 2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)  # (B,n,9)
    if w is not None:
        A = A * w[..., None]
    F = _null_vector(A).reshape(-1, 3, 3)
    U, S, Vt = _svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ (S[..., None] * Vt)


def _hom(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _check_h(H21: torch.Tensor, p1, p2, valid, sigma: float = 1.0):
    """Symmetric transfer score (CheckHomography) of (B,3,3) homographies.
    Returns (score (B,), inliers (B,N))."""
    eye = torch.eye(3, dtype=H21.dtype, device=H21.device)
    H12, info = torch.linalg.inv_ex(H21 + 1e-12 * eye)
    H12 = torch.where((info == 0)[..., None, None], H12, float("nan"))
    inv_s2 = 1.0 / (sigma * sigma)

    def transfer(H, a, b):
        bp = torch.einsum("bij,nj->bni", H, _hom(a))
        w = torch.where(torch.abs(bp[..., 2]) < 1e-12, 1e-12, bp[..., 2])
        return torch.sum((bp[..., :2] / w[..., None] - b[None]) ** 2, -1)

    chi1 = transfer(H12, p2, p1) * inv_s2
    chi2 = transfer(H21, p1, p2) * inv_s2
    inl = valid[None] & (chi1 <= TH_H) & (chi2 <= TH_H)
    score = torch.sum(torch.where(inl, (TH_H - chi1) + (TH_H - chi2), 0.0), -1)
    return score, inl


def _check_f(F21: torch.Tensor, p1, p2, valid, sigma: float = 1.0):
    """Epipolar distance score (CheckFundamental) of (B,3,3) fundamental
    matrices. Returns (score (B,), inliers (B,N))."""
    inv_s2 = 1.0 / (sigma * sigma)
    p1h, p2h = _hom(p1), _hom(p2)
    l2 = torch.einsum("bij,nj->bni", F21, p1h)  # line in image 2
    l1 = torch.einsum("bji,nj->bni", F21, p2h)  # line in image 1
    d2 = torch.sum(l2 * p2h[None], -1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * p1h[None], -1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    chi1, chi2 = d1 * inv_s2, d2 * inv_s2
    inl = valid[None] & (chi1 <= TH_F) & (chi2 <= TH_F)
    score = torch.sum(torch.where(inl, (TH_SCORE - chi1) + (TH_SCORE - chi2), 0.0), -1)
    return score, inl


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Linear triangulation (Triangulate, `Initializer.cc:752-768`), batched.

    P1, P2: (..., 3, 4) projection matrices; uv: (..., N, 2) pixels, every
    leading dimension broadcasting. Returns (..., N, 3). As in the JAX
    version, the inhomogeneous (w = 1) 3x3 normal equations replace the
    4x4 homogeneous SVD; near-infinite points come out huge and are
    rejected by the cheirality / reprojection gates that follow."""
    def rows(P, uv):
        P = P[..., None, :, :]  # broadcast over the point axis
        return (uv[..., 0, None] * P[..., 2, :] - P[..., 0, :],
                uv[..., 1, None] * P[..., 2, :] - P[..., 1, :])

    A = torch.stack(torch.broadcast_tensors(*rows(P1, uv1), *rows(P2, uv2)),
                    dim=-2)  # (...,N,4,4)
    B = A[..., :3]
    c = A[..., 3]
    M = torch.sum(B[..., :, :, None] * B[..., :, None, :], dim=-3)  # (...,3,3)
    rhs = -torch.sum(B * c[..., None], dim=-2)  # (...,3)
    return torch.sum(inv3x3(M) * rhs[..., None, :], dim=-1)


def check_rt(R: torch.Tensor, t: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
             valid: torch.Tensor, K: torch.Tensor, sigma2: float = 1.0,
             min_parallax_cos: float = 0.99998):
    """`CheckRT` (`Initializer.cc:640-768`) for C candidate motions at once:
    R (C,3,3), t (C,3); p1, p2 (N,2) matched pixels. Triangulates every
    match and counts the good points (finite, parallax, positive depth in
    both views, both reprojections < 4 sigma2). Returns (n_good (C,), cos of
    the 50th-best parallax (C,), good (C,N), points (C,N,3))."""
    eye34 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                       torch.zeros((3, 1), dtype=R.dtype, device=R.device)], 1)
    P1 = K @ eye34
    P2 = K @ torch.cat([R, t[..., None]], -1)  # (C,3,4)
    X = triangulate_dlt(P1, P2, p1, p2)  # (C,N,3)
    finite = torch.isfinite(X).all(-1)
    o2 = -torch.einsum("cji,cj->ci", R, t)  # camera-2 centre
    n2 = X - o2[:, None]
    cosp = torch.sum(X * n2, -1) / torch.clamp(
        torch.linalg.vector_norm(X, dim=-1) * torch.linalg.vector_norm(n2, dim=-1), min=1e-12)
    X2 = torch.einsum("cij,cnj->cni", R, X) + t[:, None]
    depth_ok = (X[..., 2] > 0) & (X2[..., 2] > 0)

    def reproj_err(P, uv):
        x = torch.einsum("cij,cnj->cni", P.expand(X.shape[0], 3, 4), _hom(X))
        w = torch.where(torch.abs(x[..., 2]) < 1e-12, 1e-12, x[..., 2])
        return torch.sum((x[..., :2] / w[..., None] - uv) ** 2, -1)

    good = (valid & finite & depth_ok & (cosp < min_parallax_cos)
            & (reproj_err(P1, p1) < 4.0 * sigma2) & (reproj_err(P2, p2) < 4.0 * sigma2))
    n_good = torch.sum(good.to(torch.int32), -1)
    # parallax of the 50th-best good point (the reference takes the
    # min(50, n)-th of the sorted parallaxes)
    sorted_cos = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)), dim=-1)[0]
    k = torch.clamp(n_good - 1, min=0, max=49)
    med_cos = torch.gather(sorted_cos, -1, k[:, None].long())[:, 0]
    return n_good, med_cos, good, X


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def decompose_e(E: torch.Tensor):
    """The 4 candidate motions of an essential matrix (`DecomposeE`,
    `Initializer.cc:883-905`): (R (4,3,3), t (4,3)) in the order
    (R1, t), (R1, -t), (R2, t), (R2, -t)."""
    U, _, Vt = _svd(E)
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_h(H: torch.Tensor, K: torch.Tensor):
    """Faugeras (1988) homography decomposition, the 8 motion hypotheses of
    `ReconstructH` (`Initializer.cc:540-638`): (R (8,3,3), t (8,3)), the
    four d' > 0 solutions first."""
    dt, dev = H.dtype, H.device
    Kinv = torch.linalg.inv_ex(K)[0]
    U, S, Vt = _svd(Kinv @ H @ K)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    sgn1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    sgn3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    sgn_st = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dt, device=dev)
    x1s, x3s = sgn1 * aux1, sgn3 * aux3
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    z4, o4 = torch.zeros(4, dtype=dt, device=dev), torch.ones(4, dtype=dt, device=dev)

    def rot(c, sn, diag):
        # rows (c, 0, -/+sn), (0, diag, 0), (+/-sn, 0, +/-c) per hypothesis
        return torch.stack([torch.stack([c, z4, sn[0]], -1),
                            torch.stack([z4, diag * o4, z4], -1),
                            torch.stack([sn[1], z4, sn[2] * c], -1)], -2)

    # case d' > 0
    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    st, ct = sgn_st * root / den_p, (d2 * d2 + d1 * d3) / den_p * o4
    Rp = rot(ct, (-st, st, o4), 1.0)
    tp = torch.stack([x1s, z4, -x3s], -1) * (d1 - d3)
    # case d' < 0
    den_m = torch.clamp((d1 - d3) * d2, min=1e-12)
    sp, cp = sgn_st * root / den_m, (d1 * d3 - d2 * d2) / den_m * o4
    Rm = rot(cp, (sp, sp, -o4), -1.0)
    tm = torch.stack([x1s, z4, x3s], -1) * (d1 + d3)
    R = s * U @ torch.cat([Rp, Rm]) @ Vt
    t = torch.einsum("ij,cj->ci", U, torch.cat([tp, tm]))
    return R, t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)


def draw_hypotheses(valid: torch.Tensor, n_hyp: int = 200,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """(n_hyp, 8) match indices, each row 8 distinct valid matches drawn
    uniformly (the 8 largest of iid uniform keys; invalid matches rank
    last, as `jax.random.choice(..., replace=False, p=valid/n)` gives them
    zero probability)."""
    u = torch.rand((n_hyp, valid.shape[0]), generator=generator, device=valid.device)
    key = torch.where(valid[None, :], u, torch.full_like(u, -1.0))
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][:, :8]


def _best_model(M_hyp, score_fn, refit, pn1, pn2, kp1, kp2, valid, sigma):
    """Score every hypothesis, refit the best on all its inliers (the
    reference recomputes the model from the inlier set, `FindHomography`
    `Initializer.cc:170-176`) and keep whichever scores higher. Returns
    (score, model (3,3), inliers (N,))."""
    scores, inl = score_fn(M_hyp, kp1, kp2, valid, sigma)
    bi = torch.argmax(scores)
    M_r = refit(pn1[None], pn2[None], inl[bi].to(kp1.dtype)[None])
    s_r, inl_r = score_fn(M_r, kp1, kp2, valid, sigma)
    use_r = s_r[0] >= scores[bi]
    return (torch.where(use_r, s_r[0], scores[bi]), torch.where(use_r, M_r[0], M_hyp[bi]),
            torch.where(use_r, inl_r[0], inl[bi]))


def initialize_two_view(kp1: torch.Tensor, kp2: torch.Tensor, valid: torch.Tensor,
                        K: torch.Tensor, n_hyp: int = 200, sigma: float = 1.0,
                        hyp_idx: torch.Tensor | None = None,
                        generator: torch.Generator | None = None) -> dict:
    """The two-view bootstrap. kp1 / kp2 (N,2): matched undistorted pixels
    (row i of kp1 matches row i of kp2); valid (N,); K (3,3). hyp_idx
    (n_hyp, 8) fixes the RANSAC sets, else they are drawn from `generator`.

    Returns dict(success, R21, t21, points3d (N,3), good (N,), used_h,
    n_good, sh, sf, best_cand). The gates of
    `Tracking::MonocularInitialization` and `Initializer::Reconstruct{F,H}`:
    the winner needs max(50, 0.9 x inliers) good points, no second
    candidate within 70% of it, and > ~1 degree of parallax."""
    idx = (draw_hypotheses(valid, n_hyp, generator) if hyp_idx is None
           else hyp_idx.to(kp1.device)).long()
    pn1, T1 = normalize_points(kp1, valid)
    pn2, T2 = normalize_points(kp2, valid)
    T2inv = torch.linalg.inv_ex(T2)[0]
    s1, s2 = pn1[idx], pn2[idx]

    def h_fit(a, b, w=None):
        return T2inv @ _dlt_h(a, b, w) @ T1

    def f_fit(a, b, w=None):
        return T2.T @ _dlt_f(a, b, w) @ T1

    SH, best_H, h_inl = _best_model(h_fit(s1, s2), _check_h, h_fit, pn1, pn2, kp1, kp2,
                                    valid, sigma)
    SF, best_F, f_inl = _best_model(f_fit(s1, s2), _check_f, f_fit, pn1, pn2, kp1, kp2,
                                    valid, sigma)
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40  # Initializer.cc:118

    Re, te = decompose_e(K.T @ best_F @ K)
    Rh, th = decompose_h(best_H, K)
    inl_mask = torch.where(use_h, h_inl, f_inl) & valid
    n_goods, med_coss, goods, Xs = check_rt(torch.cat([Re, Rh]), torch.cat([te, th]),
                                            kp1, kp2, inl_mask, K, sigma * sigma)
    is_h_cand = torch.arange(12, device=kp1.device) >= 4
    n_goods = torch.where(torch.where(use_h, is_h_cand, ~is_h_cand), n_goods,
                          torch.zeros_like(n_goods))
    best = torch.argmax(n_goods)
    max_good = n_goods[best]
    n_similar = torch.sum((n_goods > 0.7 * max_good).to(torch.int32))
    n_inl = torch.sum(inl_mask.to(torch.int32))
    min_good = torch.clamp((0.9 * n_inl).to(torch.int32), min=50)
    # parallax > ~1 degree: cos < cos(1 deg) (the reference: parallax > 1.0)
    success = (max_good >= min_good) & (n_similar == 1) & (med_coss[best] < 0.99985)
    R = torch.cat([Re, Rh])
    t = torch.cat([te, th])
    return dict(success=success, R21=R[best], t21=t[best], points3d=Xs[best],
                good=goods[best], used_h=use_h, n_good=max_good, sh=SH, sf=SF,
                best_cand=best)
