"""Projection- and descriptor-guided matching over whole frames.

Port of `orbslam_mapsave_tpu/ops/matching.py` (the subset that tracking,
the monocular bootstrap, local mapping and loop closing use): each search
builds a dense (candidates x features) mask — window radius, octave range,
rotation bins — over the full Hamming matrix, and
conflicts (several candidates claiming one feature) go to the smallest
distance, then the lowest candidate row.
"""

from __future__ import annotations

import torch

from ..geometry import projection, se3
from . import hamming


def predict_scale(dist: torch.Tensor, max_dist: torch.Tensor,
                  scale_factor: float, n_levels: int) -> torch.Tensor:
    """`MapPoint::PredictScale` parity: level = ceil(log(maxDist/dist)/log(s)),
    clipped to [0, L-1]."""
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    log_s = torch.log(torch.tensor(scale_factor, dtype=ratio.dtype,
                                   device=ratio.device))
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_s)
    return torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)


def frustum_check(cam: projection.Camera, pose_cw: torch.Tensor,
                  pt_pos: torch.Tensor, pt_normal: torch.Tensor,
                  pt_min_dist: torch.Tensor, pt_max_dist: torch.Tensor,
                  bounds: torch.Tensor, view_cos_limit: float = 0.5):
    """`Frame::isInFrustum` (`src/Frame.cc:387-443`) for a batch of points,
    with the 0.8/1.2 scale-invariance slack.

    Returns (ok, uv (P,2), ur (P,), dist (P,), view_cos (P,)); a leading
    batch of poses (C,4,4) with points (C,P,3) gives (C,P) results."""
    p_cam = se3.transform_points(pose_cw, pt_pos)
    z = p_cam[..., 2]
    uvr, _ = projection.project_stereo(cam, p_cam)
    uv, ur = uvr[..., :2], uvr[..., 2]
    center = se3.se3_inv(pose_cw)[..., None, :3, 3]
    po = pt_pos - center
    dist = torch.linalg.vector_norm(po, dim=-1)
    view_cos = torch.sum(po * pt_normal, -1) / torch.clamp(dist, min=1e-9)
    ok = (
        (z > 0)
        & (uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3])
        & (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
        & (view_cos > view_cos_limit)
    )
    return ok, uv, ur, dist, view_cos


def _resolve_conflicts(best_feat: torch.Tensor, best_dist: torch.Tensor,
                       ok: torch.Tensor, n_features: int) -> torch.Tensor:
    """Per-feature winner among candidate rows: (...,N) candidate index or
    -1, from (...,P) inputs. Ties by distance, then by candidate order."""
    P = best_feat.shape[-1]
    dev = best_feat.device
    sentinel = torch.iinfo(torch.int32).max
    score = torch.where(
        ok, best_dist.to(torch.int32) * P + torch.arange(P, dtype=torch.int32,
                                                          device=dev),
        torch.full_like(best_feat, sentinel, dtype=torch.int32))
    feat_ids = torch.arange(n_features, dtype=torch.int32, device=dev)
    oh = (best_feat[..., :, None] == feat_ids) & ok[..., :, None]  # (...,P,N)
    score_col = torch.where(oh, score[..., :, None],
                            torch.full_like(oh, sentinel, dtype=torch.int32))
    feat_best = torch.amin(score_col, dim=-2)
    return torch.where(feat_best < sentinel, feat_best % P,
                       torch.full_like(feat_best, -1))


def _pair_d2(uv: torch.Tensor, kp_xy: torch.Tensor) -> torch.Tensor:
    """(...,P,N) squared pixel distances via the expanded form (one product)."""
    return (torch.sum(uv * uv, -1)[..., :, None]
            + torch.sum(kp_xy * kp_xy, -1)[..., None, :]
            - 2.0 * (uv @ kp_xy.transpose(-1, -2)))


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def search_by_projection_points(
    cam: projection.Camera,
    pose_cw: torch.Tensor,
    kp_xy: torch.Tensor, kp_octave: torch.Tensor, kp_desc_bits: torch.Tensor,
    kp_valid: torch.Tensor, kp_matched: torch.Tensor,
    pt_pos: torch.Tensor, pt_normal: torch.Tensor, pt_min_dist: torch.Tensor,
    pt_max_dist: torch.Tensor, pt_desc_bits: torch.Tensor, pt_valid: torch.Tensor,
    bounds, scale_factors, th: float = 1.0, nn_ratio: float = 0.8,
    n_levels: int = 4, scale_factor: float = 1.5,
    dist_th: int = hamming.TH_HIGH, use_ratio: bool = True,
):
    """Local-map search (`ORBmatcher::SearchByProjection`,
    `src/ORBmatcher.cc:45-129`). Returns (matches (N,) i32 candidate row or
    -1, n_matches, visible_mask (P,)). Features in kp_matched are skipped.
    A leading batch on the pose (C,4,4), kp_matched (C,N) and the point
    tensors (C,P,...) runs C searches of one frame at once."""
    bounds = _as_tensor(bounds, pt_pos)
    scale_factors = _as_tensor(scale_factors, pt_pos)
    N = kp_xy.shape[0]
    ok, uv, _, dist, view_cos = frustum_check(
        cam, pose_cw, pt_pos, pt_normal, pt_min_dist, pt_max_dist, bounds)
    ok = ok & pt_valid
    lvl = predict_scale(dist, pt_max_dist, scale_factor, n_levels)
    r = torch.where(view_cos > 0.998, 2.5, 4.0).to(torch.float32)
    radius = th * r * scale_factors[lvl.long()]  # ORBmatcher.cc:84-90
    d2 = _pair_d2(uv, kp_xy)
    in_win = d2 <= (radius[..., None] ** 2)
    oct_ok = (kp_octave[..., None, :] >= (lvl - 1)[..., None]) & (
        kp_octave[..., None, :] <= lvl[..., None])
    mask = (in_win & oct_ok & kp_valid[..., None, :] & ok[..., None]
            & (~kp_matched)[..., None, :])
    dmat = hamming.hamming_matrix_bits(pt_desc_bits, kp_desc_bits)
    idx, best, second = hamming.masked_best2(dmat, extra_mask=mask)
    # the best/second level ratio rule is approximated by always applying
    # the ratio (stricter; the JAX version documents the same deviation)
    good = ok & (best <= dist_th)
    if use_ratio:
        good = good & (best.to(torch.float32)
                       <= nn_ratio * second.to(torch.float32))
    matches = _resolve_conflicts(idx, best, good, N)
    return matches, torch.sum((matches >= 0).to(torch.int32), -1), ok


def search_by_projection_last(
    cam: projection.Camera,
    pose_cw: torch.Tensor,
    kp_xy: torch.Tensor, kp_octave: torch.Tensor, kp_angle: torch.Tensor,
    kp_desc_bits: torch.Tensor, kp_valid: torch.Tensor,
    last_pt_pos: torch.Tensor, last_octave: torch.Tensor, last_angle: torch.Tensor,
    last_desc_bits: torch.Tensor, last_valid: torch.Tensor,
    bounds, scale_factors, th: float = 15.0, check_rotation: bool = True,
):
    """Frame-to-frame search (`src/ORBmatcher.cc:1331-1473`): window radius
    th * scale_factor[last octave], candidate octaves in [oct-1, oct+1].
    Returns (matches (N,), n)."""
    bounds = _as_tensor(bounds, last_pt_pos)
    scale_factors = _as_tensor(scale_factors, last_pt_pos)
    N = kp_xy.shape[0]
    p_cam = se3.transform_points(pose_cw, last_pt_pos)
    uv, z = projection.project(cam, p_cam)
    ok = (
        last_valid & (z > 0)
        & (uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3])
    )
    radius = th * scale_factors[torch.clamp(last_octave, min=0).long()]
    d2 = _pair_d2(uv, kp_xy)
    in_win = d2 <= (radius[:, None] ** 2)
    oct_ok = (kp_octave[None, :] >= (last_octave - 1)[:, None]) & (
        kp_octave[None, :] <= (last_octave + 1)[:, None])
    mask = in_win & oct_ok & kp_valid[None, :] & ok[:, None]
    dmat = hamming.hamming_matrix_bits(last_desc_bits, kp_desc_bits)
    idx, best, _ = hamming.masked_best2(dmat, extra_mask=mask)
    good = ok & (best <= hamming.TH_HIGH)
    if check_rotation:
        rot_ok = hamming.rotation_consistency_mask(
            last_angle, kp_angle[torch.clamp(idx, min=0).long()], good)
        good = good & rot_ok
    matches = _resolve_conflicts(idx, best, good, N)
    return matches, torch.sum((matches >= 0).to(torch.int32))


def search_by_descriptor(desc_bits_1: torch.Tensor, valid_1: torch.Tensor,
                         desc_bits_2: torch.Tensor, valid_2: torch.Tensor,
                         angle_1: torch.Tensor | None = None,
                         angle_2: torch.Tensor | None = None,
                         th: int = hamming.TH_LOW, nn_ratio: float = 0.7,
                         check_rotation: bool = True):
    """Best/second matching with ratio and rotation gates, one-to-one on
    the second set (the BoW-free core of `ORBmatcher::SearchByBoW`,
    `src/ORBmatcher.cc:159-291`). Returns (matches (N1,), n). A leading
    batch on the second set's tensors (C,N2,...) matches one first set
    against C second sets at once: (C,N1), (C,)."""
    dmat = hamming.hamming_matrix_bits(desc_bits_1, desc_bits_2)
    mask = valid_1[..., :, None] & valid_2[..., None, :]
    idx, best, second = hamming.masked_best2(dmat, extra_mask=mask)
    good = valid_1 & (best <= th) & (
        best.to(torch.float32) < nn_ratio * second.to(torch.float32))
    safe = torch.clamp(idx, min=0).long()
    if check_rotation and angle_1 is not None:
        good = good & hamming.rotation_consistency_mask(
            angle_1, torch.gather(angle_2, -1, safe), good)
    n2 = desc_bits_2.shape[-2]
    winner_row = _resolve_conflicts(idx, best, good, n2)
    owner = torch.gather(winner_row, -1, safe)
    good = good & (owner == torch.arange(desc_bits_1.shape[-2], device=owner.device))
    minus1 = torch.full_like(idx, -1)
    return torch.where(good, idx, minus1), torch.sum(good.to(torch.int32), -1)


def search_for_initialization(
        kp_xy_1: torch.Tensor, kp_angle_1: torch.Tensor, desc_bits_1: torch.Tensor,
        valid_1: torch.Tensor,
        kp_xy_2: torch.Tensor, kp_angle_2: torch.Tensor, desc_bits_2: torch.Tensor,
        valid_2: torch.Tensor,
        window: float = 100.0, nn_ratio: float = 0.9, check_rotation: bool = True):
    """`ORBmatcher::SearchForInitialization` (`src/ORBmatcher.cc:408-523`):
    frame-1 features to frame-2 features within a window, ratio test,
    rotation consistency, one-to-one on frame 2. The caller masks the
    features to octave 0 through valid_*. Returns (matches12 (N1,), n)."""
    d2 = torch.sum((kp_xy_1[:, None, :] - kp_xy_2[None, :, :]) ** 2, -1)
    mask = (d2 <= window * window) & valid_1[:, None] & valid_2[None, :]
    dmat = hamming.hamming_matrix_bits(desc_bits_1, desc_bits_2)
    idx, best, second = hamming.masked_best2(dmat, extra_mask=mask)
    good = valid_1 & (best <= hamming.TH_LOW) & (
        best.to(torch.float32) < nn_ratio * second.to(torch.float32))
    safe = torch.clamp(idx, min=0).long()
    if check_rotation:
        good = good & hamming.rotation_consistency_mask(kp_angle_1, kp_angle_2[safe], good)
    winner_row = _resolve_conflicts(idx, best, good, kp_xy_2.shape[0])
    good = good & (winner_row[safe] == torch.arange(kp_xy_1.shape[0], device=idx.device))
    return torch.where(good, idx, torch.full_like(idx, -1)), torch.sum(good.to(torch.int32))



def search_for_triangulation(
    kp1_xy: torch.Tensor, kp1_octave: torch.Tensor, desc_bits_1: torch.Tensor,
    valid_1: torch.Tensor,
    kp2_xy: torch.Tensor, kp2_octave: torch.Tensor, desc_bits_2: torch.Tensor,
    valid_2: torch.Tensor,
    F12: torch.Tensor, epipole2: torch.Tensor, level_sigma2: torch.Tensor,
    check_epipole_dist: bool = True,
    angle_1: torch.Tensor | None = None, angle_2: torch.Tensor | None = None,
):
    """Epipolar-constrained matching for new-point triangulation
    (`ORBmatcher::SearchForTriangulation`, `src/ORBmatcher.cc:660-826`):
    Hamming < TH_LOW, epipolar-line distance chi2 < 3.84 * sigma2(octave2)
    (`CheckDistEpipolarLine`), optionally no kp2 within 100 * sigma2 px^2 of
    the epipole, rotation consistency, one-to-one on image 2.

    Image-2 inputs may carry leading batch dimensions (kp2_xy (...,N2,2),
    F12 (...,3,3), epipole2 (...,2)): each batch row is one keyframe pair
    against the same image 1, as the JAX version's vmap over neighbours.
    Returns (matches (...,N1) i32 index into image 2 or -1, n (...,))."""
    n_lv = level_sigma2.shape[0]
    dmat = hamming.hamming_matrix_bits(desc_bits_1, desc_bits_2)  # (...,N1,N2)
    mask = valid_1[:, None] & valid_2[..., None, :]
    sig2 = level_sigma2[torch.clamp(kp2_octave, 0, n_lv - 1).long()]  # (...,N2)
    if check_epipole_dist:
        de2 = torch.sum((kp2_xy - epipole2[..., None, :]) ** 2, -1)
        mask = mask & (de2 >= 100.0 * sig2)[..., None, :]
    # epipolar line of kp1 in image 2: l = F12^T x1
    x1h = torch.cat([kp1_xy, torch.ones_like(kp1_xy[..., :1])], -1)
    lines = x1h @ F12  # (...,N1,3): a, b, c
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    num = a * kp2_xy[..., None, :, 0] + b * kp2_xy[..., None, :, 1] + c
    den = a * a + b * b
    dsqr = num * num / torch.clamp(den, min=1e-12)
    mask = mask & (dsqr < 3.84 * sig2[..., None, :])
    idx, best, _ = hamming.masked_best2(dmat, extra_mask=mask)
    good = valid_1 & (best < hamming.TH_LOW)
    if angle_1 is not None and angle_2 is not None:
        good = good & hamming.rotation_consistency_mask(
            angle_1, torch.gather(angle_2, -1, torch.clamp(idx, min=0).long()), good)
    n2 = kp2_xy.shape[-2]
    winner = _resolve_conflicts(idx, best, good, n2)
    owner = torch.gather(winner, -1, torch.clamp(idx, min=0).long())
    good = good & (owner == torch.arange(kp1_xy.shape[0], device=owner.device))
    return torch.where(good, idx, torch.full_like(idx, -1)), \
        torch.sum(good.to(torch.int32), -1)


def _sim3_direction(cam, pt_world, pt_ok, pt_min, pt_max, pt_bits, S_target_w,
                    kp_xy, kp_octave, kp_bits, kp_valid,
                    bounds, scale_factors, th, n_levels, scale_factor):
    """One direction of SearchBySim3: project source points through the Sim3
    chain into the target camera; best descriptor within th*scale(predicted
    level), octave in [lvl-1, lvl], TH_HIGH gate (`src/ORBmatcher.cc:
    1151-1227`). Returns (match (P,), dist (P,))."""
    bounds = _as_tensor(bounds, pt_world)
    scale_factors = _as_tensor(scale_factors, pt_world)
    p_c = se3.sim3_transform_points(S_target_w, pt_world)
    z = p_c[..., 2]
    uv, _ = projection.project(cam, p_c)
    dist3d = torch.linalg.vector_norm(p_c, dim=-1)
    ok = (
        pt_ok & (z > 0)
        & (uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3])
        & (dist3d >= pt_min) & (dist3d <= pt_max)
    )
    lvl = predict_scale(dist3d, pt_max, scale_factor, n_levels)
    radius = th * scale_factors[lvl.long()]
    in_win = _pair_d2(uv, kp_xy) <= (radius[:, None] ** 2)
    oct_ok = (kp_octave[None, :] >= (lvl - 1)[:, None]) & (kp_octave[None, :] <= lvl[:, None])
    mask = in_win & oct_ok & kp_valid[None, :] & ok[:, None]
    idx, best, _ = hamming.masked_best2(hamming.hamming_matrix_bits(pt_bits, kp_bits),
                                        extra_mask=mask)
    good = ok & (best <= hamming.TH_HIGH)
    return torch.where(good, idx, torch.full_like(idx, -1)), best


def search_by_sim3(
    cam: projection.Camera, T1w: torch.Tensor, T2w: torch.Tensor, S12: torch.Tensor,
    kp1_xy, kp1_octave, kp1_bits, kp1_valid, p1_world, p1_ok, p1_min, p1_max, p1_bits,
    kp2_xy, kp2_octave, kp2_bits, kp2_valid, p2_world, p2_ok, p2_min, p2_max, p2_bits,
    already1: torch.Tensor, already2: torch.Tensor, bounds, scale_factors,
    th: float = 7.5, n_levels: int = 4, scale_factor: float = 1.5,
):
    """`ORBmatcher::SearchBySim3` (`src/ORBmatcher.cc:1105-1329`): project
    KF1's points into KF2 through S21 T1w and KF2's into KF1 through S12 T2w
    and keep the pairs both directions agree on. S12 maps camera-2 to
    camera-1 coordinates; features marked already1/already2 are skipped as
    sources. Returns (matches12 (N1,) feature index in KF2 or -1, n)."""
    N1 = kp1_xy.shape[0]
    S21 = se3.sim3_inv(S12)
    m1, _ = _sim3_direction(cam, p1_world, p1_ok & ~already1, p1_min, p1_max, p1_bits,
                            S21 @ T1w, kp2_xy, kp2_octave, kp2_bits, kp2_valid,
                            bounds, scale_factors, th, n_levels, scale_factor)
    m2, _ = _sim3_direction(cam, p2_world, p2_ok & ~already2, p2_min, p2_max, p2_bits,
                            S12 @ T2w, kp1_xy, kp1_octave, kp1_bits, kp1_valid,
                            bounds, scale_factors, th, n_levels, scale_factor)
    back = torch.where(m1 >= 0, m2[torch.clamp(m1, min=0).long()], torch.full_like(m1, -2))
    agree = back == torch.arange(N1, dtype=back.dtype, device=back.device)
    return torch.where(agree, m1, torch.full_like(m1, -1)), torch.sum(agree.to(torch.int32))


def search_by_projection_scw(
    cam: projection.Camera, Scw: torch.Tensor,
    pt_world, pt_ok, pt_min, pt_max, pt_normal, pt_bits,
    kp_xy, kp_octave, kp_bits, kp_valid, kp_matched,
    bounds, scale_factors, th: float = 10.0, n_levels: int = 4,
    scale_factor: float = 1.5,
):
    """`ORBmatcher::SearchByProjection(KF, Scw, ...)` (`src/ORBmatcher.cc:
    293-406`): project candidate points through a Sim3 camera pose; gates
    depth > 0, in image, the distance band measured from the Sim3 camera
    centre, viewing angle < 60 deg, octave in [lvl-1, lvl], radius
    th*scale(lvl), TH_LOW; kp_matched features are excluded. Returns
    (matches (N,) candidate row or -1, n)."""
    bounds = _as_tensor(bounds, pt_world)
    scale_factors = _as_tensor(scale_factors, pt_world)
    N = kp_xy.shape[0]
    s, Rcw, t = se3.sim3_split(Scw)
    tcw = t / s
    p_c = pt_world @ Rcw.T + tcw
    z = p_c[..., 2]
    uv, _ = projection.project(cam, p_c)
    po = pt_world - (-Rcw.T @ tcw)
    dist = torch.linalg.vector_norm(po, dim=-1)
    view = torch.sum(po * pt_normal, -1)
    ok = (
        pt_ok & (z > 0)
        & (uv[..., 0] >= bounds[0]) & (uv[..., 0] < bounds[1])
        & (uv[..., 1] >= bounds[2]) & (uv[..., 1] < bounds[3])
        & (dist >= pt_min) & (dist <= pt_max)
        & (view >= 0.5 * dist)
    )
    lvl = predict_scale(dist, pt_max, scale_factor, n_levels)
    radius = th * scale_factors[lvl.long()]
    in_win = _pair_d2(uv, kp_xy) <= (radius[:, None] ** 2)
    oct_ok = (kp_octave[None, :] >= (lvl - 1)[:, None]) & (kp_octave[None, :] <= lvl[:, None])
    mask = in_win & oct_ok & kp_valid[None, :] & ok[:, None] & (~kp_matched)[None, :]
    idx, best, _ = hamming.masked_best2(hamming.hamming_matrix_bits(pt_bits, kp_bits),
                                        extra_mask=mask)
    good = ok & (best <= hamming.TH_LOW)
    matches = _resolve_conflicts(idx, best, good, N)
    return matches, torch.sum((matches >= 0).to(torch.int32))
