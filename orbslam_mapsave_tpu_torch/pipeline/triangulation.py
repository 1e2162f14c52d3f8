"""New map-point creation by two-view triangulation between keyframes.

Port of `orbslam_mapsave_tpu/pipeline/triangulation.py`
(`LocalMapping::CreateNewMapPoints`, `src/LocalMapping.cc:207-452`): for
each of the current KF's best covisible neighbours — baseline gate,
fundamental-matrix epipolar search, then per match: parallax test, linear
triangulation (or the better-conditioned depth back-projection), cheirality
in both views, reprojection chi2, scale consistency, and a new point with
both observations.

The JAX version vmaps the candidate pass over the neighbours; here every
tensor of that pass carries the neighbour axis, so all neighbours run as
one batched computation.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ..geometry import projection, se3
from ..ops import hamming, matching
from ..ops.initializer import triangulate_dlt
from ..slammap import mapstate as ms


def _kmat(cam: projection.Camera, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(cam.K, dtype=torch.float32, device=like.device)


def compute_f12(cam: projection.Camera, T1w: torch.Tensor, T2w: torch.Tensor):
    """Fundamental matrix between two keyframes, x1^T F12 x2 = 0
    (`LocalMapping::ComputeF12`, `src/LocalMapping.cc:536-553`); T2w may
    carry leading batch dimensions."""
    R1w, t1w = se3.mat_to_rt(T1w)
    R2w, t2w = se3.mat_to_rt(T2w)
    R12 = R1w @ R2w.transpose(-1, -2)
    t12 = -(R12 @ t2w[..., None])[..., 0] + t1w
    Kinv = torch.linalg.inv(_kmat(cam, T1w))
    return Kinv.T @ se3.hat(t12) @ R12 @ Kinv


def _median_scene_depth(state: ms.MapState, kf: torch.Tensor, cam_):
    """`KeyFrame::ComputeSceneMedianDepth` (`src/KeyFrame.cc:1375`) for
    keyframe slots kf (...,)."""
    pts = state.kf_kp_point[kf.long()]  # (...,N)
    ok = pts >= 0
    pos = state.pt_pos[torch.clamp(pts, min=0).long()]
    z = se3.transform_points(state.kf_pose[kf.long()], pos)[..., 2]
    z = torch.where(ok, z, torch.full_like(z, float("inf")))
    zs = torch.sort(z, dim=-1).values
    n = torch.sum(ok.to(torch.int32), -1)
    mid = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    return torch.gather(zs, -1, mid[..., None].long())[..., 0]


def make_triangulator(cam: projection.Camera, scale_factors, level_sigma2,
                      n_levels: int, scale_factor: float, is_mono: bool):
    scale_factors = np.asarray(scale_factors, np.float32)
    level_sigma2 = np.asarray(level_sigma2, np.float32)
    ratio_factor = 1.5 * scale_factor  # LocalMapping.cc:298
    tables = {}

    def _tables(dev):
        if dev not in tables:
            tables[dev] = (torch.from_numpy(scale_factors).to(dev),
                           torch.from_numpy(level_sigma2).to(dev))
        return tables[dev]

    def candidates(state: ms.MapState, kf1: int, kf2: torch.Tensor,
                   enabled: torch.Tensor):
        """Candidate generation between kf1 (current) and the keyframes kf2
        (R,): every gate of `CreateNewMapPoints` (`src/LocalMapping.cc:
        264-449`), no state change. Returns (ok (R,N), X (R,N,3), m2 (R,N),
        pair_ok (R,))."""
        sf_t, ls2 = _tables(state.device)
        K = _kmat(cam, state.kf_pose)
        n_lv = n_levels - 1
        kf2l = kf2.long()
        T1 = state.kf_pose[kf1]
        T2 = state.kf_pose[kf2l]  # (R,4,4)
        O1 = se3.se3_inv(T1)[:3, 3]
        O2 = se3.se3_inv(T2)[:, :3, 3]
        baseline = torch.linalg.vector_norm(O2 - O1, dim=-1)
        # the baseline gate first, so a rejected pair creates nothing
        if is_mono:
            med_depth = _median_scene_depth(state, kf2, cam)
            pair_ok = baseline / torch.clamp(med_depth, min=1e-9) > 0.01
        else:
            pair_ok = baseline > cam.bf / cam.fx  # > the camera baseline

        # candidate features: valid and without a point (:274)
        un1 = state.kf_kp_valid[kf1] & (state.kf_kp_point[kf1] < 0)
        un2 = state.kf_kp_valid[kf2l] & (state.kf_kp_point[kf2l] < 0)
        F12 = compute_f12(cam, T1, T2)
        # epipole of camera 1 in image 2 (ORBmatcher.cc:668-675)
        C1in2 = se3.transform_points(T2, O1[None])[:, 0]
        ep_uv, _ = projection.project(cam, C1in2)
        oct1 = state.kf_kp_octave[kf1]
        oct2_all = state.kf_kp_octave[kf2l]
        matches, _ = matching.search_for_triangulation(
            state.kf_kp_xy[kf1], oct1, hamming.unpack_bits(state.kf_desc[kf1]), un1,
            state.kf_kp_xy[kf2l], oct2_all, hamming.unpack_bits(state.kf_desc[kf2l]),
            un2, F12, ep_uv, ls2, check_epipole_dist=bool(is_mono),
            angle_1=state.kf_kp_angle[kf1], angle_2=state.kf_kp_angle[kf2l])
        ok = matches >= 0
        m2 = torch.clamp(matches, min=0)
        m2l = m2.long()

        def take(t):  # (R,N,...) per-neighbour table -> row of the match
            idx = m2l.reshape(m2l.shape + (1,) * (t.dim() - 2)).expand(m2l.shape + t.shape[2:])
            return torch.gather(t, 1, idx)

        xy1 = state.kf_kp_xy[kf1]
        xy2 = take(state.kf_kp_xy[kf2l])  # (R,N,2)

        def ray_dirs(xy):
            return torch.stack([(xy[..., 0] - cam.cx) / cam.fx,
                                (xy[..., 1] - cam.cy) / cam.fy,
                                torch.ones_like(xy[..., 0])], -1)

        R1w = T1[:3, :3]
        R2w = T2[:, :3, :3]
        ray1 = ray_dirs(xy1) @ R1w  # = Rwc1 @ xn1
        ray2 = ray_dirs(xy2) @ R2w
        cos_rays = torch.sum(ray1 * ray2, -1) / torch.clamp(
            torch.linalg.vector_norm(ray1, dim=-1)
            * torch.linalg.vector_norm(ray2, dim=-1), min=1e-12)
        d1 = state.kf_kp_depth[kf1]
        d2 = take(state.kf_kp_depth[kf2l])

        def cos_stereo(d):  # stereo parallax floor (:305-315)
            half = torch.atan2(torch.full_like(d, cam.bf / cam.fx / 2.0),
                               torch.clamp(d, min=1e-6))
            return torch.where(d > 0, torch.cos(2.0 * half), torch.full_like(d, 2.0))

        cos_stereo1 = cos_stereo(d1)
        cos_stereo2 = cos_stereo(d2)
        cos_st = torch.minimum(cos_stereo1, cos_stereo2)

        # linear triangulation when the parallax is good (:322-337)
        P1 = K @ T1[:3, :4]
        P2 = K @ T2[:, :3, :4]
        X_tri = triangulate_dlt(P1, P2, xy1, xy2)
        X_d1 = se3.transform_points(se3.se3_inv(T1), projection.backproject(cam, xy1, d1))
        X_d2 = se3.transform_points(se3.se3_inv(T2), projection.backproject(cam, xy2, d2))
        good_parallax = (cos_rays < cos_st) & (cos_rays > 0) & (cos_rays < 0.9998)
        use_d1 = ~good_parallax & (d1 > 0) & (cos_stereo1 < cos_stereo2)
        use_d2 = ~good_parallax & ~use_d1 & (d2 > 0)
        X = torch.where(good_parallax[..., None], X_tri,
                        torch.where(use_d1[..., None], X_d1, X_d2))
        ok = ok & (good_parallax | use_d1 | use_d2)

        # cheirality (:339-352)
        pc1 = se3.transform_points(T1, X)
        pc2 = se3.transform_points(T2, X)
        ok = ok & (pc1[..., 2] > 0) & (pc2[..., 2] > 0)

        # reprojection chi2, gate 5.991 (:354-407)
        uv1_hat, _ = projection.project(cam, pc1)
        uv2_hat, _ = projection.project(cam, pc2)
        oc1 = torch.clamp(oct1, 0, n_lv).long()
        oc2 = torch.clamp(take(oct2_all), 0, n_lv).long()
        e1 = torch.sum((uv1_hat - xy1) ** 2, -1)
        e2 = torch.sum((uv2_hat - xy2) ** 2, -1)
        ok = ok & (e1 <= 5.991 * ls2[oc1]) & (e2 <= 5.991 * ls2[oc2])

        # scale consistency (:409-435)
        dist1 = torch.linalg.vector_norm(X - O1, dim=-1)
        dist2 = torch.linalg.vector_norm(X - O2[:, None, :], dim=-1)
        ratio_dist = dist2 / torch.clamp(dist1, min=1e-9)
        ratio_oct = sf_t[oc1] / sf_t[oc2]
        ok = ok & (ratio_dist < ratio_oct * ratio_factor) & (
            ratio_dist * ratio_factor > ratio_oct) & (dist1 > 0) & (dist2 > 0)
        ok = ok & (pair_ok & enabled)[:, None]
        return ok, X, m2, pair_ok

    def commit(state: ms.MapState, kf1: int, kf2_rows, ok, X, m2):
        """New points at the candidates: allocation plus both observations.
        kf2_rows: (N,) the neighbour KF of each feature."""
        state, slots = ms.add_points(state, X, state.kf_desc[kf1], kf1, kf1, ok)
        feat1 = torch.arange(X.shape[0], dtype=torch.int32, device=X.device)
        state = ms.add_observations(state, kf1, slots, feat1, ok)
        state = ms.add_observations_rows(state, kf2_rows, slots, m2, ok)
        return state, slots

    def triangulate_batched(state: ms.MapState, kf1: int, neigh: torch.Tensor):
        """All neighbours at once: the candidate pass over the whole
        neighbour axis, each feature keeps its FIRST matching neighbour
        (the sequential reference marks a feature tracked after its first
        match), then one allocation + observation pass. Returns (state,
        slots (N,) i32 or -1)."""
        nb_safe = torch.clamp(neigh, min=0)
        ok_b, X_b, m2_b, _ = candidates(state, kf1, nb_safe, neigh >= 0)
        first = torch.argmax(ok_b.to(torch.int8), dim=0)  # (N,)
        any_ok = ok_b.any(dim=0)
        rows = torch.arange(X_b.shape[1], device=X_b.device)
        X = X_b[first, rows]
        m2 = m2_b[first, rows]
        kf2_rows = torch.where(any_ok, nb_safe[first], torch.full_like(m2, -1))
        return commit(state, kf1, kf2_rows, any_ok, X, m2)

    def finalize_idx(state: ms.MapState, idx: torch.Tensor, ok: torch.Tensor):
        """Distinctive descriptors + normal / scale band of the points idx."""
        state = ms.compute_distinctive_descriptors_idx(state, idx, ok)
        return ms.update_normal_and_depth_idx(state, idx, ok, scale_factors, n_levels)

    return types.SimpleNamespace(candidates=candidates, commit=commit,
                                 batched=triangulate_batched, finalize_idx=finalize_idx)
