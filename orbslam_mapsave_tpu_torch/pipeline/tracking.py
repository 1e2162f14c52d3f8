"""Per-frame tracking steps (RGB-D, stereo and monocular) and the host-side
`Tracker` that runs them.

Port of `orbslam_mapsave_tpu/pipeline/tracking.py`: `Tracking` parity
(`src/Tracking.cc:541-984`) — RGB-D / stereo initialization and the monocular
two-view bootstrap, motion-model and reference-KF tracking, motion-only
pose optimization, local-map tracking and keyframe creation, as functions
over fixed-capacity tensors. The host branches on scalar outcomes per frame (see
`fused_step.py`); the JAX version batches those reads because its chip sits
behind a network link, the card here does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import projection, se3
from ..ops import hamming, initializer, matching
from ..optim import global_ba, pose_opt
from ..slammap import mapstate as ms
from ..utils import metrics
from . import frame as frame_mod

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3

LOCAL_KFS = 80  # Tracking.cc:1545
LOCAL_PTS = 4096  # static cap for the gathered local point set

_I32 = torch.int32


def _clip0(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0).long()


def _minus1(like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, -1, dtype=_I32)


def make_tracking_kernels(cam: projection.Camera, builder: frame_mod.FrameBuilder,
                          n_levels: int, scale_factor: float) -> dict:
    """The per-frame step functions for a fixed geometry/config."""
    # device copies of the small tables (no host->device copy per call)
    scale_factors = builder.scale_factors_t
    bounds_t = builder.bounds_t
    inv_sigma2 = builder.inv_level_sigma2_t
    bounds = builder.bounds
    # frustum prefilter margins (25% of the image bounds), float32 on host
    mx = np.float32(0.25) * (bounds[1] - bounds[0])
    my = np.float32(0.25) * (bounds[3] - bounds[2])
    view_box = [float(bounds[0] - mx), float(bounds[1] + mx),
                float(bounds[2] - my), float(bounds[3] + my)]

    def init_rgbd(state: ms.MapState, frame: frame_mod.FrameData, frame_id: int):
        """`Tracking::StereoInitialization` (`src/Tracking.cc:750-802`):
        first KF at the origin; every feature with depth becomes a point."""
        pose = torch.eye(4, dtype=torch.float32, device=state.device)
        state, kf = ms.add_keyframe(
            state, pose, frame.timestamp, frame_id,
            frame.kp_xy, frame.kp_ur, frame.kp_depth, frame.kp_octave,
            frame.kp_angle, frame.valid, frame.desc)
        has_depth = frame.valid & (frame.kp_depth > 0)
        pts = projection.backproject(cam, frame.kp_xy, frame.kp_depth)
        state, slots = ms.add_points(state, pts, frame.desc, kf, kf, has_depth)
        feat = torch.arange(frame.kp_xy.shape[0], dtype=_I32, device=state.device)
        state = ms.add_observations(state, kf, slots, feat, has_depth)
        state = ms.compute_distinctive_descriptors_idx(
            state, torch.clamp(slots, min=0), slots >= 0)
        state = ms.update_normal_and_depth_idx(
            state, torch.clamp(slots, min=0), slots >= 0, scale_factors, n_levels)
        state = ms.update_connections(state, kf)
        matched = torch.where(has_depth, slots, _minus1(slots))
        return state, kf, matched, torch.sum(has_depth.to(_I32))

    def track_motion(state: ms.MapState, frame: frame_mod.FrameData,
                     pose_pred: torch.Tensor, last_matched: torch.Tensor,
                     last_frame: frame_mod.FrameData, th: float,
                     last_pose: torch.Tensor, use_temporal: bool = False):
        """`Tracking::TrackWithMotionModel` (`src/Tracking.cc:1114-1175`) +
        the temporal "VO point" seeding of `UpdateLastFrame`
        (`src/Tracking.cc:1048-1112`): project the last frame's map points
        through the predicted pose; in localization-only mode
        (use_temporal) its features with depth but no map point join as
        temporary 3D points back-projected through the last pose. Returns
        (matched_pt (N,) map slot or -1, pt_w (N,3) matched 3D position —
        map or temporal, have (N,), n_matches)."""
        ok_map = (last_matched >= 0) & state.pt_valid[_clip0(last_matched)]
        p_w_temp = se3.transform_points(
            se3.se3_inv(last_pose),
            projection.backproject(cam, last_frame.kp_xy, last_frame.kp_depth))
        pt_pos = torch.where(ok_map[:, None], state.pt_pos[_clip0(last_matched)],
                             p_w_temp)
        ok_last = ok_map
        if use_temporal:
            ok_last = ok_map | (last_frame.valid & (last_frame.kp_depth > 0))
        matches, n = matching.search_by_projection_last(
            cam, pose_pred,
            frame.kp_xy, frame.kp_octave, frame.kp_angle, frame.desc_bits,
            frame.valid,
            pt_pos, last_frame.kp_octave, last_frame.kp_angle,
            last_frame.desc_bits, ok_last,
            bounds_t, scale_factors, th=th)
        # temporal rows map to slot -1 (they never enter the map) but keep
        # their 3D position
        have = matches >= 0
        row = _clip0(matches)
        matched_pt = torch.where(have & ok_map[row], last_matched[row],
                                 _minus1(matches))
        return matched_pt, pt_pos[row], have, n

    def track_ref_kf(state: ms.MapState, frame: frame_mod.FrameData, ref_kf):
        """`Tracking::TrackReferenceKeyFrame` (`src/Tracking.cc:1004-1046`)
        with exhaustive descriptor matching (ratio 0.7 + rotation) in place
        of the BoW-node gating, as in the JAX version."""
        kf_bits = hamming.unpack_bits(state.kf_desc[ref_kf])
        kf_pts = state.kf_kp_point[ref_kf]
        kf_ok = state.kf_kp_valid[ref_kf] & (kf_pts >= 0) & state.pt_valid[_clip0(kf_pts)]
        matches, n = matching.search_by_descriptor(
            frame.desc_bits, frame.valid, kf_bits, kf_ok,
            frame.kp_angle, state.kf_kp_angle[ref_kf],
            th=hamming.TH_LOW, nn_ratio=0.7)
        matched_pt = torch.where(matches >= 0, kf_pts[_clip0(matches)],
                                 _minus1(matches))
        return matched_pt, n

    def _obs(frame, pt_w, valid):
        return pose_opt.PoseObs(
            pt_w=pt_w, uv=frame.kp_xy, ur=frame.kp_ur,
            inv_sigma2=inv_sigma2[_clip0(frame.kp_octave)], valid=valid)

    def optimize_pose(state: ms.MapState, frame: frame_mod.FrameData,
                      pose0: torch.Tensor, matched_pt: torch.Tensor):
        """PoseOptimization + outlier stripping (`src/Tracking.cc:1154-1174`)."""
        ok = (matched_pt >= 0) & state.pt_valid[_clip0(matched_pt)]
        obs = _obs(frame, state.pt_pos[_clip0(matched_pt)], ok)
        pose, inlier, n_inl = pose_opt.pose_optimization(cam, pose0, obs)
        return pose, torch.where(inlier, matched_pt, _minus1(matched_pt)), n_inl

    def optimize_pose_xyz(state: ms.MapState, frame: frame_mod.FrameData,
                          pose0: torch.Tensor, pt_w: torch.Tensor,
                          have: torch.Tensor, matched_pt: torch.Tensor):
        """PoseOptimization over explicit 3D positions (the motion-model
        variant). Returns (pose, matched_pt stripped of outliers,
        n_inliers, n_map_inliers)."""
        pose, inlier, n_inl = pose_opt.pose_optimization(
            cam, pose0, _obs(frame, pt_w, have))
        matched_pt = torch.where(inlier, matched_pt, _minus1(matched_pt))
        n_map = torch.sum((inlier & (matched_pt >= 0)).to(_I32))
        return pose, matched_pt, n_inl, n_map

    def gather_local_map(state: ms.MapState, matched_pt: torch.Tensor,
                         pose: torch.Tensor):
        """`Tracking::UpdateLocalKeyFrames/Points` (`src/Tracking.cc:
        1455-1599`): vote for KFs observing current points; local map =
        points of the top-80 voted KFs + the reference KF's top-10
        covisible KFs, culled to the 1.25x frustum. Returns (local_pt_idx
        (LOCAL_PTS,), ref_kf)."""
        K = state.kf_capacity
        ok = matched_pt >= 0
        obs_kf = state.pt_obs_kf[_clip0(matched_pt)]  # (N,O)
        obs_ok = ok[:, None] & (obs_kf >= 0)
        votes = torch.zeros(K, dtype=_I32, device=state.device)
        votes = ms.add_rows(votes, obs_kf.reshape(-1), obs_ok.reshape(-1).to(_I32),
                             obs_ok.reshape(-1))
        votes = torch.where(state.kf_valid, votes, torch.zeros_like(votes))
        ref_kf = torch.argmax(votes).to(_I32)
        top_votes, top_kfs = torch.sort(votes, descending=True, stable=True)
        top_votes, top_kfs = top_votes[:min(LOCAL_KFS, K)], top_kfs[:min(LOCAL_KFS, K)]
        neigh = ms.covisible_keyframes(state, ref_kf, 10)
        sel = torch.cat([torch.where(top_votes > 0, top_kfs.to(_I32),
                                     _minus1(top_kfs)), neigh])
        # membership bitmask, built as the JAX version builds it: a MAX
        # scatter of one bit per selected KF into 32-bit words. A max keeps
        # one bit per word (the highest set, or none for bit 31, which is
        # negative in int32) — kept as is for parity.
        n_words = (K + 31) // 32
        sel0 = torch.clamp(sel, min=0)
        bitval = torch.where(sel >= 0, torch.ones_like(sel0) << (sel0 & 31),
                             torch.zeros_like(sel0))
        words = torch.zeros(n_words, dtype=_I32, device=state.device).scatter_reduce(
            0, (sel0 >> 5).long(), bitval, reduce="amax", include_self=True)
        po = state.pt_obs_kf  # (P,O)
        po_safe = torch.clamp(po, min=0)
        bit = torch.zeros_like(po)
        for w in range(n_words):
            bit = bit | torch.where((po_safe >> 5) == w,
                                    (words[w] >> (po_safe & 31)) & 1,
                                    torch.zeros_like(po))
        in_local = ((bit > 0) & (po >= 0)).any(-1) & state.pt_valid
        p_cam = se3.transform_points(pose, state.pt_pos)
        z = p_cam[:, 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = cam.fx * p_cam[:, 0] / zs + cam.cx
        v = cam.fy * p_cam[:, 1] / zs + cam.cy
        in_view = (z > 0) & (u >= view_box[0]) & (u < view_box[1]) \
            & (v >= view_box[2]) & (v < view_box[3])
        local_idx = ms.compact_indices(in_local & in_view,
                                       min(LOCAL_PTS, state.pt_capacity))
        return local_idx, ref_kf

    def track_local_map(state: ms.MapState, frame: frame_mod.FrameData,
                        pose: torch.Tensor, matched_pt: torch.Tensor,
                        local_idx: torch.Tensor, th: float):
        """`Tracking::SearchLocalPoints` + pose optimization
        (`src/Tracking.cc:1177-1221,1403-1453`). Returns (state with
        visible/found counters bumped, pose, matched_pt, n_inliers)."""
        P = state.pt_capacity
        lp = _clip0(local_idx)
        lp_valid = (local_idx >= 0) & state.pt_valid[lp]
        # skip points already matched in this frame (Tracking.cc:1408-1419).
        # The JAX version builds this mask with one scatter in which
        # unmatched rows clamp to slot 0 and write False; XLA applies
        # duplicate writes in row order, so slot 0 takes the value of the
        # LAST row that targets it. Reproduced here for parity.
        matched = matched_pt >= 0
        already = ms.set_rows(torch.zeros(P, dtype=torch.bool, device=state.device),
                               matched_pt, torch.ones_like(matched), matched)
        to0 = matched_pt <= 0
        n = matched_pt.shape[0]
        last0 = (n - 1) - torch.argmax(torch.flip(to0, [0]).to(torch.int8))
        already[0] = torch.where(to0.any(), matched[last0], already[0])
        lp_valid = lp_valid & ~already[lp]
        new_matches, _, visible = matching.search_by_projection_points(
            cam, pose,
            frame.kp_xy, frame.kp_octave, frame.desc_bits, frame.valid,
            matched_pt >= 0,
            state.pt_pos[lp], state.pt_normal[lp], state.pt_min_dist[lp],
            state.pt_max_dist[lp], hamming.unpack_bits(state.pt_desc[lp]),
            lp_valid, bounds_t, scale_factors, th=th,
            n_levels=n_levels, scale_factor=scale_factor)
        merged = torch.where((new_matches >= 0) & (matched_pt < 0),
                             local_idx[_clip0(new_matches)], matched_pt)
        with metrics.span("track.pose_lm"):
            pose2, merged, n_inl = optimize_pose(state, frame, pose, merged)
        # visibility bookkeeping (MapPoint::IncreaseVisible/Found): as in the
        # JAX version, rows that are not visible add their 1 to slot P-1
        vis_idx = torch.where(lp_valid & visible, lp, torch.full_like(lp, P - 1))
        visible_upd = state.pt_visible.index_add(0, vis_idx, torch.ones_like(vis_idx, dtype=_I32))
        found_upd = state.pt_found.index_add(0, _clip0(merged),
                                             (merged >= 0).to(_I32))
        state = state._replace(pt_visible=visible_upd, pt_found=found_upd)
        return state, pose2, merged, n_inl

    def create_keyframe_rgbd(state: ms.MapState, frame: frame_mod.FrameData,
                             pose: torch.Tensor, matched_pt: torch.Tensor,
                             frame_id: int, close_depth_th: float):
        """`Tracking::CreateNewKeyFrame` (`src/Tracking.cc:1323-1401`): insert
        the KF; walk features with depth nearest-first and seed a point for
        every untracked one; past thDepth stop once 100 points are
        accounted for."""
        state, kf = ms.add_keyframe(
            state, pose, frame.timestamp, frame_id,
            frame.kp_xy, frame.kp_ur, frame.kp_depth, frame.kp_octave,
            frame.kp_angle, frame.valid, frame.desc)
        feat = torch.arange(frame.kp_xy.shape[0], dtype=_I32, device=state.device)
        has_match = (matched_pt >= 0) & state.pt_valid[_clip0(matched_pt)]
        state = ms.add_observations(state, kf, matched_pt, feat, has_match)
        has_depth = frame.valid & (frame.kp_depth > 0)
        depth_key = torch.where(has_depth, frame.kp_depth,
                                torch.full_like(frame.kp_depth, float("inf")))
        order = torch.argsort(depth_key, stable=True)
        running = torch.cumsum(has_depth[order].to(_I32), 0)
        before_break = torch.zeros_like(has_depth)
        before_break[order] = (running <= 100) | (depth_key[order] < close_depth_th)
        need_new = has_depth & ~has_match & before_break
        p_cam = projection.backproject(cam, frame.kp_xy, frame.kp_depth)
        p_world = se3.transform_points(se3.se3_inv(pose), p_cam)
        state, slots = ms.add_points(state, p_world, frame.desc, kf, kf, need_new)
        state = ms.add_observations(state, kf, slots, feat, need_new)
        state = ms.compute_distinctive_descriptors_idx(
            state, torch.clamp(slots, min=0), slots >= 0)
        state = ms.update_normal_and_depth_idx(
            state, torch.clamp(slots, min=0), slots >= 0, scale_factors, n_levels)
        state = ms.update_connections(state, kf)
        return state, kf, torch.where(need_new, slots, matched_pt)

    def match_for_initialization(f1: frame_mod.FrameData, f2: frame_mod.FrameData):
        """`SearchForInitialization`, window 100, ratio 0.9, over level-0
        features (`src/Tracking.cc:843`). Returns (matches12 (N,), n)."""
        return matching.search_for_initialization(
            f1.kp_xy, f1.kp_angle, f1.desc_bits, f1.valid & (f1.kp_octave == 0),
            f2.kp_xy, f2.kp_angle, f2.desc_bits, f2.valid & (f2.kp_octave == 0),
            window=100.0, nn_ratio=0.9)

    def create_initial_map_mono(state: ms.MapState, f1: frame_mod.FrameData,
                                f2: frame_mod.FrameData, frame_id1: int, frame_id2: int,
                                matches12: torch.Tensor, R21: torch.Tensor,
                                t21: torch.Tensor, pts3d: torch.Tensor, good: torch.Tensor):
        """`Tracking::CreateInitialMapMonocular` (`src/Tracking.cc:882-984`):
        two keyframes, the triangulated points, connections, then the
        median-depth scale normalization (the bootstrap GBA runs after).
        Returns (state, kf1, kf2, matched2 (N,) point per frame-2 feature,
        n_pts, median depth)."""
        dev = state.device
        T1 = torch.eye(4, dtype=torch.float32, device=dev)
        T2 = se3.rt_to_mat(R21, t21).to(torch.float32)
        state, kf1 = ms.add_keyframe(
            state, T1, f1.timestamp, frame_id1, f1.kp_xy, f1.kp_ur, f1.kp_depth,
            f1.kp_octave, f1.kp_angle, f1.valid, f1.desc)
        state, kf2 = ms.add_keyframe(
            state, T2, f2.timestamp, frame_id2, f2.kp_xy, f2.kp_ur, f2.kp_depth,
            f2.kp_octave, f2.kp_angle, f2.valid, f2.desc)
        ok = good & (matches12 >= 0)
        m2 = torch.clamp(matches12, min=0)
        state, slots = ms.add_points(state, pts3d, f1.desc, kf1, kf1, ok)
        feat1 = torch.arange(f1.kp_xy.shape[0], dtype=_I32, device=dev)
        state = ms.add_observations(state, kf1, slots, feat1, ok)
        state = ms.add_observations(state, kf2, slots, m2, ok)
        # the JAX version marks the new points with one scatter in which
        # rows without a point clamp to slot 0 and write False; XLA applies
        # duplicate writes in row order, so slot 0 takes the LAST such row's
        # value (normally False: the new point in slot 0 is then neither
        # counted nor rescaled). Reproduced here for parity.
        live = slots >= 0
        pmask = ms.set_rows(torch.zeros(state.pt_capacity, dtype=torch.bool, device=dev),
                            slots, torch.ones_like(live), live)
        to0 = slots <= 0
        last0 = (slots.shape[0] - 1) - torch.argmax(torch.flip(to0, [0]).to(torch.int8))
        pmask[0] = torch.where(to0.any(), live[last0], pmask[0])
        state = ms.compute_distinctive_descriptors_idx(state, torch.clamp(slots, min=0), live)
        state = ms.update_normal_and_depth_idx(state, torch.clamp(slots, min=0), live,
                                               scale_factors, n_levels)
        state = ms.update_connections(state, kf1)
        state = ms.update_connections(state, kf2)
        # median scene depth of KF1 for the scale normalization
        # (Tracking.cc:934-960); KF1 is the origin, so depth is z
        zv = torch.where(pmask, state.pt_pos[:, 2], torch.full_like(state.pt_pos[:, 2],
                                                                    float("inf")))
        n_pts = torch.sum(pmask.to(_I32))
        med = torch.sort(zv)[0][torch.clamp((n_pts - 1) // 2, min=0)]
        inv_med = 1.0 / torch.clamp(med, min=1e-9)
        kf_pose = state.kf_pose.clone()
        kf_pose[kf2, :3, 3] = kf_pose[kf2, :3, 3] * inv_med
        state = state._replace(
            kf_pose=kf_pose,
            pt_pos=torch.where(pmask[:, None], state.pt_pos * inv_med, state.pt_pos))
        # the point per frame-2 feature: an order-free max scatter
        n2 = f2.kp_xy.shape[0]
        matched2 = torch.full((n2,), -1, dtype=_I32, device=dev).scatter_reduce(
            0, torch.where(ok, m2, n2 - 1).long(), torch.where(ok, slots, _minus1(slots)),
            reduce="amax", include_self=True)
        return state, kf1, kf2, matched2, n_pts, med

    def create_keyframe_mono(state: ms.MapState, frame: frame_mod.FrameData,
                             pose: torch.Tensor, matched_pt: torch.Tensor, frame_id: int):
        """Monocular `CreateNewKeyFrame`: no depth-seeded points
        (`src/Tracking.cc:1331-1334` returns early for mono)."""
        state, kf = ms.add_keyframe(
            state, pose, frame.timestamp, frame_id, frame.kp_xy, frame.kp_ur,
            frame.kp_depth, frame.kp_octave, frame.kp_angle, frame.valid, frame.desc)
        feat = torch.arange(frame.kp_xy.shape[0], dtype=_I32, device=state.device)
        has = (matched_pt >= 0) & state.pt_valid[_clip0(matched_pt)]
        state = ms.add_observations(state, kf, matched_pt, feat, has)
        return ms.update_connections(state, kf), kf

    return dict(
        init_rgbd=init_rgbd,
        track_motion=track_motion,
        track_ref_kf=track_ref_kf,
        optimize_pose=optimize_pose,
        optimize_pose_xyz=optimize_pose_xyz,
        gather_local_map=gather_local_map,
        track_local_map=track_local_map,
        create_keyframe_rgbd=create_keyframe_rgbd,
        match_for_initialization=match_for_initialization,
        create_initial_map_mono=create_initial_map_mono,
        create_keyframe_mono=create_keyframe_mono,
    )


@dataclasses.dataclass
class TrackerConfig:
    min_frames: int = 0  # Tracking.cc:163-174
    max_frames: int = 30  # = fps
    th_depth: float = 3.0  # meters (bf/fx * ThDepth)
    min_init_features: int = 500  # Tracking.cc:752
    motion_th: float = 15.0  # RGBD/mono window (Tracking.cc:1127)
    local_th: float = 3.0  # RGBD local search (Tracking.cc:1447); mono 1
    is_mono: bool = False


class Tracker:
    """Host driver over the per-frame step (the Tracking thread's member
    state, `include/Tracking.h:85-228`). Each frame: build, step, read the
    outcome; while LOST or in map-less odometry (`mb_vo`), relocalize on
    the frame (`_host_relocalize`)."""

    def __init__(self, cam: projection.Camera, builder: frame_mod.FrameBuilder,
                 state: ms.MapState, cfg: TrackerConfig,
                 n_levels: int = 4, scale_factor: float = 1.5, mapper=None):
        from . import fused_step

        self.cam = cam
        self.K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                               [0.0, 0.0, 1.0]], dtype=torch.float32, device=builder.device)
        self.builder = builder
        self.map = state
        self.cfg = cfg
        self.k = make_tracking_kernels(cam, builder, n_levels, scale_factor)
        self.step = fused_step.make_fused_step(cam, builder, n_levels,
                                               scale_factor, cfg, mapper)
        self.ctrl: fused_step.ControlState | None = None
        self.state = NO_IMAGES_YET
        self.ref_kf = 0  # reference KF of the LOST-mode retry (as in JAX)
        self.frame_id = 0  # frames tracked (seeds relocalization's RANSAC)
        self.disallow_kf = False  # localization-only mode (no KF creation)
        self.relocalizer = None  # set by SLAMSystem (relocalization.Relocalizer)
        self.mb_vo = False  # map-less odometry active (Tracking.cc:595-640)
        # device timestamps are f32 OFFSETS from this f64 epoch (the first
        # frame's stamp); exports add it back
        self.ts_epoch: float | None = None
        self._trajectory: list[tuple[float, np.ndarray, bool]] = []
        self.needs_reset = False  # lost-after-init ladder (Tracking.cc:712-718)
        self.n_pt_watermark = 0
        self.n_kf_watermark = 0
        # local-BA lane telemetry: lanes dropped even after O_BA_ESC
        # escalation, and the number of escalated mapping steps
        self.ba_lanes_dropped = 0
        self.ba_escalations = 0
        self.new_kf_slots: list[int] = []  # loop-closing queue
        self.host_kf_slots: list[int] = []  # keyframes made on the host (mono bootstrap)
        self._init_frame = None  # the monocular initializer's first frame
        self._init_frame_id = 0
        self.last_frame: frame_mod.FrameData | None = None  # the newest frame built
        # keyframes alive after the newest frame, as its step's outcome read
        # them (the viewer's live rewrite counts with it: no device read)
        self.n_kf = 0

    @property
    def trajectory(self) -> list[tuple[float, np.ndarray, bool]]:
        return self._trajectory

    def _dev_ts(self, timestamp: float) -> float:
        """f32-safe device timestamp: offset from the run's f64 epoch."""
        if self.ts_epoch is None:
            self.ts_epoch = float(timestamp)
        return float(timestamp) - self.ts_epoch

    @metrics.traced("track.record")
    def _record(self, out, t: float):
        """Host view of one step's outcome (the JAX version's batched
        `flush`, one frame at a time)."""
        from . import fused_step

        lost = out.mode != fused_step.MODE_OK
        self._trajectory.append((t, out.pose.cpu().numpy(), lost))
        self.n_pt_watermark = out.n_pt
        self.n_kf_watermark = out.n_kf_alloc
        self.n_kf = out.n_kf
        self.ba_lanes_dropped += out.ba_lanes_dropped
        self.ba_escalations += int(out.ba_escalated)
        if out.kf_created:
            self.new_kf_slots.append(int(out.kf_slot))
        self.state = {1: NOT_INITIALIZED, 2: OK, 3: LOST}.get(out.mode, out.mode)
        self.mb_vo = out.mb_vo
        # lost right after initialization (<= 5 KFs) -> full system reset
        # (`src/Tracking.cc:712-718`); the SLAMSystem drains the flag
        if self.state == LOST and not self.disallow_kf and out.n_kf <= 5:
            self.needs_reset = True

    def _ensure_ctrl(self, fr: frame_mod.FrameData):
        """The control state at the first frame; after a map load (reuse
        mode) it starts LOST, to relocalize against the loaded map, and in
        localization-only mode it creates no keyframe
        (`tracking.py:545-555`)."""
        from . import fused_step

        if self.ctrl is None:
            self.ctrl = fused_step.initial_control_state(fr)
            if self.state == LOST:
                self.ctrl = self.ctrl._replace(mode=fused_step.MODE_LOST)
            if self.disallow_kf:
                self.ctrl = self.ctrl._replace(allow_kf=False)

    @metrics.traced("reloc.host")
    def _host_relocalize(self, fr: frame_mod.FrameData):
        """`Tracking::Relocalization` (`src/Tracking.cc:1601-1775`) on this
        frame, while LOST or in map-less odometry (`tracking.py:578-612`):
        the relocalizer first; while LOST (never under mb_vo, where the
        reference only relocalizes, `Tracking.cc:607-611`) a retry against
        the reference keyframe after it."""
        from . import fused_step

        pose = matched = None
        if self.relocalizer is not None:
            out = self.relocalizer.relocalize(self.map, fr, self.frame_id)
            if out is not None:
                pose, matched, _ = out
        if pose is None and self.state == LOST:
            matched, n = self.k["track_ref_kf"](self.map, fr, self.ref_kf)
            if int(n) >= 15:
                p2, matched, n_inl = self.k["optimize_pose"](
                    self.map, fr, self.ctrl.pose, matched)
                if int(n_inl) >= 10:
                    pose = p2
        if pose is not None:
            self.ctrl = self.ctrl._replace(
                mode=fused_step.MODE_OK, pose=pose, has_velocity=False,
                last_matched=matched.to(_I32), mb_vo=False)
            self.state = OK
            self.mb_vo = False

    def track_rgbd(self, image, depth, timestamp: float):
        """Per-frame entry (`GrabImageRGBD`, `src/Tracking.cc:300-360`);
        returns the step's Tcw (4,4) numpy pose (not meaningful on a lost
        frame)."""
        return self._track(self.builder.build(image, self._dev_ts(timestamp), depth),
                           timestamp)

    def track_stereo(self, image_left, image_right, timestamp: float):
        """Per-frame entry (`GrabImageStereo`, `src/Tracking.cc:246-298`):
        the RGB-D step on a frame whose depth comes from the stereo matches;
        returns the step's Tcw (4,4) numpy pose."""
        return self._track(
            self.builder.build_stereo(image_left, image_right, self._dev_ts(timestamp)),
            timestamp)

    def _track(self, fr: frame_mod.FrameData, timestamp: float):
        """The per-frame step on a frame with depth (RGB-D or stereo)."""
        self.last_frame = fr
        self._ensure_ctrl(fr)
        with metrics.span("track.step"):
            self.map, self.ctrl, out = self.step(self.map, self.ctrl, fr)
        self._record(out, float(timestamp))
        self.frame_id += 1
        # relocalization retries EVERY frame while lost or in map-less VO
        # (`src/Tracking.cc:595-640,1601`)
        if self.state == LOST or self.mb_vo:
            self._host_relocalize(fr)
        return self._trajectory[-1][1]

    def track_monocular(self, image, timestamp: float):
        """Per-frame entry (`GrabImageMonocular`, `src/Tracking.cc:405-441`):
        the two-view bootstrap on the host until it succeeds, then the
        per-frame step; returns the frame's Tcw (4,4) numpy pose (identity
        while not initialized)."""
        t_dev = self._dev_ts(timestamp)
        fr = self.builder.build(image, t_dev)
        self.last_frame = fr
        self._ensure_ctrl(fr)
        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            self._mono_initialize(fr, float(timestamp))
            self.frame_id += 1
            return self._trajectory[-1][1]
        with metrics.span("track.step"):
            self.map, self.ctrl, out = self.step(self.map, self.ctrl, fr)
        self._record(out, float(timestamp))
        self.frame_id += 1
        if self.state == LOST or self.mb_vo:
            self._host_relocalize(fr)
        return self._trajectory[-1][1]

    def _init_failed(self, t: float, drop: bool = False):
        if drop:
            self._init_frame = None
        self._trajectory.append((t, np.eye(4, dtype=np.float32), True))

    def _mono_initialize(self, fr: frame_mod.FrameData, t: float):
        """`Tracking::MonocularInitialization` (`src/Tracking.cc:804-880`) +
        `CreateInitialMapMonocular` (`:882-984`) on the host, as in the JAX
        version (`tracking.py:653-733`). The RANSAC draws come from a
        generator seeded with the frame id (JAX: PRNGKey(frame_id))."""
        n_feat = int(torch.sum(fr.valid.to(_I32)))
        if self._init_frame is None:
            if n_feat > 100:  # Tracking.cc:809
                self._init_frame, self._init_frame_id = fr, self.frame_id
            self.state = NOT_INITIALIZED
            return self._init_failed(t)
        if n_feat <= 100:  # Tracking.cc:830-836
            return self._init_failed(t, drop=True)
        f1 = self._init_frame
        matches12, n = self.k["match_for_initialization"](f1, fr)
        if int(n) < 100:  # Tracking.cc:847-853
            return self._init_failed(t, drop=True)
        sel = matches12 >= 0
        kp2 = torch.where(sel[:, None], fr.kp_xy[torch.clamp(matches12, min=0).long()],
                          torch.zeros_like(f1.kp_xy))
        gen = torch.Generator(device=fr.kp_xy.device)
        gen.manual_seed(self.frame_id)
        out = initializer.initialize_two_view(f1.kp_xy, kp2, sel, self.K, 200,
                                              generator=gen)
        if not bool(out["success"]):
            return self._init_failed(t)
        state, kf1, kf2, matched2, n_pts, med = self.k["create_initial_map_mono"](
            self.map, f1, fr, self._init_frame_id, self.frame_id, matches12,
            out["R21"], out["t21"], out["points3d"], out["good"])
        if float(med) < 0 or int(n_pts) < 100:  # Tracking.cc:937-944
            return self._init_failed(t)
        # GlobalBundleAdjustemnt(20) on the bootstrap pair (Tracking.cc:931:
        # robust, keyframe slot 0 fixed; the JAX version hard-codes "dense")
        poses, pts, _ = global_ba.full_bundle_adjustment(
            self.cam, state, self.builder.inv_level_sigma2_t, n_iters=20, robust=True,
            solver="dense")
        self.map = state._replace(kf_pose=poses, pt_pos=pts)
        self.state = OK
        self.ref_kf = kf2
        self.n_kf = 2  # the bootstrap pair, on an empty map
        pose = self.map.kf_pose[kf2]
        self.host_kf_slots += [kf1, kf2]
        self._init_frame = None
        from . import fused_step

        self.ctrl = self.ctrl._replace(
            mode=fused_step.MODE_OK, pose=pose, has_velocity=False, ref_kf=kf2,
            frame_id=self.frame_id + 1, last_kf_frame_id=self.frame_id,
            last_matched=matched2, last_frame=fr)
        self._trajectory.append((t, pose.cpu().numpy(), False))
