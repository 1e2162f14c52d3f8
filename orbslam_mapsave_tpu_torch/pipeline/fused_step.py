"""The per-frame tracking step: mode switch, OK-mode pipeline, keyframe
decision and keyframe creation (RGB-D, or monocular with `cfg.is_mono`).

Port of `orbslam_mapsave_tpu/pipeline/fused_step.py`, with the predicated
local-mapping pass on the frames that create a keyframe. The JAX version
compiles the frame into one device program with `lax.cond`/`lax.switch`
because every host read crossed a network link; here the branches are
Python `if`s on values read from the card, and the outcome is read every
frame. The results are the same; the tests hold this against the JAX step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..slammap import mapstate as ms
from ..utils import metrics
from . import frame as frame_mod
from . import tracking as trk

MODE_NOT_INITIALIZED = 1
MODE_OK = 2
MODE_LOST = 3


class ControlState(NamedTuple):
    """Tracker state carried between frames (the members of `Tracking`,
    `include/Tracking.h:85-228`, that the per-frame loop reads/writes).
    Scalars live on the host, arrays on the device."""

    mode: int
    pose: torch.Tensor  # (4,4) f32 last Tcw
    velocity: torch.Tensor  # (4,4) f32 motion model
    has_velocity: bool
    ref_kf: int
    frame_id: int  # id of the NEXT frame to process
    last_kf_frame_id: int
    last_matched: torch.Tensor  # (N,) i32 point slot per last-frame feature
    last_frame: frame_mod.FrameData
    recent_start: int  # mapper recent-point window start
    allow_kf: bool  # False in localization-only mode
    mb_vo: bool  # map-less visual odometry (Tracking.cc:595-640)


class StepOutcome(NamedTuple):
    mode: int  # tracker mode AFTER the frame
    pose: torch.Tensor  # (4,4) f32 Tcw (garbage when lost)
    n_inliers: int
    kf_created: bool
    kf_slot: int
    n_kf: int  # keyframes alive after the frame
    n_pt: int  # point slots allocated (allocator watermark)
    n_kf_alloc: int  # keyframe slots allocated (watermark)
    ba_lanes_dropped: int = 0  # in-window BA lanes dropped even after
    # escalation (0 on frames without a mapping pass)
    ba_escalated: bool = False  # BA rebuilt at O_BA_ESC lanes
    mb_vo: bool = False  # map-less odometry: the host relocalizes while set


def initial_control_state(frame: frame_mod.FrameData) -> ControlState:
    dev = frame.kp_xy.device
    n = frame.kp_xy.shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return ControlState(
        mode=MODE_NOT_INITIALIZED, pose=eye, velocity=eye, has_velocity=False,
        ref_kf=0, frame_id=0, last_kf_frame_id=0,
        last_matched=torch.full((n,), -1, dtype=torch.int32, device=dev),
        last_frame=frame, recent_start=0, allow_kf=True, mb_vo=False)


def make_fused_step(cam, builder: frame_mod.FrameBuilder, n_levels: int,
                    scale_factor: float, cfg: trk.TrackerConfig, mapper=None):
    """Returns step(map_state, ctrl, frame) -> (map_state, ctrl, outcome).
    `mapper`: a `LocalMapper` whose pass runs inside the step on every frame
    that creates a keyframe, or None for tracking only."""
    k = trk.make_tracking_kernels(cam, builder, n_levels, scale_factor)
    is_mono = cfg.is_mono

    def _empty_matched(frame):
        return torch.full((frame.kp_xy.shape[0],), -1, dtype=torch.int32,
                          device=frame.kp_xy.device)

    @metrics.traced("track.outcome")
    def _outcome(state, mode, pose, n_inliers=0, kf_slot=-1, ba_dropped=0,
                 ba_esc=False, mb_vo=False):
        return StepOutcome(
            mode=mode, pose=pose, n_inliers=int(n_inliers),
            kf_created=kf_slot >= 0, kf_slot=kf_slot,
            n_kf=int(torch.sum(state.kf_valid.to(torch.int32))),
            n_pt=int(state.n_pt), n_kf_alloc=int(state.n_kf),
            ba_lanes_dropped=ba_dropped, ba_escalated=ba_esc, mb_vo=mb_vo)

    def _need_new_keyframe(state, frame, matched, n_inl, ref_kf, ctrl) -> bool:
        """`Tracking::NeedNewKeyFrame` — this fork's map-coverage formula
        (`src/Tracking.cc:1224-1321`); see the JAX version for the
        reasoning behind each gate. Evaluated in float32 as there. Mono has
        no close points (ratio 1, `:1270`), a 0.9 reference ratio and no
        c1c (`:1291`)."""
        f32 = torch.float32
        if is_mono:
            ratio_map = torch.tensor(1.0, dtype=f32)
        else:
            close = frame.valid & (frame.kp_depth > 0) & (frame.kp_depth < cfg.th_depth)
            safe = torch.clamp(matched, min=0).long()
            ok_pt = (matched >= 0) & state.pt_valid[safe]
            has_obs = (state.pt_obs_kf[safe] >= 0).any(-1)
            n_map = torch.sum((close & ok_pt & has_obs).to(torch.int32))
            n_total = torch.sum(close.to(torch.int32))
            ratio_map = (n_map.to(f32) / torch.clamp(n_total.to(f32), min=1.0)).cpu()
        th_map_ratio = 0.20 if n_inl > 300 else 0.35
        n_kfs = int(torch.sum(state.kf_valid.to(torch.int32)))
        th_ref = 0.4 if n_kfs < 2 else (0.9 if is_mono else 0.75)
        ref_pts = state.kf_kp_point[ref_kf]
        ref_has = (ref_pts >= 0) & state.kf_kp_valid[ref_kf]
        n_obs_ref = torch.sum((state.pt_obs_kf[torch.clamp(ref_pts, min=0).long()] >= 0)
                              .to(torch.int32), dim=-1)
        min_obs = 2 if n_kfs <= 2 else 3
        ref_matches = int(torch.sum((ref_has & (n_obs_ref >= min_obs)).to(torch.int32)))
        if ref_matches == 0:
            ref_matches = int(torch.sum(ref_has.to(torch.int32)))
        c1a = ctrl.frame_id >= ctrl.last_kf_frame_id + cfg.max_frames
        c1b = ctrl.frame_id >= ctrl.last_kf_frame_id + cfg.min_frames
        rm = torch.tensor(ref_matches, dtype=f32)
        ninl = torch.tensor(n_inl, dtype=f32)
        c1c = not is_mono and bool((ninl < rm * 0.25) | (ratio_map < 0.3))
        c2 = bool((ninl < rm * th_ref) | (ratio_map < th_map_ratio)) and n_inl > 15
        cap_ok = int(state.n_kf) < state.kf_capacity - 1
        return (c1a or c1b or c1c) and c2 and cap_ok

    def _track_ok(state, ctrl: ControlState, frame):
        """The OK-mode pipeline (`Tracking::Track`, `src/Tracking.cc:575-640`).
        In localization-only mode (`allow_kf` False, the reference's
        mbOnlyTracking) the motion model also matches the last frame's
        temporal points, passes with > 20 inliers, and flags map-less
        odometry (mb_vo) when fewer than 10 of them are map points
        (`src/Tracking.cc:1160-1174,612-615`); under mb_vo the local map is
        not tracked and the map is left as it was."""
        only_tracking = not ctrl.allow_kf
        pose_pred = ctrl.velocity @ ctrl.pose
        ok1, use_vo = False, False
        if ctrl.has_velocity:
            with metrics.span("track.motion"):
                m, pw, have, nm = k["track_motion"](
                    state, frame, pose_pred, ctrl.last_matched, ctrl.last_frame,
                    cfg.motion_th, ctrl.pose, only_tracking)
                if int(nm) < 20:
                    m, pw, have, nm = k["track_motion"](
                        state, frame, pose_pred, ctrl.last_matched,
                        ctrl.last_frame, 2.0 * cfg.motion_th, ctrl.pose, only_tracking)
                enough = int(nm) >= 20
            if enough:
                with metrics.span("track.pose_lm"):
                    pose1, m1, ninl, nmap = k["optimize_pose_xyz"](
                        state, frame, pose_pred, pw, have, m)
                    if only_tracking:
                        ok1 = int(ninl) > 20
                        use_vo = int(nmap) < 10 and int(ninl) > 20
                    else:
                        ok1 = int(nmap) >= 10
        if not ok1:
            with metrics.span("track.ref_kf"):
                m, nm = k["track_ref_kf"](state, frame, ctrl.ref_kf)
                pose1, m1 = ctrl.pose, m
                enough = int(nm) >= 15
            if enough:
                with metrics.span("track.pose_lm"):
                    pose1, m1, ninl = k["optimize_pose"](state, frame, ctrl.pose, m)
                    ok1 = int(ninl) >= 10

        # local-map tracking runs even if the first track failed, as in the
        # JAX step (it cannot rescue it: the outcome is gated on ok1); under
        # mb_vo its result is dropped (the reference skips it there,
        # `src/Tracking.cc:654-660`)
        with metrics.span("track.local_map_gather"):
            local_idx, ref2 = k["gather_local_map"](state, m1, pose1)
        with metrics.span("track.local_map_search"):
            state2, pose2, m2, n_inl = k["track_local_map"](
                state, frame, pose1, m1, local_idx, cfg.local_th)
            n_inl = int(n_inl)
            ref2 = int(ref2)
        ok2 = ok1 and (use_vo or n_inl >= 30)  # Tracking.cc:1213-1219
        if use_vo:
            pose2, m2 = pose1, m1
        if not ok1 or use_vo:
            state2 = state

        kf_slot, m3, state3 = -1, m2, state2
        need_kf = False
        if ok2 and ctrl.allow_kf:
            with metrics.span("track.kf_decision"):
                need_kf = _need_new_keyframe(state2, frame, m2, n_inl, ref2, ctrl)
        if need_kf:
            with metrics.span("track.kf_create"):
                if is_mono:
                    state3, kf_slot = k["create_keyframe_mono"](
                        state2, frame, pose2, m2, ctrl.frame_id)
                else:
                    state3, kf_slot, m3 = k["create_keyframe_rgbd"](
                        state2, frame, pose2, m2, ctrl.frame_id, cfg.th_depth)

        # ---- predicated LocalMapping pass ----
        do_kf = kf_slot >= 0
        recent_start, ba_dropped, ba_esc = ctrl.recent_start, 0, False
        if mapper is not None and do_kf:
            n_pt_before = int(state3.n_pt)
            # mbAbortBA analogue (`src/LocalMapping.cc:118`): keyframes
            # <= 2 frames apart truncate BA to its first phase
            abort_ba = (ctrl.frame_id - ctrl.last_kf_frame_id) <= 2
            state3, ba_dropped, ba_esc = mapper._map_step(
                state3, kf_slot, ctrl.recent_start, abort_ba)
            recent_start = n_pt_before

        eye = torch.eye(4, dtype=torch.float32, device=pose2.device)
        ctrl2 = ctrl._replace(
            mode=MODE_OK if ok2 else MODE_LOST,
            pose=pose2 if ok2 else ctrl.pose,
            velocity=pose2 @ se3.se3_inv(ctrl.pose) if ok2 else eye,
            has_velocity=ok2,
            ref_kf=kf_slot if do_kf else ref2,
            frame_id=ctrl.frame_id + 1,
            last_kf_frame_id=ctrl.frame_id if do_kf else ctrl.last_kf_frame_id,
            last_matched=m3, last_frame=frame, recent_start=recent_start,
            mb_vo=ok2 and use_vo)
        return state3, ctrl2, _outcome(state3, ctrl2.mode, pose2, n_inl, kf_slot,
                                       ba_dropped, ba_esc, ctrl2.mb_vo)

    def _init_rgbd(state, ctrl: ControlState, frame):
        """`Tracking::StereoInitialization` (`src/Tracking.cc:750-802`) when
        the frame has enough features."""
        eye = torch.eye(4, dtype=torch.float32, device=frame.kp_xy.device)
        if int(torch.sum(frame.valid.to(torch.int32))) < cfg.min_init_features:
            ctrl2 = ctrl._replace(frame_id=ctrl.frame_id + 1, last_frame=frame,
                                  last_matched=_empty_matched(frame))
            return state, ctrl2, _outcome(state, ctrl.mode, eye)
        st, kf, matched, n_pts = k["init_rgbd"](state, frame, ctrl.frame_id)
        ctrl2 = ControlState(
            mode=MODE_OK, pose=eye, velocity=eye, has_velocity=False,
            ref_kf=kf, frame_id=ctrl.frame_id + 1,
            last_kf_frame_id=ctrl.frame_id, last_matched=matched,
            last_frame=frame, recent_start=ctrl.recent_start,
            allow_kf=ctrl.allow_kf, mb_vo=False)
        return st, ctrl2, _outcome(st, MODE_OK, eye, n_pts, kf)

    def _lost(state, ctrl: ControlState, frame):
        """LOST passthrough: the host relocalizes (Tracker._host_relocalize)."""
        ctrl2 = ctrl._replace(
            frame_id=ctrl.frame_id + 1, last_frame=frame,
            last_matched=_empty_matched(frame), has_velocity=False, mb_vo=False)
        return state, ctrl2, _outcome(state, ctrl.mode, ctrl.pose)

    # mono initializes on the host (Tracker._mono_initialize): a
    # NOT_INITIALIZED frame passes through like a lost one (JAX :394)
    branches = (_lost if is_mono else _init_rgbd, _track_ok, _lost)

    def step(state: ms.MapState, ctrl: ControlState, frame: frame_mod.FrameData):
        idx = min(max(ctrl.mode - MODE_NOT_INITIALIZED, 0), 2)
        return branches[idx](state, ctrl, frame)

    return step
