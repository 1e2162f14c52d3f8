"""System facade — the public API mirroring the reference's `System` class.

Port of `orbslam_mapsave_tpu/pipeline/system.py`: `SLAMSystem(cfg,
Sensor.RGBD)` tracks RGB-D frames (`track_rgbd`), `SLAMSystem(cfg,
Sensor.STEREO)` rectified stereo pairs (`track_stereo`: depth from the
left-right matches, then the RGB-D path), `SLAMSystem(cfg,
Sensor.MONOCULAR)` single images (`track_monocular`, after an H / F
two-view bootstrap). Each runs a
local-mapping pass (triangulation, fuse, local BA, keyframe culling) at
every keyframe (`enable_mapping=False` tracks only), relocalizes when
tracking is lost (BoW candidates with a vocabulary, else the newest
keyframes), and given a vocabulary closes loops (BoW detection, Sim3 with
the scale free for mono, loop fusion, essential graph, incremental global
BA) unless `enable_loop_closing=False`. Maps are saved and loaded
(`save_map`, `load_map`, `reuse_map_path`): a loaded map starts LOST in
localization-only mode and relocalizes against it (`System.cc:148-195`,
`Tracking.cc:167-171`).
"""

from __future__ import annotations

import enum
from pathlib import Path

import numpy as np
import torch

from .. import config as config_mod
from ..geometry import projection
from ..io import mapio
from ..io import trajectory as traj_io
from ..ops import orb
from ..slammap import mapstate as ms
from ..utils import metrics
from . import frame as frame_mod
from . import fused_step, local_mapping, loop_closing, relocalization, tracking


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class SLAMSystem:
    """Facade; the constructor mirrors the JAX `SLAMSystem` (`System::System`,
    `include/System.h:81-84`) plus a `device`: the card ("cuda") unless the
    caller names another; with no card present, `device=None` raises
    RuntimeError and `device="cpu"` runs the plain PyTorch path."""

    def __init__(self, cfg: config_mod.SystemConfig, sensor: Sensor,
                 vocabulary=None, reuse_map_path: str | None = None,
                 enable_loop_closing: bool = True,
                 enable_mapping: bool = True, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SLAMSystem runs on the CUDA card by default and none is "
                    "present: pass device=\"cpu\" to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = cfg
        self.sensor = sensor
        c = cfg.camera
        self.cam = projection.Camera.create(
            c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2, c.k3,
            bf=c.bf, width=c.width, height=c.height)
        self.spec = orb.ORBSpec.create(
            c.height, c.width,
            n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels,
            scale_factor=cfg.orb.scale_factor, ini_th=cfg.orb.ini_th_fast,
            min_th=cfg.orb.min_th_fast, max_kp=cfg.max_keypoints)
        self.builder = frame_mod.FrameBuilder(self.cam, self.spec, self.device)
        if reuse_map_path:
            self.map = mapio.load_map(reuse_map_path, self.device)
        else:
            self.map = ms.empty_map(cfg.max_keyframes, cfg.max_points,
                                    cfg.max_keypoints, self.device)
        is_mono = sensor == Sensor.MONOCULAR
        # thDepth in meters = bf/fx * ThDepth (Tracking.cc:227-232); local
        # search th 3 for RGB-D, else 1 (Tracking.cc:1445-1450); motion
        # window 7 for stereo, else 15 (Tracking.cc:1127)
        tcfg = tracking.TrackerConfig(
            max_frames=int(c.fps),
            th_depth=float(c.bf) / float(c.fx) * float(c.th_depth),
            local_th=3.0 if sensor == Sensor.RGBD else 1.0,
            motion_th=7.0 if sensor == Sensor.STEREO else 15.0, is_mono=is_mono)
        self.mapper = (
            local_mapping.LocalMapper(
                self.cam, self.builder.inv_level_sigma2, is_mono=is_mono,
                scale_factors=self.builder.scale_factors,
                n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor)
            if enable_mapping else None)
        # the mapping pass runs inside the per-frame step on keyframe frames
        self.tracker = tracking.Tracker(
            self.cam, self.builder, self.map, tcfg,
            n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor,
            mapper=self.mapper)
        self.loop_closer = None
        if enable_loop_closing and vocabulary is not None:
            self.loop_closer = loop_closing.LoopCloser(
                self.cam, self.builder.inv_level_sigma2, vocabulary,
                fix_scale=not is_mono, scale_factors=self.builder.scale_factors,
                n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor)
        # relocalization (Tracking.cc:1601): BoW candidates from the loop
        # closer's store when there is one, the newest keyframes otherwise
        self.tracker.relocalizer = relocalization.Relocalizer(
            self.cam, self.builder.inv_level_sigma2, vocabulary,
            bow_store_ref=((lambda: self.loop_closer.bow_store)
                           if self.loop_closer is not None else None))
        self.localization_only = False  # ActivateLocalizationMode analogue
        if reuse_map_path:
            # reuse mode starts LOST in localization-only mode, relocalizing
            # against the loaded map (System.cc:90, Tracking.cc:167-171)
            self.tracker.ts_epoch = mapio.read_ts_epoch(reuse_map_path)
            self.localization_only = True
            self.tracker.state = tracking.LOST
            self.tracker.disallow_kf = True
            self._restore_bow(reuse_map_path)

    def _restore_bow(self, path) -> None:
        """The loop closer's BoW store over a loaded map: the persisted rows
        when the file holds them for this vocabulary and keyframe capacity,
        else the rebuild the reference always pays (`src/System.cc:162-163`)."""
        lc = self.loop_closer
        if lc is None:
            return
        store = mapio.load_bow_store(path, lc.voc.n_words, self.device)
        if store is not None and store.word.shape[0] == self.map.kf_capacity:
            lc.bow_store = store
        else:
            lc.rebuild_store(self.map)

    # ------ frame entry points (System.cc:261-490) ------
    def track_rgbd(self, image, depth, timestamp: float):
        """Track one RGB-D frame; returns its Tcw (4,4) numpy pose."""
        if self.sensor != Sensor.RGBD:
            raise ValueError(f"track_rgbd on a {self.sensor.name} system")
        with metrics.span("system.frame", frame=True):
            pose = self.tracker.track_rgbd(image, depth, timestamp)
            self._run_backends()
        return pose

    def track_stereo(self, image_left, image_right, timestamp: float):
        """Track one rectified stereo pair; returns the left camera's Tcw
        (4,4) numpy pose."""
        if self.sensor != Sensor.STEREO:
            raise ValueError(f"track_stereo on a {self.sensor.name} system")
        with metrics.span("system.frame", frame=True):
            pose = self.tracker.track_stereo(image_left, image_right, timestamp)
            self._run_backends()
        return pose

    def track_monocular(self, image, timestamp: float):
        """Track one image; returns its Tcw (4,4) numpy pose (the identity
        until the two-view bootstrap succeeds)."""
        if self.sensor != Sensor.MONOCULAR:
            raise ValueError(f"track_monocular on a {self.sensor.name} system")
        with metrics.span("system.frame", frame=True):
            pose = self.tracker.track_monocular(image, timestamp)
            self._run_backends()
        return pose

    @metrics.traced("system.backends")
    def _run_backends(self):
        """After each frame: reset when lost right after initialization,
        pump the global-BA job, run a mapping pass and loop closing on each
        keyframe made on the host (the monocular bootstrap pair), drain the
        new keyframes into loop closing (the LoopClosing thread body,
        `src/LoopClosing.cc:58-89`), and recycle slots near capacity."""
        self.map = self.tracker.map
        if self.tracker.needs_reset:
            # lost with <= 5 keyframes right after init: start over
            # (`src/Tracking.cc:712-718`)
            self.tracker.needs_reset = False
            self.reset()
            return
        if self.localization_only:
            self.tracker.new_kf_slots.clear()
            self.tracker.host_kf_slots.clear()
            return
        lc = self.loop_closer
        if lc is not None and lc.pending_gba is not None:
            self.map = lc.poll_gba(self.map)
        while self.tracker.host_kf_slots:
            kf = self.tracker.host_kf_slots.pop(0)
            if self.mapper is not None:
                self.map = self.mapper.process(self.map, kf)
            if lc is not None:
                self.map = lc.process(self.map, kf)
        while self.tracker.new_kf_slots:
            kf = self.tracker.new_kf_slots.pop(0)
            if lc is not None:
                self.map = lc.process(self.map, kf)
        self._maybe_compact()
        self.tracker.map = self.map

    def _maybe_compact(self):
        """Slot recycling: when an allocator nears capacity, renumber live
        slots into a dense prefix and remap every holder of old slot ids."""
        trk = self.tracker
        if trk.ctrl is None:
            return
        cfg = self.cfg
        points = trk.n_pt_watermark > 0.9 * cfg.max_points
        keyframes = trk.n_kf_watermark > 0.9 * cfg.max_keyframes
        if not (points or keyframes):
            return
        with metrics.span("system.compact"):
            if points:
                self.flush_gba()
                self.map, new_pt = ms.compact_points(self.map)
                lm_ = trk.ctrl.last_matched
                trk.ctrl = trk.ctrl._replace(
                    last_matched=torch.where(lm_ >= 0, new_pt[torch.clamp(lm_, min=0).long()],
                                             torch.full_like(lm_, -1)),
                    recent_start=int(self.map.n_pt))
                if self.mapper is not None:
                    self.mapper.recent_start = int(self.map.n_pt)
            if keyframes:
                self.flush_gba()
                self.map, new_kf = ms.compact_keyframes(self.map)
                trk.ctrl = trk.ctrl._replace(
                    ref_kf=max(int(new_kf[max(trk.ctrl.ref_kf, 0)]), 0))
                trk.ref_kf = max(int(new_kf[trk.ref_kf]), 0) if trk.ref_kf >= 0 else 0
                if self.loop_closer is not None:
                    self.loop_closer.remap_keyframes(new_kf.cpu().numpy())
        trk.n_pt_watermark = 0
        trk.n_kf_watermark = 0

    @metrics.traced("system.reset")
    def reset(self):
        """`System::Reset` / `Tracking::Reset` (`src/Tracking.cc:1777-1819`)."""
        cfg = self.cfg
        self.map = ms.empty_map(cfg.max_keyframes, cfg.max_points,
                                cfg.max_keypoints, self.device)
        trk = self.tracker
        trk.map = self.map
        trk.state = tracking.NO_IMAGES_YET
        trk.ctrl = None
        trk._trajectory.clear()
        trk.needs_reset = False
        trk.mb_vo = False
        trk.ts_epoch = None
        trk.n_pt_watermark = 0
        trk.n_kf_watermark = 0
        trk.n_kf = 0
        trk.last_frame = None
        trk.ba_lanes_dropped = 0
        trk.ba_escalations = 0
        trk.new_kf_slots.clear()
        trk.host_kf_slots.clear()
        trk._init_frame = None
        if self.mapper is not None:
            self.mapper.recent_start = None
            self.mapper.ba_lanes_dropped = self.mapper.ba_escalations = 0
        if self.loop_closer is not None:
            self.loop_closer.reset()

    @metrics.traced("system.flush_gba")
    def flush_gba(self):
        """Drain pending loop-closing work into the map: the detect -> Sim3
        chain (each stage is read one keyframe late, so two polls), then
        the whole pending global-BA job (the reference blocks on
        `isFinishedGBA` at shutdown, `src/System.cc:535-550`)."""
        lc = self.loop_closer
        if lc is not None:
            if not self.localization_only:
                self.map = lc.poll_detect(self.map)
                self.map = lc.poll_detect(self.map)
            self.map = lc.poll_gba(self.map, force=True)
            self.tracker.map = self.map

    def shutdown(self):
        self.flush_gba()

    # ------ mode switches (System.cc:433-456,492-533) ------
    def activate_localization_mode(self):
        self.localization_only = True
        self.tracker.disallow_kf = True
        if self.tracker.ctrl is not None:
            self.tracker.ctrl = self.tracker.ctrl._replace(allow_kf=False)

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.disallow_kf = False
        if self.tracker.ctrl is not None:
            self.tracker.ctrl = self.tracker.ctrl._replace(allow_kf=True)

    # ------ persistence (System.cc:552-574) ------
    def save_map(self, path: str | Path = "Slam_latest_Map.bin"):
        """Write the map (`io.mapio`) after draining the loop closer, with
        the BoW rows when a loop closer holds them."""
        self.flush_gba()
        lc = self.loop_closer
        mapio.save_map(path, self.map, ts_epoch=self.tracker.ts_epoch or 0.0,
                       bow_store=lc.bow_store if lc is not None else None,
                       voc_n_words=lc.voc.n_words if lc is not None else None)

    def load_map(self, path: str | Path):
        """Replace the map with a saved one (`System::LoadMap`) and continue
        LOST in localization-only mode, relocalizing against it."""
        self.map = mapio.load_map(path, self.device)
        self.tracker.ts_epoch = mapio.read_ts_epoch(path)
        self.tracker.map = self.map
        self._restore_bow(path)
        self.tracker.state = tracking.LOST
        self.localization_only = True
        self.tracker.disallow_kf = True
        if self.tracker.ctrl is not None:
            self.tracker.ctrl = self.tracker.ctrl._replace(
                mode=fused_step.MODE_LOST, allow_kf=False, has_velocity=False)

    # ------ trajectory export (System.cc:675-836) ------
    def save_camera_trajectory(self, path: str | Path):
        tr = self.tracker.trajectory
        traj_io.save_camera_trajectory(
            path, [t for t, _, _ in tr], [p for _, p, _ in tr],
            lost=[l for _, _, l in tr])

    def keyframe_trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (K,) f64 absolute, poses Tcw (K,4,4)) of the valid
        keyframes; device stamps are f32 offsets from the run's epoch."""
        valid = self.map.kf_valid.cpu().numpy()
        epoch = self.tracker.ts_epoch or 0.0
        ts = self.map.kf_timestamp.cpu().numpy().astype(np.float64)[valid] + epoch
        return ts, self.map.kf_pose.cpu().numpy()[valid]

    def save_keyframe_trajectory(self, path: str | Path):
        self.flush_gba()
        ts, poses = self.keyframe_trajectory()
        traj_io.save_keyframe_trajectory(path, ts, poses)

    def save_localization_trajectory(self, path: str | Path):
        tr = self.tracker.trajectory
        traj_io.save_matrix_trajectory(path, [p for _, p, l in tr if not l])

    def save_stereo_keyframe_trajectory(self, path: str | Path):
        """`System::SaveStereoKeyFrameTrajectory` (`src/System.cc:789-836`):
        per-FRAME 3x4 [Rwc|twc] rows (the reference walks the frame lists
        despite the name), with the first keyframe at the origin."""
        self.flush_gba()
        valid = self.map.kf_valid.cpu().numpy()
        Two = (np.linalg.inv(self.map.kf_pose[int(np.nonzero(valid)[0][0])].cpu().numpy())
               if valid.any() else np.eye(4))
        traj_io.save_matrix_trajectory(path, [p @ Two for _, p, _ in self.tracker.trajectory])

    def change_calibration(self, settings_path: str | Path):
        """`Tracking::ChangeCalibration` (`src/Tracking.cc:1821-1852`):
        re-read camera intrinsics/distortion/baseline from a settings yaml
        and rebuild what holds the old camera, as the JAX version does
        (`system.py:404-449`): the `Camera`, the `FrameBuilder` (its bounds
        and tables), the tracker's camera, intrinsic matrix, `th_depth`,
        tracking kernels and per-frame step, and the `LocalMapper`. The
        relocalizer and the loop closer keep the camera they were built
        with, as in the JAX version."""
        cfg = config_mod.load_camera_settings(settings_path, self.cfg)
        self.cfg = cfg
        c = cfg.camera
        self.cam = projection.Camera.create(
            c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2, c.k3,
            bf=c.bf, width=c.width, height=c.height)
        self.builder = frame_mod.FrameBuilder(self.cam, self.spec, self.device)
        trk = self.tracker
        trk.cfg.th_depth = float(c.bf) / float(c.fx) * float(c.th_depth)
        trk.cam = self.cam
        trk.K = torch.tensor([[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy], [0.0, 0.0, 1.0]],
                             dtype=torch.float32, device=self.device)
        trk.builder = self.builder
        if self.mapper is not None:
            self.mapper = local_mapping.LocalMapper(
                self.cam, self.builder.inv_level_sigma2,
                is_mono=(self.sensor == Sensor.MONOCULAR),
                scale_factors=self.builder.scale_factors,
                n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor)
        trk.k = tracking.make_tracking_kernels(
            self.cam, self.builder, cfg.orb.n_levels, cfg.orb.scale_factor)
        trk.step = fused_step.make_fused_step(
            self.cam, self.builder, cfg.orb.n_levels, cfg.orb.scale_factor,
            trk.cfg, self.mapper)

    # ------ introspection (System.h:144-160 analogues) ------
    @property
    def n_keyframes(self) -> int:
        return int(torch.sum(self.map.kf_valid.to(torch.int32)))

    @property
    def n_points(self) -> int:
        return int(torch.sum(self.map.pt_valid.to(torch.int32)))

    @property
    def tracking_state(self) -> int:
        return self.tracker.state
