"""Viewer — the reference's Pangolin GUI loop rebuilt as a headless recorder.

`Viewer` parity (`src/Viewer.cc`, SURVEY.md §2.1): the reference runs a GUI
thread with menu buttons "Save Map" / "Save CamTrj" / "Reset" / "Shut Down"
and a "Localization Mode" toggle (`Viewer.cc:82-114,266-277,476-513`). A
headless run has no display, so the Viewer is (a) the same control surface
as methods, and (b) a periodic snapshot recorder writing frame overlays +
map views to a directory (usable as a video scratch or CI artifact).

Port of `orbslam_mapsave_tpu/viz/viewer.py`. The live HTML rewrite counts
keyframes with the tracker's host-side count (`Tracker.n_kf`, read from
each frame's step outcome) where the JAX version reads the device every
frame; the pages it writes are the same.

Viewer config keys (`Viewer.*`, `Examples/ORB_RGBD640x480.yaml:75-91`) are
honored where meaningful (trj_history controls the trajectory overlay tail).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import ViewerConfig
from . import frame_drawer, html_viewer, map_drawer


def _host(x) -> np.ndarray | None:
    if x is None:
        return None
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Viewer:
    def __init__(self, system, cfg: ViewerConfig | None = None,
                 out_dir: str | Path = "viewer_out", every_n: int = 10,
                 live_html: str | Path | None = None,
                 live_every_kfs: int = 2, live_refresh: float = 2.0):
        self.system = system
        self.cfg = cfg or ViewerConfig()
        self.out_dir = Path(out_dir)
        self.every_n = every_n
        self._count = 0
        self._stopped = False
        # live map window: rewrite an auto-refreshing HTML view every
        # `live_every_kfs` new keyframes; a browser pointed at the file
        # approximates the reference's live Pangolin map
        # (`src/Viewer.cc:70-513`). Costs one map fetch per rewrite.
        self.live_html = Path(live_html) if live_html else None
        self.live_every_kfs = live_every_kfs
        self.live_refresh = live_refresh
        self._live_last_kfs = 0
        self._live_gen = 0

    # --- the frame hook (Viewer::Run body equivalent) ---
    def update(self, gray: np.ndarray, frame, pose_cw) -> None:
        if self._stopped:
            return
        self._count += 1
        if self.live_html is not None:
            n_kf = self.system.tracker.n_kf
            if n_kf >= self._live_last_kfs + self.live_every_kfs:
                self._live_gen += 1
                self._live_last_kfs = n_kf
                html_viewer.export_html(
                    self.system.map, self.live_html, current_pose_cw=_host(pose_cw),
                    live_refresh=self.live_refresh, gen=self._live_gen)
        if self._count % self.every_n:
            return
        self.out_dir.mkdir(parents=True, exist_ok=True)
        img = frame_drawer.draw_frame(
            np.asarray(gray),
            _host(frame.kp_xy),
            _host(frame.valid),
            state=self.system.tracking_state,
            n_kfs=self.system.n_keyframes,
            n_points=self.system.n_points,
        )
        from PIL import Image

        Image.fromarray(img).save(self.out_dir / f"frame_{self._count:06d}.png")
        map_drawer.save_map_png(
            self.system.map, str(self.out_dir / f"map_{self._count:06d}.png"),
            current_pose_cw=_host(pose_cw))

    # --- menu buttons (Viewer.cc:476-513) ---
    def save_map(self):  # "Save Map" (Viewer.cc:491-495)
        self.system.save_map()

    def save_trajectory(self, path="CameraTrajectory.txt"):  # :503-507
        self.system.save_camera_trajectory(path)

    def reset(self):  # :476-488
        self.system.reset()

    def shutdown(self):  # "Shut Down" (Viewer.cc:509-513)
        self._stopped = True
        self.system.shutdown()

    def export_html(self, path="map_view.html"):
        """Interactive 3D map view as a self-contained HTML file — the
        orbit/zoom/pan equivalent of the Pangolin window
        (`src/Viewer.cc:70-513`) for display-less runs."""
        return html_viewer.export_html(
            self.system.map, path, trajectory=tracked_twc(self.system.tracker.trajectory))

    def set_localization_mode(self, on: bool):  # :266-277
        if on:
            self.system.activate_localization_mode()
        else:
            self.system.deactivate_localization_mode()


def tracked_twc(trajectory) -> np.ndarray | None:
    """(T,4,4) camera->world poses of the tracked frames of a tracker's
    (timestamp, Tcw, lost) trajectory, or None when none was tracked."""
    traj = [np.linalg.inv(p) for _, p, lost in trajectory if not lost]
    return np.asarray(traj) if traj else None
