"""Unified YAML config cascade.

Mirrors the reference's three-level cv::FileStorage config system
(SURVEY.md §5.6):

1. master `Setting.yaml` (`Examples/Setting.yaml:1-59`, parsed by the example
   mains, e.g. `Examples/Monocular.cc:35-52`) — input source, vocabulary path,
   camera-settings path, viewer/reuse-map/human/aruco switches;
2. camera/system YAML (`Examples/ORB_RGBD640x480.yaml`) — intrinsics,
   distortion, fps, baseline, depth thresholds, ORB params, viewer params,
   UDP robot params, aruco params (parsed in `Tracking::Tracking`,
   `src/Tracking.cc:127-241`);
3. subsystem YAMLs (`Openpose_params.yml`, `detector_params.yml`).

The reference files are OpenCV-YAML (`%YAML:1.0` header, `Key.SubKey: value`
flat namespacing). `load_opencv_yaml` reads them directly so reference setting
files drop in unmodified. Dataclasses carry defaults equal to the reference's
(`ORB_RGBD640x480.yaml`, `src/Tracking.cc:127-241`).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


def load_opencv_yaml(path: str | Path) -> dict[str, Any]:
    """Parse an OpenCV-style YAML file into a flat dict.

    Handles the `%YAML:1.0` directive, comments, scalar keys like
    `Camera.fx: 619.8`, and quoted strings. This covers every construct used
    by the reference's setting files; cv2.FileStorage is deliberately NOT used
    so config parsing has no OpenCV dependency.
    """
    out: dict[str, Any] = {}
    if not Path(path).exists():
        # the reference prints "Failed to open settings file" and exits
        # (`src/System.cc:115-120`)
        raise ValueError(
            f"Failed to open settings file at: {path} — check the "
            "--camera-yaml / Setting.yaml path"
        )
    text = Path(path).read_text()
    for line in text.splitlines():
        line = line.split("#", 1)[0].rstrip()
        if not line or line.lstrip().startswith("%"):
            continue
        m = re.match(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(.*)$", line)
        if not m:
            continue
        key, raw = m.group(1), m.group(2).strip()
        if not raw:
            continue
        if raw.startswith('"') and raw.endswith('"'):
            out[key] = raw[1:-1]
            continue
        try:
            out[key] = int(raw)
        except ValueError:
            try:
                out[key] = float(raw)
            except ValueError:
                out[key] = raw
    return out


@dataclass
class CameraConfig:
    """`Camera.*` + depth keys (`Examples/ORB_RGBD640x480.yaml:7-52`)."""

    fx: float = 929.764
    fy: float = 930.318
    cx: float = 645.600
    cy: float = 358.178
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 1280
    height: int = 720
    fps: float = 30.0
    bf: float = 33.0  # baseline * fx
    rgb: int = 1  # color order: 0 BGR, 1 RGB
    th_depth: float = 50.0  # close/far threshold, in baselines (`ThDepth`)
    depth_map_factor: float = 1000.0  # `DepthMapFactor`


@dataclass
class ORBConfig:
    """`ORBextractor.*` (`Examples/ORB_RGBD640x480.yaml:58-71`)."""

    n_features: int = 2000
    scale_factor: float = 1.5
    n_levels: int = 4
    ini_th_fast: int = 15
    min_th_fast: int = 3


@dataclass
class ViewerConfig:
    """`Viewer.*` (`Examples/ORB_RGBD640x480.yaml:75-91`)."""

    keyframe_size: float = 0.05
    keyframe_line_width: float = 1.0
    graph_line_width: float = 0.9
    point_size: float = 5.0
    camera_size: float = 0.1
    camera_line_width: float = 4.0
    viewpoint_x: float = -2.5
    viewpoint_y: float = -2.5
    viewpoint_z: float = -2.5
    viewpoint_f: float = 1000.0
    trj_history: int = 10
    window_size_x: float = 1080.0
    window_size_y: float = 1920.0


@dataclass
class UDPConfig:
    """UDP robot-control params (`Examples/ORB_RGBD640x480.yaml:95-109`)."""

    send_interval_ms: int = 100
    receiver_interval_ms: int = 200
    buf_size: int = 128
    port_in: int = 8008
    port_out: int = 8888
    ip_client: str = "127.0.0.1"
    timeout_max: int = 10
    robot_mode: int = 0
    angle_thres_deg: float = 10.0
    dist_thres_min_m: float = 1.0
    dist_thres_max_m: float = 2.0


@dataclass
class ArucoConfig:
    """`Aruco.*` (`Examples/ORB_RGBD640x480.yaml:112-116`)."""

    dictionary_id: int = 0
    estimate_pose: int = 1
    marker_length: float = 0.053


@dataclass
class SystemConfig:
    """Master settings (`Examples/Setting.yaml:1-59`) + nested sections."""

    video_source: str = ""
    vocabulary_path: str = ""
    cam_setting_path: str = ""
    use_viewer: bool = False
    reuse_map: bool = False
    reuse_map_path: str = ""
    load_image_path: str = ""
    detect_human: bool = False
    openpose_params_path: str = ""
    detect_marker: bool = False
    aruco_params_path: str = ""
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    viewer: ViewerConfig = field(default_factory=ViewerConfig)
    udp: UDPConfig = field(default_factory=UDPConfig)
    aruco: ArucoConfig = field(default_factory=ArucoConfig)

    # TPU-framework additions (no reference equivalent): static capacities
    # for the fixed-shape map state and mesh layout.
    max_keypoints: int = 2048  # padded per-frame feature capacity (>= n_features)
    max_keyframes: int = 512
    max_points: int = 65536
    mesh_shape: tuple = ()  # e.g. {"kf": 4} for sharded BA; empty = single chip


_CAM_KEYMAP = {
    "Camera.fx": "fx", "Camera.fy": "fy", "Camera.cx": "cx", "Camera.cy": "cy",
    "Camera.k1": "k1", "Camera.k2": "k2", "Camera.p1": "p1", "Camera.p2": "p2",
    "Camera.k3": "k3", "Camera.width": "width", "Camera.height": "height",
    "Camera.fps": "fps", "Camera.bf": "bf", "Camera.RGB": "rgb",
    "ThDepth": "th_depth", "DepthMapFactor": "depth_map_factor",
}
_ORB_KEYMAP = {
    "ORBextractor.nFeatures": "n_features",
    "ORBextractor.scaleFactor": "scale_factor",
    "ORBextractor.nLevels": "n_levels",
    "ORBextractor.iniThFAST": "ini_th_fast",
    "ORBextractor.minThFAST": "min_th_fast",
}
_VIEWER_KEYMAP = {
    "Viewer.KeyFrameSize": "keyframe_size",
    "Viewer.KeyFrameLineWidth": "keyframe_line_width",
    "Viewer.GraphLineWidth": "graph_line_width",
    "Viewer.PointSize": "point_size",
    "Viewer.CameraSize": "camera_size",
    "Viewer.CameraLineWidth": "camera_line_width",
    "Viewer.ViewpointX": "viewpoint_x",
    "Viewer.ViewpointY": "viewpoint_y",
    "Viewer.ViewpointZ": "viewpoint_z",
    "Viewer.ViewpointF": "viewpoint_f",
    "Viewer.TrjHistory": "trj_history",
    "Viewer.WindowSizeX": "window_size_x",
    "Viewer.WindowSizeY": "window_size_y",
}
_UDP_KEYMAP = {
    "Send_inverval": "send_interval_ms",  # [sic] typo preserved from reference
    "Receiver_interval": "receiver_interval_ms",
    "Buf_size": "buf_size",
    "Port_in": "port_in",
    "Port_out": "port_out",
    "IP_client": "ip_client",
    "timeout_max": "timeout_max",
    "Robot_mode": "robot_mode",
    "AngleThres": "angle_thres_deg",
    "DistThresMin": "dist_thres_min_m",
    "DistThresMax": "dist_thres_max_m",
}
_ARUCO_KEYMAP = {
    "Aruco.dictionaryId": "dictionary_id",
    "Aruco.estimatePose": "estimate_pose",
    "Aruco.markerLength": "marker_length",
}


def _apply(obj, keymap: dict[str, str], raw: dict[str, Any]):
    fields = {f.name: f.type for f in dataclasses.fields(obj)}
    for yaml_key, attr in keymap.items():
        if yaml_key in raw:
            v = raw[yaml_key]
            cur = getattr(obj, attr)
            if isinstance(cur, int) and not isinstance(cur, bool):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            setattr(obj, attr, v)
    del fields
    return obj


def load_camera_settings(path: str | Path, cfg: SystemConfig | None = None) -> SystemConfig:
    """Load a camera/system YAML (level 2) into a SystemConfig."""
    cfg = cfg or SystemConfig()
    raw = load_opencv_yaml(path)
    _apply(cfg.camera, _CAM_KEYMAP, raw)
    _apply(cfg.orb, _ORB_KEYMAP, raw)
    _apply(cfg.viewer, _VIEWER_KEYMAP, raw)
    _apply(cfg.udp, _UDP_KEYMAP, raw)
    _apply(cfg.aruco, _ARUCO_KEYMAP, raw)
    if cfg.camera.depth_map_factor != 0:
        pass  # inversion (1/factor) happens at use site, like Tracking.cc:238-241
    return cfg


def load_master_settings(path: str | Path) -> SystemConfig:
    """Load a master Setting.yaml (level 1), then its camera YAML if present."""
    raw = load_opencv_yaml(path)
    cfg = SystemConfig(
        video_source=str(raw.get("Video_source", "")),
        vocabulary_path=str(raw.get("Orb_Vocabulary", "")),
        cam_setting_path=str(raw.get("Cam_Setting", "")),
        use_viewer=bool(raw.get("is_UseViewer", 0)),
        reuse_map=bool(raw.get("is_ReuseMap", 0)),
        reuse_map_path=str(raw.get("ReuseMap", "")),
        load_image_path=str(raw.get("LoadImagePath", "")),
        detect_human=bool(raw.get("is_DetectHuman", 0)),
        openpose_params_path=str(raw.get("Openpose_Parameters", "")),
        detect_marker=bool(raw.get("is_DetectMarker", 0)),
        aruco_params_path=str(raw.get("Aruco_Parameters", "")),
    )
    cam_path = Path(cfg.cam_setting_path)
    if cam_path.is_file():
        load_camera_settings(cam_path, cfg)
    return cfg
