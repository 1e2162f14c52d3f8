"""Human skeleton tracking — `OpDetector` parity (`src/DetectHumanPose.cpp`).

Port of `orbslam_mapsave_tpu/apps/human_pose.py`: numpy on the host, as
there; the backbone it calls is the port's `models.pose_net`.

The fork's "Mobile Gait System" runs OpenPose BODY_25 on each frame, smooths
joints with per-joint Kalman filters, lifts 2D joints to 3D using the depth
map, produces a human MASK consumed by masked ORB extraction
(`mlHumanMask` `DetectHumanPose.cpp:299-301` -> `src/Tracking.cc:373-384`),
and computes gait angles for the viewer (SURVEY.md §2.1).

The project carries no OpenPose model or weights, so the
detector backbone is pluggable: any callable image -> (25,3) [x,y,conf]
keypoints (a trained pose model, or a synthetic oracle in tests). Everything
downstream is implemented:
- per-joint constant-velocity Kalman filters (`KFupdate`,
  `DetectHumanPose.cpp:750-900`; noise params from `Openpose_params.yml`
  KF.wk/vk/pk);
- 2D->3D lifting from depth (`Skeleton2Dto3D`, `:424-520`);
- link-length consistency gating;
- human mask rendering for ORB masking;
- gait angles (knee/hip flexion from 3D joints, used by the Viewer's
  readouts).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# BODY_25 joint indices (OpenPose convention)
JOINTS = [
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist", "LShoulder", "LElbow",
    "LWrist", "MidHip", "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "REye", "LEye", "REar", "LEar", "LBigToe", "LSmallToe", "LHeel",
    "RBigToe", "RSmallToe", "RHeel",
]
N_JOINTS = 25
HIP_C = 8  # MidHip — the joint driving the UDP robot (UDP2robot.h:54)

LINKS = [
    (1, 0), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 8),
    (8, 9), (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (11, 24),
    (14, 21), (21, 19), (24, 22),
]


@dataclasses.dataclass
class KFParams:
    """`KF.wk/vk/pk` from Openpose_params.yml (process/measurement/initial)."""

    wk: float = 1e-3
    vk: float = 1e-2
    pk: float = 1.0


class JointKalman:
    """Constant-velocity Kalman filter per joint (x,y + velocities), the
    `cv::KalmanFilter` setup of `KFupdate` (`DetectHumanPose.cpp:750-826`)."""

    def __init__(self, params: KFParams):
        self.p = params
        self.x = np.zeros(4)  # [x, y, vx, vy]
        self.P = np.eye(4) * params.pk
        self.initialized = False

    def update(self, z: np.ndarray, conf: float, dt: float = 1.0) -> np.ndarray:
        F = np.eye(4)
        F[0, 2] = F[1, 3] = dt
        Q = np.eye(4) * self.p.wk
        H = np.zeros((2, 4))
        H[0, 0] = H[1, 1] = 1.0
        R = np.eye(2) * (self.p.vk / max(conf, 1e-3))
        if not self.initialized:
            if conf > 0.05:
                self.x[:2] = z
                self.initialized = True
            return self.x[:2].copy()
        # predict
        self.x = F @ self.x
        self.P = F @ self.P @ F.T + Q
        if conf > 0.05:
            # update
            S = H @ self.P @ H.T + R
            K = self.P @ H.T @ np.linalg.inv(S)
            self.x = self.x + K @ (z - H @ self.x)
            self.P = (np.eye(4) - K @ H) @ self.P
        return self.x[:2].copy()


class OpDetector:
    """Host-side skeleton tracker; `run_frame` is the per-frame body of
    `OpDetector::Run` (`DetectHumanPose.cpp:145-330`)."""

    def __init__(self, backbone=None, kf_params: KFParams | None = None,
                 fx: float = 525.0, fy: float = 525.0, cx: float = 319.5,
                 cy: float = 239.5, mask_radius: int = 25):
        self.backbone = backbone  # image -> (25,3) [x,y,conf] or None
        self.kf = [JointKalman(kf_params or KFParams()) for _ in range(N_JOINTS)]
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.mask_radius = mask_radius
        self.joints_2d = np.zeros((N_JOINTS, 2))
        self.joints_conf = np.zeros(N_JOINTS)
        self.joints_3d = np.zeros((N_JOINTS, 3))
        self.skeleton_log: list[np.ndarray] = []  # for Save-Skeleton export

    @classmethod
    def with_pretrained(cls, weights_path=None, device="cuda", **kw) -> "OpDetector":
        """Detector backed by a trained heatmap net saved with
        `pose_net.save_params` (default `models/weights/pose_net_96.npz`),
        run on `device` — the analogue of the reference constructing
        OpenPose from its configured model folder
        (`DetectHumanPose.cpp:14-131`). Falls back to backbone=None if the
        file is absent."""
        from ..models import pose_net

        return cls(backbone=pose_net.make_pretrained_backbone(weights_path, device),
                   **kw)

    @property
    def available(self) -> bool:
        return self.backbone is not None

    def run_frame(self, gray: np.ndarray, depth: np.ndarray | None
                  ) -> np.ndarray | None:
        """Detect + smooth + lift; returns the human mask (H,W float 0/1,
        0 = human region, matching the reference's multiply-mask sense) or
        None when no backbone/person."""
        if self.backbone is None:
            return None
        kps = np.asarray(self.backbone(gray))  # (25,3)
        if kps.shape != (N_JOINTS, 3) or (kps[:, 2] > 0.05).sum() < 3:
            return None
        self.joints_conf = kps[:, 2]
        for j in range(N_JOINTS):
            self.joints_2d[j] = self.kf[j].update(kps[j, :2], kps[j, 2])
        if depth is not None:
            self.joints_3d = self.skeleton_2d_to_3d(self.joints_2d, depth)
        self.skeleton_log.append(
            np.concatenate([self.joints_3d.ravel(), self.joints_conf])
        )
        return self.render_mask(gray.shape)

    def skeleton_2d_to_3d(self, joints: np.ndarray, depth: np.ndarray
                          ) -> np.ndarray:
        """`Skeleton2Dto3D` (`DetectHumanPose.cpp:424-520`): median depth in
        a window around each joint, back-projected; link-length check drops
        implausible depths."""
        h, w = depth.shape
        out = np.zeros((N_JOINTS, 3))
        r = 3
        for j in range(N_JOINTS):
            x, y = int(joints[j, 0]), int(joints[j, 1])
            if not (r <= x < w - r and r <= y < h - r) or self.joints_conf[j] <= 0.05:
                continue
            win = depth[y - r : y + r + 1, x - r : x + r + 1]
            vals = win[win > 0]
            if len(vals) == 0:
                continue
            z = float(np.median(vals))
            out[j] = [(x - self.cx) / self.fx * z, (y - self.cy) / self.fy * z, z]
        # link-length consistency: zero out joints creating >2m links
        for a, b in LINKS:
            if out[a, 2] > 0 and out[b, 2] > 0:
                if np.linalg.norm(out[a] - out[b]) > 2.0:
                    out[b] = 0.0
        return out

    def render_mask(self, shape) -> np.ndarray:
        """Mask = 0 inside dilated skeleton regions, 1 elsewhere (the
        reference multiplies the input image by the mask,
        `ORBextractor.cc:1048-1053`)."""
        h, w = shape
        mask = np.ones((h, w), np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        for j in range(N_JOINTS):
            if self.joints_conf[j] <= 0.05:
                continue
            x, y = self.joints_2d[j]
            d2 = (xx - x) ** 2 + (yy - y) ** 2
            mask[d2 <= self.mask_radius**2] = 0.0
        return mask

    # --- gait angles for the Viewer readouts (DetectHumanPose.cpp Run) ---
    def gait_angles(self) -> dict[str, float]:
        def angle(a, b, c):
            v1 = self.joints_3d[a] - self.joints_3d[b]
            v2 = self.joints_3d[c] - self.joints_3d[b]
            n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
            if n1 < 1e-6 or n2 < 1e-6:
                return 0.0
            return float(np.degrees(np.arccos(np.clip(v1 @ v2 / (n1 * n2), -1, 1))))

        return {
            "r_knee": angle(9, 10, 11),
            "l_knee": angle(12, 13, 14),
            "r_hip": angle(1, 9, 10),
            "l_hip": angle(1, 12, 13),
        }

    def save_skeleton(self, path: str) -> None:
        """Skeleton trajectory export (`System::SaveSkeletonTrajectory`
        analogue, `src/System.cc:576-665`)."""
        np.savetxt(path, np.asarray(self.skeleton_log), fmt="%.6f")
