"""Pinhole camera projection / undistortion on torch tensors.

Port of `orbslam_mapsave_tpu/geometry/projection.py`: keypoint
undistortion (`Frame::UndistortKeyPoints`), projection, RGB-D
unprojection (`Frame::UnprojectStereo`) and the undistorted image bounds
(`Frame::ComputeImageBounds`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Intrinsics + distortion as Python floats, mirroring the camera YAML
    keys (`Examples/ORB_RGBD640x480.yaml:7-46`)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    bf: float  # baseline * fx (stereo/RGB-D); 0 for pure mono
    width: int = 640
    height: int = 480

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
               width=640, height=480) -> "Camera":
        f = float
        return Camera(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1), f(p2),
                      f(k3), f(bf), int(width), int(height))

    @property
    def K(self) -> np.ndarray:
        return np.array([
            [self.fx, 0.0, self.cx],
            [0.0, self.fy, self.cy],
            [0.0, 0.0, 1.0],
        ], np.float32)


def undistort_points(cam: Camera, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Undistort pixel keypoints (...,2) -> undistorted pixel coords (...,2)
    by the fixed-point iteration inside cv::undistortPoints."""
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], dim=-1)


def _zsafe(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, pts_cam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame 3D points (...,3) -> (pixel uv (...,2), depth (...,)),
    without distortion (matching runs against undistorted keypoints)."""
    z = pts_cam[..., 2]
    zsafe = _zsafe(z)
    u = cam.fx * pts_cam[..., 0] / zsafe + cam.cx
    v = cam.fy * pts_cam[..., 1] / zsafe + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(cam: Camera, pts_cam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Like project, plus the right-image u coordinate (u - bf/z)."""
    uv, z = project(cam, pts_cam)
    ur = uv[..., 0] - cam.bf / _zsafe(z)
    return torch.cat([uv, ur[..., None]], dim=-1), z


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels (...,2) + depth (...,) -> camera-frame 3D (...,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def compute_image_bounds(cam: Camera) -> np.ndarray:
    """Undistorted image bounds [min_x, max_x, min_y, max_y] (float32 numpy),
    computed on the host like `Frame::ComputeImageBounds`
    (`src/Frame.cc:542-572`): undistort the four corners, take min/max."""
    corners = np.array(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height],
         [cam.width, cam.height]], np.float64,
    )
    x0 = (corners[:, 0] - cam.cx) / cam.fx
    y0 = (corners[:, 1] - cam.cy) / cam.fy
    x, y = x0.copy(), y0.copy()
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    u = x * cam.fx + cam.cx
    v = y * cam.fy + cam.cy
    return np.array(
        [min(u[0], u[2]), max(u[1], u[3]), min(v[0], v[1]), max(v[2], v[3])],
        np.float32,
    )
