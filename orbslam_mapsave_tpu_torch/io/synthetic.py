"""Synthetic RGB-D scene generator for tests and benchmarks.

The build environment has no TUM/KITTI data and no ORB vocabulary (the
reference's `Vocabulary/ORBvoc.txt.tar.gz` is a missing large blob), so the
test strategy from SURVEY.md §4 is grounded in a synthetic renderer with exact
ground truth:

- A textured "box room": the camera moves inside an axis-aligned cube whose
  inner faces carry band-limited noise textures. Each frame is rendered by
  ray-casting every pixel to the nearest face (fully vectorized numpy),
  giving a grayscale image + exact depth map + exact pose.
- `write_tum_sequence` serializes a rendered trajectory into an on-disk TUM
  rgb/depth/groundtruth directory so the real `TUMDataset` loader and the
  trajectory/ATE tooling are exercised end-to-end.

This replaces nothing in the reference (it has no tests, SURVEY.md §4); it is
the fixture layer for ours.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _smooth_noise_texture(rng: np.random.Generator, size: int, octaves: int = 4) -> np.ndarray:
    """Band-limited value-noise texture in [0,255] with multi-scale detail
    (plenty of FAST corners at every pyramid level).

    Three constraints make the texture trackable like a real scene:
    - SMOOTH broadband value noise (distinct local patterns): regular
      high-contrast cells are locally self-similar, so window searches
      lock onto matches one cell over and the pose diverges exponentially
      (measured: terr doubling per frame once the velocity model overshoots
      half a cell);
    - the finest octave spans >= size/256 texels (~4px at typical viewing
      distance): sub-texel noise aliases under perspective resampling and
      descriptors decorrelate between frames;
    - a contrast stretch at the end: BRIEF compares pixel pairs, and
      low-amplitude texture leaves pairs within a gray level of each other,
      so descriptor bits flip under u8 sensor quantization.
    """
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for o in range(octaves):
        n = min(size // 4, max(2, 32 << o))
        coarse = rng.uniform(0, 1, (n, n)).astype(np.float32)
        # bilinear upsample to full size
        yi = np.linspace(0, n - 1, size)
        xi = np.linspace(0, n - 1, size)
        y0 = np.clip(yi.astype(int), 0, n - 2)
        x0 = np.clip(xi.astype(int), 0, n - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (
            coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        tex += amp * up
        amp *= 0.55
    tex -= tex.min()
    tex /= tex.max()
    # contrast stretch (see docstring): sigmoid around the median pushes
    # BRIEF pair differences past the u8 quantization floor while keeping
    # the broadband (non-repetitive) structure
    tex = 0.5 + 0.5 * np.tanh(4.0 * (tex - np.median(tex)))
    tex -= tex.min()
    tex /= tex.max()
    return (tex * 255.0).astype(np.float32)


class BoxRoom:
    """Axis-aligned cube [-h,h]^3 with per-face textures; camera inside."""

    def __init__(self, half_size: float = 2.0, tex_size: int = 1024, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.h = float(half_size)
        self.textures = [_smooth_noise_texture(rng, tex_size) for _ in range(6)]
        self.tex_size = tex_size

    def render(self, K: np.ndarray, Twc: np.ndarray, width: int, height: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Render (gray (H,W) float32 [0,255], depth (H,W) float32 meters)."""
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                           np.arange(height, dtype=np.float64))
        dirs_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
        R = Twc[:3, :3]
        o = Twc[:3, 3]
        dirs = dirs_cam @ R.T  # world-frame ray directions
        h = self.h
        best_t = np.full((height, width), np.inf)
        gray = np.zeros((height, width), np.float32)
        # 6 faces: (axis, sign). Face plane: x_axis = sign*h.
        for face, (axis, sign) in enumerate(
            [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]
        ):
            d = dirs[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (sign * h - o[axis]) / d
            hit = (t > 1e-6) & np.isfinite(t)
            t = np.where(hit, t, 1.0)
            p = o[None, None, :] + t[..., None] * dirs
            other = [a for a in range(3) if a != axis]
            inside = (
                (np.abs(p[..., other[0]]) <= h) & (np.abs(p[..., other[1]]) <= h)
            )
            valid = hit & inside & (t < best_t)
            if not valid.any():
                continue
            # texture lookup (bilinear) on the two in-plane coords
            a = (p[..., other[0]] / (2 * h) + 0.5) * (self.tex_size - 1)
            b = (p[..., other[1]] / (2 * h) + 0.5) * (self.tex_size - 1)
            a = np.clip(a, 0, self.tex_size - 1.001)
            b = np.clip(b, 0, self.tex_size - 1.001)
            a0, b0 = a.astype(int), b.astype(int)
            fa, fb = a - a0, b - b0
            tex = self.textures[face]
            val = (
                tex[b0, a0] * (1 - fa) * (1 - fb)
                + tex[b0, np.minimum(a0 + 1, self.tex_size - 1)] * fa * (1 - fb)
                + tex[np.minimum(b0 + 1, self.tex_size - 1), a0] * (1 - fa) * fb
                + tex[np.minimum(b0 + 1, self.tex_size - 1),
                      np.minimum(a0 + 1, self.tex_size - 1)] * fa * fb
            )
            gray = np.where(valid, val.astype(np.float32), gray)
            best_t = np.where(valid, t, best_t)
        depth = (best_t * dirs_cam[..., 2]).astype(np.float32)  # z-depth
        depth[~np.isfinite(depth)] = 0.0
        return gray, depth


def orbit_trajectory(n_frames: int, radius: float = 0.5, height: float = 0.0,
                     yaw_range: float = 0.6, half_size: float = 2.0,
                     forward: float = 0.12) -> np.ndarray:
    """Smooth Twc trajectory inside the box: lateral arc + slow yaw.

    Returns (N,4,4) camera->world poses looking roughly at the +z face.
    `forward` bounds the approach toward the viewed face: large approach +
    yaw walks the view off the initial footprint faster than a 40-frame
    no-loop-closure run can refresh its map.
    """
    poses = np.zeros((n_frames, 4, 4))
    s = np.linspace(0, 1, n_frames)
    for i, si in enumerate(s):
        yaw = (si - 0.5) * yaw_range
        cx = radius * np.sin(2 * np.pi * si * 0.5)
        cyy = height + 0.1 * np.sin(2 * np.pi * si)
        cz = -forward * np.cos(2 * np.pi * si * 0.5)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [cx, cyy, cz]
        poses[i] = T
    return poses


def circle_trajectory(n_frames: int, radius: float = 0.55,
                      revs: float = 1.05, height_bob: float = 0.05,
                      ) -> np.ndarray:
    """Camera on a circle looking radially outward, completing `revs`
    revolutions — the canonical loop-closure fixture: after 360° the view
    re-observes the start with whatever drift the front-end accumulated.

    Returns (N,4,4) camera->world poses.
    """
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        th = 2 * np.pi * revs * i / n_frames
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # cam z -> outward
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [radius * s, height_bob * np.sin(4 * th), radius * c]
        poses[i] = T
    return poses


def write_tum_sequence(out_dir: str | Path, K: np.ndarray, poses_wc: np.ndarray,
                       width: int = 640, height: int = 480, fps: float = 30.0,
                       depth_factor: float = 5000.0, seed: int = 0,
                       half_size: float = 2.0, t0: float = 1000.0,
                       depth_scale_fn=None) -> Path:
    """Render a BoxRoom trajectory to a TUM-format directory.

    Writes rgb/, depth/, rgb.txt, depth.txt, groundtruth.txt. Ground-truth
    lines are TUM format (t tx ty tz qx qy qz qw) with camera->world poses.

    depth_scale_fn(i) -> float, if given, multiplies frame i's depth map —
    a controlled sensor-miscalibration injector: a slowly varying scale
    error makes RGB-D odometry accumulate REAL drift that only loop closure
    can remove (used by the loop-closing e2e tests).
    """
    from PIL import Image

    from .trajectory import rot_to_quat_np

    out = Path(out_dir)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)
    room = BoxRoom(half_size=half_size, seed=seed)
    rgb_lines, depth_lines, gt_lines = ["# synthetic"], ["# synthetic"], ["# synthetic"]
    for i, Twc in enumerate(poses_wc):
        t = t0 + i / fps
        gray, depth = room.render(K, Twc, width, height)
        rgb_name = f"rgb/{t:.6f}.png"
        depth_name = f"depth/{t:.6f}.png"
        Image.fromarray(gray.astype(np.uint8)).save(out / rgb_name)
        if depth_scale_fn is not None:
            depth = depth * float(depth_scale_fn(i))
        d16 = np.clip(depth * depth_factor, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(out / depth_name)
        rgb_lines.append(f"{t:.6f} {rgb_name}")
        depth_lines.append(f"{t:.6f} {depth_name}")
        q = rot_to_quat_np(Twc[:3, :3])
        tw = Twc[:3, 3]
        gt_lines.append(
            f"{t:.6f} {tw[0]:.6f} {tw[1]:.6f} {tw[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    (out / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (out / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (out / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return out


def write_stereo_sequence(out_dir: str | Path, K: np.ndarray,
                          poses_wc: np.ndarray, width: int = 640,
                          height: int = 480, baseline: float = 0.12,
                          fps: float = 30.0, seed: int = 0,
                          half_size: float = 2.0) -> Path:
    """Render a BoxRoom trajectory as a KITTI-layout stereo sequence.

    Writes image_0/ (left), image_1/ (right, shifted `baseline` meters along
    the camera x axis), times.txt, and a TUM-format groundtruth.txt of the
    left-camera poses for ATE tooling.
    """
    from PIL import Image

    from .trajectory import rot_to_quat_np

    out = Path(out_dir)
    (out / "image_0").mkdir(parents=True, exist_ok=True)
    (out / "image_1").mkdir(parents=True, exist_ok=True)
    room = BoxRoom(half_size=half_size, seed=seed)
    times, gt_lines = [], ["# synthetic stereo"]
    for i, Twc in enumerate(poses_wc):
        t = i / fps
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([baseline, 0, 0])
        gl, _ = room.render(K, Twc, width, height)
        gr, _ = room.render(K, Twc_r, width, height)
        Image.fromarray(gl.astype(np.uint8)).save(out / f"image_0/{i:06d}.png")
        Image.fromarray(gr.astype(np.uint8)).save(out / f"image_1/{i:06d}.png")
        times.append(f"{t:.6e}")
        q = rot_to_quat_np(Twc[:3, :3])
        tw = Twc[:3, 3]
        gt_lines.append(
            f"{t:.6f} {tw[0]:.6f} {tw[1]:.6f} {tw[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )
    (out / "times.txt").write_text("\n".join(times) + "\n")
    (out / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return out
