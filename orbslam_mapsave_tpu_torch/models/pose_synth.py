"""Synthetic stick-figure renderer: exact-ground-truth training/eval data
for the pose backbone (`models/pose_net.py`).

Port of `orbslam_mapsave_tpu/models/pose_synth.py`, a numpy copy: the same
seed renders the same images and joints in both packages.

Mirrors the role OpenPose's COCO/BODY_25 training data plays for the
reference (`src/DetectHumanPose.cpp` consumes a trained BODY_25 model):
the project ships no pose dataset, so a randomized
articulated skeleton is rasterized with known joint positions, giving the
backbone a supervised signal with zero label noise — the same
synthetic-oracle strategy as `io/synthetic.py`'s BoxRoom for SLAM.
"""

from __future__ import annotations

import numpy as np

from ..apps.human_pose import LINKS, N_JOINTS

# Canonical BODY_25 template, unit-height figure, origin at MidHip (joint 8).
# [x, y] with y DOWN (image convention); head up = negative y.
_TEMPLATE = np.zeros((N_JOINTS, 2), np.float32)
_TEMPLATE[0] = (0.00, -0.58)   # Nose
_TEMPLATE[1] = (0.00, -0.45)   # Neck
_TEMPLATE[2] = (-0.12, -0.44)  # RShoulder
_TEMPLATE[3] = (-0.16, -0.25)  # RElbow
_TEMPLATE[4] = (-0.18, -0.06)  # RWrist
_TEMPLATE[5] = (0.12, -0.44)   # LShoulder
_TEMPLATE[6] = (0.16, -0.25)   # LElbow
_TEMPLATE[7] = (0.18, -0.06)   # LWrist
_TEMPLATE[8] = (0.00, 0.00)    # MidHip
_TEMPLATE[9] = (-0.08, 0.01)   # RHip
_TEMPLATE[10] = (-0.09, 0.24)  # RKnee
_TEMPLATE[11] = (-0.10, 0.46)  # RAnkle
_TEMPLATE[12] = (0.08, 0.01)   # LHip
_TEMPLATE[13] = (0.09, 0.24)   # LKnee
_TEMPLATE[14] = (0.10, 0.46)   # LAnkle
_TEMPLATE[15] = (-0.03, -0.60)  # REye
_TEMPLATE[16] = (0.03, -0.60)   # LEye
_TEMPLATE[17] = (-0.06, -0.57)  # REar
_TEMPLATE[18] = (0.06, -0.57)   # LEar
_TEMPLATE[19] = (0.13, 0.50)    # LBigToe
_TEMPLATE[20] = (0.15, 0.50)    # LSmallToe
_TEMPLATE[21] = (0.08, 0.49)    # LHeel
_TEMPLATE[22] = (-0.13, 0.50)   # RBigToe
_TEMPLATE[23] = (-0.15, 0.50)   # RSmallToe
_TEMPLATE[24] = (-0.08, 0.49)   # RHeel


def sample_skeleton(rng: np.random.Generator, height: int, width: int):
    """Random articulated instance: (25, 2) pixel joints inside the image."""
    joints = _TEMPLATE.copy()
    # limb articulation: jitter each joint, more at extremities
    wig = rng.normal(0.0, 0.03, joints.shape).astype(np.float32)
    joints = joints + wig
    # global similarity transform
    scale = height * rng.uniform(0.45, 0.75)
    ang = rng.uniform(-0.25, 0.25)
    c, s = np.cos(ang), np.sin(ang)
    R = np.array([[c, -s], [s, c]], np.float32)
    joints = joints @ R.T * scale
    span = joints.max(0) - joints.min(0)
    # bounds can invert for tall rotated samples (scale near 0.75*height);
    # clamp so the figure always fits with margin (ADVICE r2)
    cx_lo = span[0] / 2 + 4
    cx = rng.uniform(cx_lo, max(width - span[0] / 2 - 4, cx_lo))
    cy_lo = -joints[:, 1].min() + 4
    cy = rng.uniform(cy_lo, max(height - joints[:, 1].max() - 4, cy_lo))
    joints[:, 0] += cx
    joints[:, 1] += cy
    return joints


def _draw_line(img, p0, p1, value, half_w=1):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) * 2) + 2
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip((p0[0] + ts * (p1[0] - p0[0])).astype(int), 0,
                 img.shape[1] - 1)
    ys = np.clip((p0[1] + ts * (p1[1] - p0[1])).astype(int), 0,
                 img.shape[0] - 1)
    for dy in range(-half_w, half_w + 1):
        for dx in range(-half_w, half_w + 1):
            img[np.clip(ys + dy, 0, img.shape[0] - 1),
                np.clip(xs + dx, 0, img.shape[1] - 1)] = value


def render_stick_figure(rng: np.random.Generator, height: int, width: int):
    """One sample: (H, W) float32 image in [0,255], (25, 2) px joints."""
    img = rng.uniform(0.0, 60.0, (height, width)).astype(np.float32)
    joints = sample_skeleton(rng, height, width)
    val = rng.uniform(170.0, 255.0)
    for a, b in LINKS:
        _draw_line(img, joints[a], joints[b], val)
    _draw_line(img, joints[0], joints[0], val, half_w=2)  # head blob
    return img, joints


def render_batch(rng: np.random.Generator, batch: int, height: int,
                 width: int):
    imgs = np.empty((batch, height, width), np.float32)
    joints = np.empty((batch, N_JOINTS, 2), np.float32)
    for i in range(batch):
        imgs[i], joints[i] = render_stick_figure(rng, height, width)
    return imgs, joints
