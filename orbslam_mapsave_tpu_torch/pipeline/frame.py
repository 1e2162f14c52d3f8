"""Per-frame feature container built from one image (monocular), one
RGB-D image pair or one stereo image pair.

Port of `orbslam_mapsave_tpu/pipeline/frame.py`: ORB extraction, keypoint
undistortion (`Frame::UndistortKeyPoints`), the RGB-D pseudo-stereo
(`Frame::ComputeStereoFromRGBD`, `src/Frame.cc:759-780`), the stereo
matches (`Frame::ComputeStereoMatches`, `src/Frame.cc:584-756`) and the
scale-pyramid tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import projection
from ..ops import hamming, orb, stereo
from ..utils import metrics


class FrameData(NamedTuple):
    timestamp: torch.Tensor  # () f32 offset from the run's f64 epoch
    kp_xy_raw: torch.Tensor  # (N,2) raw pixel coords
    kp_xy: torch.Tensor  # (N,2) undistorted
    kp_ur: torch.Tensor  # (N,) right-u (<0 mono)
    kp_depth: torch.Tensor  # (N,) depth (<=0 none)
    kp_octave: torch.Tensor  # (N,) i32
    kp_angle: torch.Tensor  # (N,) degrees
    kp_response: torch.Tensor  # (N,)
    desc: torch.Tensor  # (N,32) u8
    desc_bits: torch.Tensor  # (N,256) i8
    valid: torch.Tensor  # (N,) bool


class FrameBuilder:
    """Static camera/ORB config + the per-frame build on a given device."""

    def __init__(self, cam: projection.Camera, spec: orb.ORBSpec, device):
        self.cam = cam
        self.spec = spec
        self.device = torch.device(device)
        self.scale_factors = np.asarray(
            [spec.scale_factor**i for i in range(spec.n_levels)], np.float32)
        self.inv_level_sigma2 = (1.0 / (self.scale_factors**2)).astype(np.float32)
        self.bounds = projection.compute_image_bounds(cam)
        # device copies of the small tables the per-frame steps index
        self.scale_factors_t = torch.from_numpy(self.scale_factors).to(self.device)
        self.inv_level_sigma2_t = torch.from_numpy(self.inv_level_sigma2).to(self.device)
        self.bounds_t = torch.from_numpy(self.bounds).to(self.device)

    @metrics.traced("build.frame")
    def build(self, image, timestamp: float, depth=None, mask=None) -> FrameData:
        """Frame from an image (H,W) and, for RGB-D, a depth map (H,W) in
        meters, in any numeric dtype (u8 image and f16 depth are what a
        sensor delivers); all compute runs in float32 on `self.device`.
        Without depth (monocular, `Frame.cc:160-215`) every feature has
        ur = depth = -1. `mask` (H,W), optional: the human mask, zero where
        no keypoint may be detected (`orb.extract`)."""
        cam = self.cam
        image = torch.as_tensor(image).to(self.device, torch.float32)
        kp = orb.extract(self.spec, image, mask)
        und = projection.undistort_points(cam, kp["xy"])
        none = torch.full_like(und[:, 0], -1.0)
        if depth is None:
            ur = d = none
        else:
            with metrics.span("build.depth"):
                depth = torch.as_tensor(depth).to(self.device, torch.float32)
                # sample depth at the rounded raw keypoint coords, Frame.cc:765-768
                xi = torch.clamp(torch.round(kp["xy"][:, 0]).long(), 0, depth.shape[1] - 1)
                yi = torch.clamp(torch.round(kp["xy"][:, 1]).long(), 0, depth.shape[0] - 1)
                d = depth[yi, xi]
                has_d = d > 0
                ur = torch.where(has_d,
                                 und[:, 0] - cam.bf / torch.where(has_d, d, torch.ones_like(d)),
                                 none)
                d = torch.where(has_d, d, none)
        return FrameData(
            timestamp=torch.tensor(timestamp, dtype=torch.float32, device=self.device),
            kp_xy_raw=kp["xy"],
            kp_xy=und,
            kp_ur=ur,
            kp_depth=d,
            kp_octave=kp["octave"],
            kp_angle=kp["angle_deg"],
            kp_response=kp["response"],
            desc=kp["desc"],
            desc_bits=hamming.unpack_bits(kp["desc"]),
            valid=kp["valid"],
        )

    @metrics.traced("build.frame")
    def build_stereo(self, image_left, image_right, timestamp: float) -> FrameData:
        """Stereo frame (`Frame::Frame`, `src/Frame.cc:63-122`): ORB from
        both images, left-right matches on the raw keypoints for each left
        keypoint's right-u and depth (-1 where unmatched), then the left
        keypoints undistorted."""
        cam = self.cam
        left = torch.as_tensor(image_left).to(self.device, torch.float32)
        right = torch.as_tensor(image_right).to(self.device, torch.float32)
        kl, kr = orb.extract(self.spec, left), orb.extract(self.spec, right)
        bits_l = hamming.unpack_bits(kl["desc"])
        with metrics.span("build.stereo"):
            ur, d = stereo.compute_stereo_matches(
                self.spec, left, right, kl["xy"], kl["octave"], bits_l, kl["valid"],
                kr["xy"], kr["octave"], hamming.unpack_bits(kr["desc"]), kr["valid"],
                bf=float(cam.bf), fx=float(cam.fx))
        return FrameData(
            timestamp=torch.tensor(timestamp, dtype=torch.float32, device=self.device),
            kp_xy_raw=kl["xy"],
            kp_xy=projection.undistort_points(cam, kl["xy"]),
            kp_ur=ur,
            kp_depth=d,
            kp_octave=kl["octave"],
            kp_angle=kl["angle_deg"],
            kp_response=kl["response"],
            desc=kl["desc"],
            desc_bits=bits_l,
            valid=kl["valid"],
        )
