"""ArUco marker detection — `ArucoDetector` parity (`src/ArucoDetect.cpp`).

The reference runs cv::aruco detection + single-marker pose estimation on a
2-deep image queue feeding the viewer overlay struct `msArucoDrawer`
(`ArucoDetect.h:43-50`). This wraps cv2's aruco module directly with the
reference's config keys (`Aruco.*`, `Examples/ORB_RGBD640x480.yaml:112-116`,
plus `detector_params.yml`). Degrades to a no-op when cv2.aruco is missing.
Port of `orbslam_mapsave_tpu/apps/aruco.py`, a copy over the port's config:
the detector runs on the host in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ArucoConfig


@dataclasses.dataclass
class ArucoResult:
    """msArucoDrawer analogue (`ArucoDetect.h:43-50`)."""

    corners: list
    ids: np.ndarray | None
    rvecs: np.ndarray | None
    tvecs: np.ndarray | None


class ArucoDetector:
    def __init__(self, cfg: ArucoConfig | None = None, K: np.ndarray | None = None,
                 dist: np.ndarray | None = None):
        self.cfg = cfg or ArucoConfig()
        self.K = K
        self.dist = dist if dist is not None else np.zeros(5)
        self._impl = None
        try:
            import cv2

            if hasattr(cv2, "aruco"):
                d = cv2.aruco.getPredefinedDictionary(self.cfg.dictionary_id)
                params = cv2.aruco.DetectorParameters()
                self._impl = cv2.aruco.ArucoDetector(d, params)
                self._cv2 = cv2
        except Exception:
            self._impl = None

    @property
    def available(self) -> bool:
        return self._impl is not None

    def detect(self, gray: np.ndarray) -> ArucoResult:
        """Marker detect + optional pose (`ArucoDetect.cpp` Run body)."""
        if self._impl is None:
            return ArucoResult([], None, None, None)
        corners, ids, _ = self._impl.detectMarkers(gray.astype(np.uint8))
        rvecs = tvecs = None
        if (ids is not None and len(ids) and self.cfg.estimate_pose
                and self.K is not None):
            cv2 = self._cv2
            L = self.cfg.marker_length
            obj = np.array([
                [-L / 2, L / 2, 0], [L / 2, L / 2, 0],
                [L / 2, -L / 2, 0], [-L / 2, -L / 2, 0],
            ], np.float32)
            rvecs, tvecs = [], []
            for c in corners:
                okp, r, t = cv2.solvePnP(obj, c[0].astype(np.float32),
                                         self.K.astype(np.float64), self.dist)
                rvecs.append(r.ravel())
                tvecs.append(t.ravel())
            rvecs = np.asarray(rvecs)
            tvecs = np.asarray(tvecs)
        return ArucoResult(list(corners), ids, rvecs, tvecs)
