"""Trajectory writers with byte-format parity to the reference exporters.

Reference exporters (SURVEY.md §5.5):
- `System::SaveCameraTrajectory` (`src/System.cc:698-751`): per-frame TUM
  lines ``t tx ty tz qx qy qz qw`` with ``fixed`` + ``setprecision(6)``,
  timestamp divided by 1e3, frames whose tracking was lost skipped, each
  frame's pose reconstructed as relative-pose x refKF-pose x Two.
- `System::SaveKeyFrameTrajectory` (`src/System.cc:753-787`): same fields per
  keyframe (note the reference prints no space between the timestamp and the
  following ``setprecision`` so the separator is the explicit " " — format
  here matches its actual output byte-for-byte).
- `System::SaveStereoKeyFrameTrajectory` / `SaveCameraLocTrajectory`
  (`src/System.cc:789-836`, `675-696`): 3x4 row-major matrix per line at
  precision 9.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

def _fmt(x: float, prec: int) -> str:
    return f"{x:.{prec}f}"


def rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x,y,z,w), pure numpy (Shepperd).

    Host-side twin of `geometry.se3.rot_to_quat` for IO paths — per-frame
    device dispatch of a 3x3 op costs more than the whole file write.
    """
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def quat_to_rot_np(q: np.ndarray) -> np.ndarray:
    """Quaternion (x,y,z,w) -> rotation matrix, pure numpy."""
    x, y, z, w = np.asarray(q, np.float64)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def se3_inv_np(T: np.ndarray) -> np.ndarray:
    """Rigid-transform inverse, pure numpy."""
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def tum_line(t: float, Twc: np.ndarray, prec: int = 6, t_div: float = 1e3) -> str:
    """One TUM-format line from a camera->world pose (4,4)."""
    R = np.asarray(Twc)[:3, :3]
    tw = np.asarray(Twc)[:3, 3]
    q = rot_to_quat_np(R)  # (x,y,z,w)
    fields = [_fmt(t / t_div, prec)] + [_fmt(v, prec) for v in (*tw, *q)]
    return " ".join(fields)


def save_camera_trajectory(path: str | Path, timestamps, poses_cw, lost=None,
                           t_div: float = 1e3) -> None:
    """Write per-frame TUM trajectory. `poses_cw` are world->camera (Tcw) as in
    the reference; inverted here exactly like `System.cc:742-744`."""
    lines = []
    for i, (t, Tcw) in enumerate(zip(timestamps, poses_cw)):
        if lost is not None and lost[i]:
            continue
        Twc = se3_inv_np(Tcw)
        lines.append(tum_line(float(t), Twc, t_div=t_div))
    Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))


def save_keyframe_trajectory(path: str | Path, timestamps, poses_cw,
                             t_div: float = 1e3) -> None:
    """Write keyframe TUM trajectory (`System.cc:753-787`)."""
    save_camera_trajectory(path, timestamps, poses_cw, lost=None, t_div=t_div)


def save_matrix_trajectory(path: str | Path, poses_cw) -> None:
    """3x4 [R|t] (world<-camera) rows at precision 9
    (`System::SaveStereoKeyFrameTrajectory`, `src/System.cc:789-836`)."""
    lines = []
    for Tcw in poses_cw:
        Twc = se3_inv_np(Tcw)
        R, t = Twc[:3, :3], Twc[:3, 3]
        vals = [R[0, 0], R[0, 1], R[0, 2], t[0],
                R[1, 0], R[1, 1], R[1, 2], t[1],
                R[2, 0], R[2, 1], R[2, 2], t[2]]
        lines.append(" ".join(_fmt(v, 9) for v in vals))
    Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))


def load_tum_trajectory(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory file -> (timestamps (N,), Twc poses (N,4,4))."""
    ts, poses = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
        R = quat_to_rot_np([qx, qy, qz, qw])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [tx, ty, tz]
        ts.append(t)
        poses.append(T)
    return np.asarray(ts), np.asarray(poses)


def ate_rmse(gt_ts, gt_poses, est_ts, est_poses, max_dt: float = 0.02,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after time association + Horn alignment.

    The reference leaves ATE to external tools (SURVEY.md §4); this is the
    standard TUM evaluation: associate by nearest timestamp, align with a
    closed-form SE3 (optionally Sim3 for monocular scale), report RMSE of
    translation residuals.
    """
    gt_ts = np.asarray(gt_ts)
    est_ts = np.asarray(est_ts)
    idx = np.abs(gt_ts[None, :] - est_ts[:, None]).argmin(axis=1)
    ok = np.abs(gt_ts[idx] - est_ts) <= max_dt
    if ok.sum() < 3:
        return float("inf")
    P = np.asarray(est_poses)[ok][:, :3, 3]  # estimated positions
    Q = np.asarray(gt_poses)[idx[ok]][:, :3, 3]  # ground-truth positions
    # Horn alignment (Umeyama)
    mu_p, mu_q = P.mean(0), Q.mean(0)
    Pc, Qc = P - mu_p, Q - mu_q
    H = Pc.T @ Qc
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    if with_scale:
        # H above is the UNnormalized correlation (no 1/n), so the variance
        # must be unnormalized too or the scale comes out n-times too large
        var_p = (Pc**2).sum()
        s = (S * np.diag(D)).sum() / var_p
    else:
        s = 1.0
    t = mu_q - s * R @ mu_p
    res = Q - (s * (R @ P.T).T + t)
    return float(np.sqrt((res**2).sum(axis=1).mean()))
