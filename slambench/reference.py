"""The plain reference: the generator's exact poses and a NumPy alignment.

The answers the program gives (each frame's pose, the keyframe map at an
episode's end) are judged against the exact camera poses that rendered the
frames. A trajectory is aligned to them as a whole (Umeyama: SE(3), or
Sim(3) for one camera, whose scale is unobservable) and the RMSE of the
camera centres is the error. This module imports NumPy alone: nothing of
the program, nothing that it made.
"""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool) -> tuple[float, np.ndarray, np.ndarray]:
    """(s, R, t) minimizing sum |dst - (s R src + t)|^2 over (N,3) point
    sets (Umeyama 1991); s = 1 unless `with_scale`."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ sc / len(src))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / (sc ** 2).sum(1).mean()) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def centres(poses_cw: np.ndarray) -> np.ndarray:
    """Camera centres (N,3) of world-to-camera poses (N,4,4)."""
    P = np.asarray(poses_cw, np.float64)
    R, t = P[:, :3, :3], P[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def ate_mm(est_cw: np.ndarray, gt_wc: np.ndarray, with_scale: bool) -> float:
    """RMSE in mm of the estimated camera centres after aligning them to
    the exact ones; inf with fewer than 3 poses (nothing to align)."""
    if len(est_cw) < 3:
        return float("inf")
    est = centres(est_cw)
    gt = np.asarray(gt_wc, np.float64)[:, :3, 3]
    s, R, t = umeyama(est, gt, with_scale)
    res = gt - (s * est @ R.T + t)
    return 1e3 * float(np.sqrt((res ** 2).sum(1).mean()))


REVISIT_FRAMES = 100  # keyframes this many frames apart ...
REVISIT_M = 0.1  # ... whose exact positions are this close see the same place


def loop_gap_mm(kf_cw: np.ndarray, kf_frame: np.ndarray, gt_wc: np.ndarray,
                with_scale: bool) -> float | None:
    """The smallest error, in mm, of the displacement between two keyframes
    that see the same place again (REVISIT_FRAMES apart in time, REVISIT_M
    apart in space): a closed loop leaves the map consistent where the
    camera came back, while an open one carries the drift of the whole
    circle into every later keyframe. The displacement is taken in the
    exact frame by the rotation (and scale) that aligns the whole map; no
    translation enters it. None where the episode revisits no place."""
    if len(kf_cw) < 3:
        return None
    est = centres(kf_cw)
    gt = np.asarray(gt_wc, np.float64)[:, :3, 3]
    s, R, _ = umeyama(est, gt, with_scale)
    i, j = np.triu_indices(len(gt), 1)
    pair = ((np.abs(kf_frame[j] - kf_frame[i]) >= REVISIT_FRAMES)
            & (np.linalg.norm(gt[j] - gt[i], axis=1) <= REVISIT_M))
    if not pair.any():
        return None
    i, j = i[pair], j[pair]
    err = s * (est[j] - est[i]) @ R.T - (gt[j] - gt[i])
    return 1e3 * float(np.sqrt((err ** 2).sum(1)).min())


def episode_numbers(frames: list, keyframes: tuple, gt_wc: np.ndarray, order: list,
                    with_scale: bool, stamp0: float, fps: float) -> dict:
    """The numbers one episode is judged by.

    frames: one (pose Tcw (4,4), lost) per frame offered, in order; a pose
    is judged only where the program did not call the frame lost.
    keyframes: (timestamps, Tcw poses) of the map's keyframes at the
    episode's end; each keyframe is matched to its frame by timestamp.
    order: the trajectory index of each frame.
    """
    tracked = [k for k in range(len(frames)) if not frames[k][1]]
    # a frame called lost is a failure, except before the first frame the
    # program tracks (the two-view bootstrap)
    boot = tracked[0] if tracked else len(frames)
    lost = [k for k in range(len(frames)) if frames[k][1] and k > boot]
    track = ate_mm(np.stack([frames[k][0] for k in tracked]) if tracked else np.zeros((0, 4, 4)),
                   gt_wc[[order[k] for k in tracked]], with_scale)
    ts, kf_cw = keyframes
    kidx = np.rint((np.asarray(ts, np.float64) - stamp0) * fps).astype(int)
    ok = (kidx >= 0) & (kidx < len(order))
    kidx, kf_cw = kidx[ok], np.asarray(kf_cw)[ok]
    kf_gt = gt_wc[[order[k] for k in kidx]]
    kf = ate_mm(kf_cw, kf_gt, with_scale)
    gap = loop_gap_mm(kf_cw, kidx, kf_gt, with_scale)
    return dict(track_ate_mm=track, kf_ate_mm=kf, loop_gap_mm=gap, lost_frames=len(lost),
                keyframes=len(kidx), first_tracked=boot)
