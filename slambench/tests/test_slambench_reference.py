"""The plain reference: the alignment recovers a known transform, and an
episode's numbers count what they say."""

import numpy as np

import reference


def _rot(axis, angle):
    a = np.asarray(axis, float) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def test_umeyama_recovers_se3_and_sim3():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3))
    R, t = _rot([0.3, -1, 0.2], 0.7), np.array([0.5, -2.0, 1.0])
    for s, with_scale in ((1.0, False), (2.7, True)):
        dst = s * src @ R.T + t
        s2, R2, t2 = reference.umeyama(src, dst, with_scale)
        assert abs(s2 - s) < 1e-9 and np.allclose(R2, R) and np.allclose(t2, t)


def _poses_cw(centres, R):
    out = np.tile(np.eye(4), (len(centres), 1, 1))
    out[:, :3, :3] = R.T
    out[:, :3, 3] = -centres @ R
    return out


def test_ate_is_zero_up_to_gauge_and_counts_noise():
    rng = np.random.default_rng(1)
    gt = np.tile(np.eye(4), (30, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(30, 3))
    R, t = _rot([0, 1, 0], 1.1), np.array([1.0, 2.0, 3.0])
    est = _poses_cw((gt[:, :3, 3] - t) @ R, np.eye(3))
    assert reference.ate_mm(est, gt, with_scale=False) < 1e-6
    assert reference.ate_mm(_poses_cw(0.5 * gt[:, :3, 3], np.eye(3)), gt, with_scale=True) < 1e-6
    noisy = _poses_cw(gt[:, :3, 3] + 0.01 * rng.normal(size=(30, 3)), np.eye(3))
    assert 5 < reference.ate_mm(noisy, gt, with_scale=False) < 25


def test_episode_numbers():
    gt = np.tile(np.eye(4), (10, 1, 1))
    gt[:, 0, 3] = np.arange(10) * 0.1
    order = list(range(10))
    poses = _poses_cw(gt[:, :3, 3], np.eye(3))
    lost = [True, False, False, False, True, True, False, False, False, False]
    frames = list(zip(poses, lost))
    kf = (1000.0 + np.array([1, 2, 3, 8]) / 30.0, poses[[1, 2, 3, 8]])
    n = reference.episode_numbers(frames, kf, gt, order, False, 1000.0, 30.0)
    assert n["lost_frames"] == 2 and n["keyframes"] == 4 and n["first_tracked"] == 1
    assert n["track_ate_mm"] < 1e-6 and n["kf_ate_mm"] < 1e-6


def test_loop_gap_reads_the_drift_left_where_the_camera_came_back():
    # 30 keyframes, 10 frames apart, on 1.5 turns of a circle: keyframes
    # 0-10 see again what 18-28 see (180 frames later)
    frames = np.arange(30) * 10
    th = 2 * np.pi * frames / 180.0
    gt = np.tile(np.eye(4), (30, 1, 1))
    gt[:, :3, 3] = np.stack([0.5 * np.sin(th), np.zeros(30), 0.5 * np.cos(th)], 1)
    drift = np.zeros((30, 3))
    drift[:, 0] = 0.03 * frames / frames[-1]  # 30 mm over the run, growing
    open_loop = _poses_cw(gt[:, :3, 3] + drift, np.eye(3))
    assert 10 < reference.loop_gap_mm(open_loop, frames, gt, False) < 30
    closed = drift.copy()
    closed[25] = closed[25 - 18]  # one revisit made consistent with the first visit
    gap = reference.loop_gap_mm(_poses_cw(gt[:, :3, 3] + closed, np.eye(3)), frames, gt, False)
    assert gap < 0.5
    assert reference.loop_gap_mm(open_loop[:10], frames[:10], gt[:10], False) is None
