"""The generator: a seed gives the same episode twice, the torch renderer
casts the NumPy renderer's rays, and the splice lays out its stretches."""

import json

import numpy as np

import episode
import harness

TRAFFIC = json.loads((harness.HERE / "traffic" / "room-loop.json").read_text())
K = np.array([[130.0, 0, 80.0], [0, 130.0, 60.0], [0, 0, 1.0]])
MM = 1000.0  # DepthMapFactor: depth in whole millimetres


def _room():
    return episode.BoxRoom(2.0, tex_size=128, seed=11)


def test_seed_renders_same_frames_twice():
    seed = 2**31 + 12345  # larger than 32 signed bits hold
    starts = episode.start_angles(TRAFFIC, seed)
    assert starts == episode.start_angles(TRAFFIC, seed)
    poses, order = episode.episode_poses(TRAFFIC, starts[0])
    poses2, _ = episode.episode_poses(TRAFFIC, episode.start_angles(TRAFFIC, seed)[0])
    assert np.array_equal(poses, poses2)
    idx = [0, 100, 239]
    a = episode.render_frames(_room(), K, poses[idx], 160, 120, "cpu", MM)
    b = episode.render_frames(_room(), K, poses2[idx], 160, 120, "cpu", MM)
    for (ia, da), (ib, db) in zip(a, b):
        assert ia.dtype == np.uint8 and da.dtype == np.float16
        assert np.array_equal(ia, ib) and np.array_equal(da, db)
    other, _ = episode.episode_poses(TRAFFIC, starts[1])
    assert not np.allclose(other[0], poses[0])


def test_start_angle_is_uniform_range():
    angles = [episode.start_angle(s) for s in range(-50, 50)] + [episode.start_angle(2**40)]
    assert all(0 <= a < 2 * np.pi for a in angles)
    assert len(set(angles)) == len(angles)


def test_every_seed_plays_the_same_starts_in_its_own_order():
    """A traffic that lists its starts gives every seed all of them, so that
    every seed does the same work; the seed draws only their order."""
    seeds = list(range(-20, 20)) + [2**31 + 977, 2**40]
    fixed = sorted(np.radians(TRAFFIC["starts"]))
    orders = {tuple(episode.start_angles(TRAFFIC, s)) for s in seeds}
    assert all(np.allclose(sorted(o), fixed) for o in orders)
    assert len(orders) == 6  # every order of three
    one = {k: v for k, v in TRAFFIC.items() if k != "starts"}
    assert episode.start_angles(one, 5) == [episode.start_angle(5)]


def test_torch_render_equals_numpy_render():
    room = _room()
    poses, _ = episode.episode_poses(TRAFFIC, episode.start_angle(7))
    for T, (img, dep) in zip(poses[[3, 77]], episode.render_frames(room, K, poses[[3, 77]],
                                                                    160, 120, "cpu", MM)):
        gray, depth = room.render(K, T, 160, 120)
        ref = np.clip(gray, 0, 255).astype(np.uint8)
        diff = np.abs(ref.astype(int) - img.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        want = (np.round(depth.astype(np.float64) * MM) / MM).astype(np.float16)
        assert np.array_equal(dep, want)


def test_splice():
    assert episode.episode_order(TRAFFIC) == list(range(240))
    order = episode.episode_order({"splice": [[0, 150], [100, 240]]})
    assert len(order) == 290 and order[149] == 149 and order[150] == 100 and order[-1] == 239
