"""Parity: the port's map-state updates against the JAX package on a seeded
map. Both sides start from the same numpy state (through `interop`) and
must end with every field equal; the float results of the normal/depth
update are held to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.slammap import mapstate as tms

torch.set_num_threads(2)
K, P, N = 8, 512, 128
SF = np.array([1.5**i for i in range(4)], np.float32)


def _np(jstate):
    return {k: np.array(v) for k, v in jstate._asdict().items()}


def _to_port(jstate):
    return interop.map_state_from_numpy(_np(jstate))


def _to_jax(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _cmp(jstate, tstate, approx=()):
    a, b = _np(jstate), interop.map_state_to_numpy(tstate)
    for k in jms.MapState._fields:
        if k in approx:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _kf_data(rng, n_match_pts=0):
    return dict(
        kp_xy=rng.uniform(0, 640, (N, 2)).astype(np.float32),
        kp_ur=np.where(rng.random(N) < 0.7, rng.uniform(0, 600, N), -1).astype(np.float32),
        kp_depth=np.where(rng.random(N) < 0.8, rng.uniform(0.5, 5, N), -1).astype(np.float32),
        kp_octave=rng.integers(0, 4, N).astype(np.int32),
        kp_angle=rng.uniform(0, 360, N).astype(np.float32),
        kp_valid=rng.random(N) < 0.95,
        desc=rng.integers(0, 256, (N, 32), dtype=np.uint8))


def _add_kf(jstate, tstate, rng, frame_id):
    d = _kf_data(rng)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = rng.normal(0, 0.2, 3)
    order = ("kp_xy", "kp_ur", "kp_depth", "kp_octave", "kp_angle", "kp_valid", "desc")
    js, jk = jms.add_keyframe(jstate, jnp.asarray(pose), jnp.float32(0.5 * frame_id),
                              frame_id, *[jnp.asarray(d[k]) for k in order])
    ts, tk = tms.add_keyframe(tstate, torch.from_numpy(pose), 0.5 * frame_id,
                              frame_id, *[torch.from_numpy(d[k]) for k in order])
    assert int(jk) == tk
    return js, ts, tk, d


def _add_pts(jstate, tstate, rng, kf, n=N):
    pos = rng.uniform([-2, -2, 1], [2, 2, 5], (n, 3)).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    valid = rng.random(n) < 0.75
    js, jslots = jms.add_points(jstate, jnp.asarray(pos), jnp.asarray(desc), kf, kf,
                                jnp.asarray(valid))
    ts, tslots = tms.add_points(tstate, torch.from_numpy(pos), torch.from_numpy(desc),
                                kf, kf, torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(jslots), tslots.numpy())
    return js, ts, np.array(jslots)


def _add_obs(jstate, tstate, kf, slots, ok):
    feat = np.arange(N, dtype=np.int32)
    js = jms.add_observations(jstate, kf, jnp.asarray(slots), jnp.asarray(feat),
                              jnp.asarray(ok))
    ts = tms.add_observations(tstate, kf, torch.from_numpy(slots),
                              torch.from_numpy(feat), torch.from_numpy(ok))
    return js, ts


@pytest.fixture(scope="module")
def seeded():
    """Three keyframes sharing points, built step by step on both sides."""
    rng = np.random.default_rng(0)
    js = jms.empty_map(K, P, N)
    ts = tms.empty_map(K, P, N)
    _cmp(js, ts)
    steps = []
    js, ts, kf0, _ = _add_kf(js, ts, rng, 0)
    steps.append(("add_keyframe", js, ts))
    js, ts, slots0 = _add_pts(js, ts, rng, kf0)
    steps.append(("add_points", js, ts))
    js, ts = _add_obs(js, ts, kf0, slots0, slots0 >= 0)
    steps.append(("add_observations", js, ts))
    for fid in (1, 2):
        js, ts, kf, _ = _add_kf(js, ts, rng, fid)
        # re-observe a random subset of the existing points
        seen = rng.permutation(np.nonzero(slots0 >= 0)[0])[:60]
        slots = np.full(N, -1, np.int32)
        slots[rng.permutation(N)[:60]] = slots0[seen]
        js, ts = _add_obs(js, ts, kf, slots, rng.random(N) < 0.9)
        js = jms.update_connections(js, kf)
        ts = tms.update_connections(ts, kf)
        steps.append((f"update_connections_{fid}", js, ts))
    return js, ts, slots0, steps


def test_build_steps_equal(seeded):
    for name, js, ts in seeded[3]:
        _cmp(js, ts)


def test_distinctive_descriptors_and_normals(seeded):
    js, ts, slots0, _ = seeded
    idx = np.clip(slots0, 0, None).astype(np.int32)
    ok = slots0 >= 0
    js2 = jms.compute_distinctive_descriptors_idx(js, jnp.asarray(idx), jnp.asarray(ok))
    ts2 = tms.compute_distinctive_descriptors_idx(ts, torch.from_numpy(idx),
                                                  torch.from_numpy(ok))
    _cmp(js2, ts2)
    js3 = jms.update_normal_and_depth_idx(js2, jnp.asarray(idx), jnp.asarray(ok), SF, 4)
    ts3 = tms.update_normal_and_depth_idx(ts2, torch.from_numpy(idx),
                                          torch.from_numpy(ok), SF, 4)
    _cmp(js3, ts3, approx=("pt_normal", "pt_min_dist", "pt_max_dist"))


def test_compact_points_and_keyframes(seeded):
    js, _, _, _ = seeded
    d = _np(js)
    rng = np.random.default_rng(1)
    d["pt_valid"] = d["pt_valid"] & (rng.random(P) < 0.7)
    d["kf_valid"][1] = False
    js = _to_jax(d)
    ts = interop.map_state_from_numpy(d)
    jp, jmap = jms.compact_points(js)
    tp, tmap = tms.compact_points(ts)
    np.testing.assert_array_equal(np.asarray(jmap), tmap.numpy())
    _cmp(jp, tp)
    jk, jkmap = jms.compact_keyframes(jp)
    tk, tkmap = tms.compact_keyframes(tp)
    np.testing.assert_array_equal(np.asarray(jkmap), tkmap.numpy())
    _cmp(jk, tk)


@pytest.mark.parametrize("cap", [16, 300])
def test_compact_indices_and_covisible(seeded, cap):
    rng = np.random.default_rng(cap)
    flag = (rng.random(500) < 0.4).astype(np.int8)
    np.testing.assert_array_equal(
        np.asarray(jms.compact_indices(jnp.asarray(flag), cap)),
        tms.compact_indices(torch.from_numpy(flag), cap).numpy())
    js, ts, _, _ = seeded
    for kf in range(3):
        np.testing.assert_array_equal(
            np.asarray(jms.covisible_keyframes(js, kf, 4)),
            tms.covisible_keyframes(ts, kf, 4).numpy())


def test_points_past_capacity_are_dropped():
    """Filling the map: rows past capacity are dropped on both sides, and
    every row of the state agrees. The JAX version sends its masked rows to
    slot P-1 with that slot's old value, applied in row order, so when the
    LAST slot is filled by a row that has masked rows after it, the point
    written there is lost (pt_valid[P-1] stays False); the port does the
    same."""
    cap = 64
    rng = np.random.default_rng(3)
    js = jms.empty_map(K, cap, N)
    ts = tms.empty_map(K, cap, N)
    js, ts, kf, _ = _add_kf(js, ts, rng, 0)
    pos = rng.uniform([-2, -2, 1], [2, 2, 5], (N, 3)).astype(np.float32)
    valid = rng.random(N) < 0.75
    desc = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    js, jslots = jms.add_points(js, jnp.asarray(pos), jnp.asarray(desc), kf, kf,
                                jnp.asarray(valid))
    ts, tslots = tms.add_points(ts, torch.from_numpy(pos), torch.from_numpy(desc),
                                kf, kf, torch.from_numpy(valid))
    slots = tslots.numpy()
    np.testing.assert_array_equal(np.asarray(jslots), slots)
    assert (slots >= 0).sum() == cap and int(ts.n_pt) == cap
    assert not bool(ts.pt_valid[cap - 1]) and bool(ts.pt_valid[:cap - 1].all())
    _cmp(js, ts)


@pytest.mark.parametrize("case", ["last_row_fills", "no_masked_rows", "overflow_only"])
def test_add_points_at_capacity_matches_jax(case):
    """The last slot keeps its point exactly when no skipped row (masked or
    past capacity) follows the row that fills it."""
    cap = 40
    rng = np.random.default_rng(4)
    js = jms.empty_map(K, cap, N)
    ts = tms.empty_map(K, cap, N)
    js, ts, kf, _ = _add_kf(js, ts, rng, 0)
    n = {"last_row_fills": 48, "no_masked_rows": 40, "overflow_only": 56}[case]
    pos = rng.uniform([-2, -2, 1], [2, 2, 5], (n, 3)).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    valid = np.ones(n, bool)
    if case == "last_row_fills":  # 8 masked rows, all before the filling row
        valid[rng.permutation(n - 1)[:8]] = False
    js, jslots = jms.add_points(js, jnp.asarray(pos), jnp.asarray(desc), kf, kf,
                                jnp.asarray(valid))
    ts, tslots = tms.add_points(ts, torch.from_numpy(pos), torch.from_numpy(desc),
                                kf, kf, torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(jslots), tslots.numpy())
    assert bool(ts.pt_valid[cap - 1]) == (case != "overflow_only")
    _cmp(js, ts)


def test_replace_points_then_rebuild_observations(seeded):
    """A fuse batch (unique live sources, some lanes masked, two sources
    onto one destination) redirects forward references, adds the visible /
    found counts, erases the sources; rebuilding the reverse lists from the
    forward map gives JAX's tables. A point observed more than MAX_OBS
    times keeps its first MAX_OBS observations, as in JAX."""
    js, ts, slots0, _ = seeded
    live = slots0[slots0 >= 0]
    rng = np.random.default_rng(5)
    pick = rng.permutation(live)[:24]
    src, dst = pick[:16].astype(np.int32), np.r_[pick[16:24], pick[16:24]].astype(np.int32)
    dst[1] = dst[0]
    ok = rng.random(16) < 0.8
    js2 = jms.replace_points(js, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ok))
    ts2 = tms.replace_points(ts, torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(ok))
    _cmp(js2, ts2)
    _cmp(jms.rebuild_observations(js2), tms.rebuild_observations(ts2))
    # every keypoint of every keyframe on one point: past MAX_OBS lanes
    d = _np(js2)
    d["kf_kp_point"][:, :8] = live[0]
    d["kf_kp_point"][2, 8:12] = live[1]
    jcrowd = _to_jax(d)
    tcrowd = interop.map_state_from_numpy(d)
    jr, tr = jms.rebuild_observations(jcrowd), tms.rebuild_observations(tcrowd)
    _cmp(jr, tr)
    assert (np.asarray(jr.pt_obs_kf)[live[0]] >= 0).sum() == jms.MAX_OBS
