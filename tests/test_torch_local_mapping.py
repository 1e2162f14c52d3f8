"""Parity: the port's local mapping against the JAX package.

The map states come from a JAX run (RGB-D, 320x240, 600 ORB features) of a
14-frame orbit on which the JAX package makes keyframes at frames 0, 4, 7
and 13; the state handed over is the one right after frame 7 created its
keyframe, before its mapping pass (3 keyframes alive, so local BA and
keyframe culling run). Each function gets the same numpy state through
`interop`; integer and bool outputs must be equal, float outputs within
1e-5 unless stated, and one full `LocalMapper._map_step` must give equal
integer tables, poses within 1e-4 and points within 1e-3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu import config as jcfg
from orbslam_mapsave_tpu.optim import local_ba as jba
from orbslam_mapsave_tpu.pipeline import fused_step as jfs
from orbslam_mapsave_tpu.pipeline import local_mapping as jlm
from orbslam_mapsave_tpu.pipeline import system as jsys
from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.optim import local_ba as tba
from orbslam_mapsave_tpu_torch.pipeline import local_mapping as tlm
from orbslam_mapsave_tpu_torch.slammap import mapstate as tms

torch.set_num_threads(2)
W, H, FX = 320, 240, 200.0
KF_FRAME = 7  # creates the third keyframe on this sequence


def orbit_frames(n=14):
    """The test sequence: orbit_trajectory(n, radius=0.4, yaw_range=1.6)
    in BoxRoom(seed=5), u8 image and depth quantized to 1/5000 m (as a
    TUM depth PNG stores it)."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    room = synthetic.BoxRoom(half_size=2.0, seed=5)
    out = []
    for i, T in enumerate(synthetic.orbit_trajectory(n, radius=0.4, yaw_range=1.6)):
        g, d = room.render(K, T, W, H)
        out.append((1000.0 + i / 30.0, np.round(np.clip(g, 0, 255)).astype(np.float32),
                    (np.round(d * 5000.0) / 5000.0).astype(np.float32)))
    return out


def make_system(cfg_mod, sys_mod, **kw):
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=FX * 0.08, th_depth=50.0, depth_map_factor=5000.0, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints = 768
    cfg.max_keyframes = 32
    cfg.max_points = 8192
    return sys_mod.SLAMSystem(cfg, sys_mod.Sensor.RGBD, vocabulary=None,
                              enable_loop_closing=False, **kw)


@functools.lru_cache(maxsize=1)
def premap_case():
    """(JAX system, map state after frame KF_FRAME created its keyframe and
    before its mapping pass, kf slot, recent_start, abort). The JAX run
    goes frame by frame through the tracking step and, on keyframe frames,
    the mapper's pass, as its fused step composes them (`fused_step.py:
    262-282`), so the pass compiles once for this fixture and `test_map_step`.
    Built once per process: `test_torch_triangulation.py` shares it."""
    js = make_system(jcfg, jsys)
    step = jfs.make_fused_step(js.cam, js.builder, 4, 1.5, js.tracker.cfg, None)
    state, ctrl = js.tracker.map, None
    for t, g, d in orbit_frames()[:KF_FRAME + 1]:
        fr = js.builder.build(g, t - 1000.0, d)
        if ctrl is None:
            ctrl = jfs.initial_control_state(fr.kp_xy.shape[0], fr)
        prev = ctrl
        state, ctrl, out = step(state, ctrl, fr)
        if bool(out.kf_created) and int(prev.mode) == jfs.MODE_OK:
            abort = int(prev.frame_id) - int(prev.last_kf_frame_id) <= 2
            if int(prev.frame_id) == KF_FRAME:
                break
            n_pt = state.n_pt
            state, _, _ = js.mapper._map_step(state, out.kf_slot, prev.recent_start,
                                              jnp.asarray(abort))
            ctrl = ctrl._replace(recent_start=n_pt)
    assert int(jnp.sum(state.kf_valid)) == 3
    return js, state, int(out.kf_slot), int(prev.recent_start), abort


def perturb(state, kf, recent_start, seed=0):
    """The run's state with work for every stage of the mapping pass, as
    numpy edits of the JAX state: 3% of the recent points lose their
    `found` count (culled); 20% of the points kf shares with a neighbour
    are erased (their features become triangulation candidates); 15% are
    split, the first neighbour's observation moving to a new copy 1 cm away
    (duplicates for the two-way fuse to merge); 3% of kf's matched
    keypoints move 15 px (BA outliers)."""
    rng = np.random.default_rng(seed)
    d = to_np(state)
    P, n_pt = d["pt_valid"].shape[0], int(d["n_pt"])
    live = np.nonzero(d["pt_valid"])[0]
    recent = live[live >= recent_start]
    d["pt_found"][rng.choice(recent, max(1, len(recent) * 3 // 100), replace=False)] = 0
    nb0 = int(np.asarray(jms.covisible_keyframes(state, kf, 1))[0])
    shared = [p for p in live if kf in d["pt_obs_kf"][p] and nb0 in d["pt_obs_kf"][p]]
    shared = rng.permutation(shared)
    n_erase, n_split = len(shared) // 5, len(shared) * 3 // 20
    for p in shared[:n_erase]:
        for lane in np.nonzero(d["pt_obs_kf"][p] >= 0)[0]:
            d["kf_kp_point"][d["pt_obs_kf"][p, lane], d["pt_obs_idx"][p, lane]] = -1
        for k in ("pt_obs_kf", "pt_obs_idx", "pt_obs_oct"):
            d[k][p] = -1
        d["pt_valid"][p] = False
    for p in shared[n_erase:n_erase + n_split]:
        lane = int(np.nonzero(d["pt_obs_kf"][p] == nb0)[0][0])
        f = d["pt_obs_idx"][p, lane]
        q = n_pt
        n_pt += 1
        for k in ("pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist"):
            d[k][q] = d[k][p]
        d["pt_pos"][q] += rng.normal(size=3) * 0.01
        d["pt_valid"][q] = True
        d["pt_ref_kf"][q], d["pt_first_kf"][q] = nb0, kf
        d["pt_visible"][q] = d["pt_found"][q] = 1
        for k in ("pt_obs_kf", "pt_obs_idx", "pt_obs_oct"):
            d[k][q] = -1
            d[k][q, 0] = d[k][p, lane]
            d[k][p, lane] = -1
        d["kf_kp_point"][nb0, f] = q
    assert n_pt <= P
    d["n_pt"] = np.int32(n_pt)
    feats = np.nonzero(d["kf_kp_point"][kf] >= 0)[0]
    moved = rng.choice(feats, max(1, len(feats) * 3 // 100), replace=False)
    d["kf_kp_xy"][kf, moved, 0] += 15.0
    return to_jax(d)


def to_np(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


def to_port(state):
    return interop.map_state_from_numpy(to_np(state))


def to_jax(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_states(jstate, tstate, atol=1e-5, pose_atol=None, pos_atol=None):
    a, b = to_np(jstate), interop.map_state_to_numpy(tstate)
    for k in jms.MapState._fields:
        if a[k].dtype.kind == "f":
            tol = {"kf_pose": pose_atol, "pt_pos": pos_atol}.get(k) or atol
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.fixture(scope="module")
def case():
    js, run_state, kf, recent_start, abort = premap_case()
    mt = tlm.LocalMapper(js.cam, js.builder.inv_level_sigma2,
                         scale_factors=js.builder.scale_factors, n_levels=4,
                         scale_factor=1.5)
    return dict(js=js, run_state=run_state, state=perturb(run_state, kf, recent_start),
                kf=kf, recent_start=recent_start, abort=abort, mt=mt,
                tables=mt._t(torch.device("cpu")))


def test_recent_point_culling(case):
    st, kf = case["state"], case["kf"]
    P = st.pt_capacity
    recent = (np.arange(P) >= case["recent_start"]) & (np.arange(P) < int(st.n_pt))
    js = jax.jit(jlm.recent_point_culling)(st, jnp.asarray(recent), jnp.asarray(kf, jnp.int32))
    ts = tlm.recent_point_culling(to_port(st), torch.from_numpy(recent), kf)
    assert int(jnp.sum(st.pt_valid & ~js.pt_valid)) > 0  # some points go
    assert_states(js, ts)


# the JAX references, compiled once per call site instead of run op by op
_jit_fuse_match = jax.jit(jlm.fuse_match, static_argnums=(3, 7, 8))
_jit_fuse_apply = jax.jit(jlm.fuse_apply, static_argnums=4)
_jit_kf_culling = jax.jit(jlm.keyframe_culling)


def test_fuse_match_and_apply(case):
    st, kf = case["state"], case["kf"]
    js_ = case["js"]
    P = st.pt_capacity
    neigh = jms.covisible_keyframes(st, kf, 10)
    pts_nb = jnp.where((neigh >= 0)[:, None], st.kf_kp_point[jnp.clip(neigh, 0)], -1)
    jc = jms.unique_compact_ids(pts_nb.reshape(-1), P, min(jlm.FUSE_CAP, P), st.pt_valid)
    tc = tms.unique_compact_ids(torch.from_numpy(np.array(pts_nb.reshape(-1))), P,
                                min(tlm.FUSE_CAP, P), torch.from_numpy(np.array(st.pt_valid)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    inv2, sf, bounds = case["tables"]
    from orbslam_mapsave_tpu.geometry import projection as jproj

    jb = jproj.compute_image_bounds(js_.cam)
    ts = to_port(st)
    for target, cand in ((kf, jc), (int(neigh[0]), st.kf_kp_point[kf])):
        jw = _jit_fuse_match(st, target, cand, js_.cam, jb, js_.builder.scale_factors,
                             js_.builder.inv_level_sigma2, 4, 1.5)
        tw = tlm.fuse_match(ts, target, torch.from_numpy(np.array(cand)), js_.cam, bounds,
                            sf, inv2, 4, 1.5)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert (tw >= 0).sum() > 10
        for prefer in (False, True):  # True: the loop-fusion variant
            jout = _jit_fuse_apply(st, target, cand, jw, prefer)
            tout = tlm.fuse_apply(ts, target, torch.from_numpy(np.array(cand)), tw,
                                  prefer_candidate=prefer)
            assert_states(jout, tout)


def test_build_ba_window_and_apply(case):
    st, kf, js_ = case["state"], case["kf"], case["js"]
    ts = to_port(st)
    wj = jax.jit(jlm.build_ba_window)(st, jnp.asarray(kf, jnp.int32))
    wt = tlm.build_ba_window(ts, kf)
    for k in wj:
        np.testing.assert_array_equal(wt[k].numpy(), np.asarray(wj[k]), err_msg=k)
    assert int(wt["cam_ok"].sum()) == 3 and int(wt["l_ok"].sum()) > 500
    inv2 = js_.builder.inv_level_sigma2
    pj = jlm.assemble_ba_obs(st, wj, inv2, jlm.O_BA)
    pt = tlm.assemble_ba_obs(ts, wt, case["tables"][0], tlm.O_BA)
    for k, v in pj._asdict().items():
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(v), err_msg=k)
    # the same BA result applied on both sides: a pure write-back
    res = jax.jit(jba.local_bundle_adjustment, static_argnums=0)(js_.cam, pj)
    assert int(np.asarray(pj.obs_valid & ~res.obs_inlier).sum()) > 0  # outliers erased
    tres = tba.BAResult(*[torch.from_numpy(np.array(x)) for x in res])
    jout = jax.jit(jlm.apply_ba_result)(st, res, wj["cam_slots"], wj["lidx"], pj)
    tout = tlm.apply_ba_result(ts, tres, wt["cam_slots"], wt["lidx"], pt)
    assert_states(jout, tout, atol=0)


def _culling_map():
    """Six keyframes that all see 100 points; keyframes 0-2 at octave 0,
    3-5 at octave 3. From keyframe 5, keyframes 3 and 4 are redundant (all
    their points seen by >= 3 others at the same or finer scale), 1 and 2
    are not; points 0-49 are anchored to keyframe 3; parents form a chain.
    Built with the port's map functions (op by op in JAX it takes seconds)
    and handed to both sides as the same numpy state."""
    rng = np.random.default_rng(7)
    K, P, N = 8, 256, 128
    st = tms.empty_map(K, P, N)
    for k in range(6):
        st, _ = tms.add_keyframe(
            st, torch.eye(4), float(k), k,
            kp_xy=torch.from_numpy(rng.uniform(0, 300, (N, 2)).astype(np.float32)),
            kp_ur=torch.full((N,), -1.0), kp_depth=torch.ones(N),
            kp_octave=torch.full((N,), 0 if k < 3 else 3, dtype=torch.int32),
            kp_angle=torch.zeros(N), kp_valid=torch.ones(N, dtype=torch.bool),
            desc=torch.from_numpy(rng.integers(0, 256, (N, 32)).astype(np.uint8)))
    pos = torch.from_numpy(rng.normal(size=(100, 3)).astype(np.float32))
    ones = torch.ones(50, dtype=torch.bool)
    st, s1 = tms.add_points(st, pos[:50], torch.zeros((50, 32), dtype=torch.uint8), 3, 0, ones)
    st, s2 = tms.add_points(st, pos[50:], torch.zeros((50, 32), dtype=torch.uint8), 0, 0, ones)
    slots = torch.cat([s1, s2])
    for k in range(6):
        st = tms.add_observations(st, k, slots, torch.arange(100, dtype=torch.int32),
                                  torch.ones(100, dtype=torch.bool))
    for k in range(6):
        st = tms.update_connections(st, k)
    d = interop.map_state_to_numpy(st)
    d["kf_parent"] = np.array([-1, 0, 1, 2, 3, 4, -1, -1], np.int32)
    return to_jax(d)


def test_keyframe_culling():
    st = _culling_map()
    js = _jit_kf_culling(st, jnp.asarray(5, jnp.int32))
    ts = tlm.keyframe_culling(to_port(st), 5)
    np.testing.assert_array_equal(ts.kf_valid.numpy()[:6], [1, 1, 1, 0, 0, 1])
    assert_states(js, ts, atol=0)


def test_keyframe_culling_on_the_run(case):
    """On the run's state nothing is culled: the state comes back equal."""
    st, kf = case["state"], case["kf"]
    assert_states(_jit_kf_culling(st, jnp.asarray(kf, jnp.int32)),
                  tlm.keyframe_culling(to_port(st), kf), atol=0)


def _pairs(rng, st, n):
    """n disjoint (src, dst) pairs of valid points."""
    live = np.nonzero(np.asarray(st.pt_valid))[0]
    pick = rng.permutation(live)[:2 * n]
    return pick[:n].astype(np.int32), pick[n:].astype(np.int32)


@pytest.mark.parametrize("n", [40, 1100])
def test_merge_points(case, n):
    """40 disjoint merge pairs of live points, some masked out, among n
    rows; at n = 1100 > 1024 rows they are compacted first."""
    st = case["state"]
    rng = np.random.default_rng(n)
    s40, d40 = _pairs(rng, st, 40)
    src = np.full(n, -1, np.int32)
    dst = np.full(n, -1, np.int32)
    ok = np.zeros(n, bool)
    start = 1005 if n > 1024 else 0  # live rows after 1005 masked ones
    at = slice(start, start + 40)
    src[at], dst[at], ok[at] = s40, d40, rng.random(40) < 0.8
    js = jax.jit(jms.merge_points)(st, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ok))
    ts = tms.merge_points(to_port(st), torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(ok))
    assert_states(js, ts, atol=0)


def _free_features(st, kf, n, rng):
    free = np.nonzero(np.asarray(st.kf_kp_valid[kf]) & (np.asarray(st.kf_kp_point[kf]) < 0))[0]
    return rng.permutation(free)[:n].astype(np.int32)


def test_add_observations_rows(case):
    st = case["state"]
    rng = np.random.default_rng(1)
    live = np.nonzero(np.asarray(st.pt_valid))[0]
    kfs = np.nonzero(np.asarray(st.kf_valid))[0]
    rows_kf, rows_ft = [], []
    for k in kfs:
        f = _free_features(st, int(k), 30, rng)
        rows_kf += [int(k)] * len(f)
        rows_ft += list(f)
    B = len(rows_kf)
    kf_rows = np.array(rows_kf, np.int32)
    feat = np.array(rows_ft, np.int32)
    pts = rng.permutation(live)[:B].astype(np.int32)
    ok = rng.random(B) < 0.9
    kf_rows[::7] = -1  # rows without a keyframe are skipped
    js = jax.jit(jms.add_observations_rows)(st, jnp.asarray(kf_rows), jnp.asarray(pts),
                                   jnp.asarray(feat), jnp.asarray(ok))
    ts = tms.add_observations_rows(to_port(st), torch.from_numpy(kf_rows),
                                   torch.from_numpy(pts), torch.from_numpy(feat),
                                   torch.from_numpy(ok))
    assert_states(js, ts, atol=0)
    # the dup variant: each point repeated in several keyframes
    pts_dup = np.resize(pts[:B // 3], B)
    js = jax.jit(jms.add_observations_rows_dup)(st, jnp.asarray(kf_rows), jnp.asarray(pts_dup),
                                       jnp.asarray(feat), jnp.asarray(ok))
    ts = tms.add_observations_rows_dup(to_port(st), torch.from_numpy(kf_rows),
                                       torch.from_numpy(pts_dup), torch.from_numpy(feat),
                                       torch.from_numpy(ok))
    assert_states(js, ts, atol=0)


def test_unique_compact_ids_and_erase(case):
    st = case["state"]
    rng = np.random.default_rng(2)
    P = st.pt_capacity
    ids = rng.integers(-3, P, 5000).astype(np.int32)
    for cap in (64, 4096):
        np.testing.assert_array_equal(
            tms.unique_compact_ids(torch.from_numpy(ids), P, cap,
                                   torch.from_numpy(np.array(st.pt_valid))).numpy(),
            np.asarray(jms.unique_compact_ids(jnp.asarray(ids), P, cap, st.pt_valid)))
    mask = rng.random(P) < 0.1
    assert_states(jms.erase_points(st, jnp.asarray(mask)),
                  tms.erase_points(to_port(st), torch.from_numpy(mask)), atol=0)
    np.testing.assert_array_equal(tms.point_obs_count(to_port(st)).numpy(),
                                  np.asarray(jnp.sum(st.pt_obs_kf >= 0, -1)))


@pytest.mark.parametrize("which", ["run_state", "state"])
def test_map_step(case, which):
    """One full mapping pass (culling, triangulation, two-way fuse, local BA,
    keyframe culling) from the JAX run's own state, and from the perturbed
    one, on which every stage has work (new points, merges, outliers)."""
    st, kf = case[which], case["kf"]
    jout, jdrop, jesc = case["js"].mapper._map_step(
        st, jnp.asarray(kf, jnp.int32), jnp.asarray(case["recent_start"], jnp.int32),
        jnp.asarray(case["abort"]))
    tout, tdrop, tesc = case["mt"]._map_step(to_port(st), kf, case["recent_start"],
                                             case["abort"])
    assert (tdrop, tesc) == (int(jdrop), bool(jesc)) == (0, False)
    if which == "state":
        assert int(tout.n_pt) > int(st.n_pt)  # triangulation added points
        assert int(torch.sum(tout.pt_valid)) < int(tout.n_pt) - int(st.n_pt) + int(
            jnp.sum(st.pt_valid))  # points were culled or merged
    assert_states(jout, tout, atol=1e-3, pose_atol=1e-4, pos_atol=1e-3)


def test_process_and_lane_stats(case):
    """`LocalMapper.process` (the host-driven pass, which keeps its own
    recent-point window, here set to the run's) and its BA lane log,
    against the JAX mapper."""
    st, kf = case["state"], case["kf"]
    jm = case["js"].mapper
    jm.recent_start, jm.ba_lane_log = jnp.asarray(case["recent_start"], jnp.int32), []
    mt = tlm.LocalMapper(case["js"].cam, case["js"].builder.inv_level_sigma2,
                         scale_factors=case["js"].builder.scale_factors)
    mt.recent_start = case["recent_start"]
    jout = jm.process(st, kf)
    tout = mt.process(to_port(st), kf)
    assert mt.recent_start == int(jm.recent_start) == int(st.n_pt)
    assert mt.ba_lane_stats() == jm.ba_lane_stats() == (0, 0)
    assert_states(jout, tout, atol=1e-3, pose_atol=1e-4, pos_atol=1e-3)
