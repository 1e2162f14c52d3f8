"""Parity: relocalization and localization-only tracking against the JAX
package at the small size of `test_torch_slice.py` (320x240, 600 ORB
features, numpy-made synthetic frames).

- The keyframe-database detectors (dense and sparse) on stores built by
  both sides from the same rows: equal masks, scores within 1e-6.
- One `Relocalizer` batch on a JAX run's map and frame, with JAX's RANSAC
  draws: per candidate the same descriptor matches, RANSAC inliers, first
  pose-LM inliers, ladder choices, final inliers and matches; poses within
  1e-4. The ladder's two re-search steps from JAX's own start: the same
  matches, poses within 1e-4.
- The localization-only step of `fused_step` from a JAX `ControlState`,
  with the map points around the camera gone (map-less odometry, mb_vo)
  and with the map intact: the same outcome, poses within 1e-4, the map
  unchanged.
- `pose_opt.pose_optimization_batched` equal to B separate calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_epnp import jax_hypotheses
from test_torch_slice import FX, H, W, _system

from orbslam_mapsave_tpu import config as jcfg
from orbslam_mapsave_tpu.ops import epnp as jepnp
from orbslam_mapsave_tpu.ops import hamming as jham
from orbslam_mapsave_tpu.ops import matching as jmat
from orbslam_mapsave_tpu.optim import pose_opt as jpo
from orbslam_mapsave_tpu.pipeline import system as jsys
from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu.vocab import database as jdb
from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.io import dataset, synthetic
from orbslam_mapsave_tpu_torch.optim import pose_opt as tpo
from orbslam_mapsave_tpu_torch.optim.pose_problem import CAM, batch_obs, make_problem
from orbslam_mapsave_tpu_torch.pipeline import system as tsys
from orbslam_mapsave_tpu_torch.vocab import database as tdb

torch.set_num_threads(2)
POSE_TOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


# ---------------------------------------------------------------------------
# keyframe database
# ---------------------------------------------------------------------------


def _stores(seed=3, K=12, n_words=64, m=24):
    """A map with K keyframes (slot 9 dead), random symmetric covisibility,
    and BoW rows: dense (K, n_words) and the same rows sparse (K, m)."""
    rng = np.random.default_rng(seed)
    st = {k: np.asarray(v).copy() for k, v in jms.empty_map(K, 64, 8)._asdict().items()}
    st["kf_valid"][:] = True
    st["kf_valid"][9] = False
    c = rng.integers(0, 60, (K, K)) * (rng.random((K, K)) < 0.4)
    c = np.triu(c, 1)
    st["covis"] = (c + c.T).astype(np.int32)
    dense = np.zeros((K, n_words), np.float32)
    word = np.full((K, m), 2**31 - 1, np.int32)
    weight = np.zeros((K, m), np.float32)
    for k in range(K):
        w = np.sort(rng.choice(n_words, int(rng.integers(8, m)), replace=False))
        v = rng.random(len(w)).astype(np.float32)
        v /= v.sum()
        dense[k, w] = v
        word[k, :len(w)], weight[k, :len(w)] = w, v
    q = dense[4] * 0.6 + dense[7] * 0.4
    qw = np.nonzero(q)[0]
    q_word = np.full(m * 2, 2**31 - 1, np.int32)
    q_weight = np.zeros(m * 2, np.float32)
    q_word[:len(qw)], q_weight[:len(qw)] = qw, q[qw]
    return st, dense, (word, weight), q, (q_word, q_weight)


@pytest.mark.parametrize("which", ["reloc_dense", "reloc_sparse", "loop_dense"])
def test_candidate_detectors_match_jax(which):
    st, dense, (word, weight), q, (q_word, q_weight) = _stores()
    jst = jms.MapState(**{k: jnp.asarray(v) for k, v in st.items()})
    tst = interop.map_state_from_numpy(st)
    if which == "reloc_dense":
        jk, js_ = jdb.detect_relocalization_candidates(jnp.asarray(dense), jst, jnp.asarray(q))
        tk, ts_ = tdb.detect_relocalization_candidates(_t(dense), tst, _t(q))
    elif which == "reloc_sparse":
        jstore = jdb.SparseBowStore(word=jnp.asarray(word), weight=jnp.asarray(weight))
        tstore = tdb.SparseBowStore(word=_t(word), weight=_t(weight))
        jk, js_ = jdb.detect_relocalization_candidates_sparse(
            jstore, jst, jnp.asarray(q_word), jnp.asarray(q_weight))
        tk, ts_ = tdb.detect_relocalization_candidates_sparse(tstore, tst, _t(q_word),
                                                              _t(q_weight))
    else:
        jk, js_ = jdb.detect_loop_candidates(jnp.asarray(dense), jst, jnp.asarray(q), 4,
                                             jnp.asarray(0.05))
        tk, ts_ = tdb.detect_loop_candidates(_t(dense), tst, _t(q), 4, torch.tensor(0.05))
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    np.testing.assert_allclose(_np(ts_), np.asarray(js_), atol=1e-6)
    assert 0 < int(np.asarray(jk).sum()) < 11


def test_dense_store_add_erase():
    store = tdb.empty_bow_store(4, 6)
    bow = torch.tensor([0.5, 0.0, 0.25, 0.25, 0.0, 0.0])
    s2 = tdb.add_keyframe_bow(store, 2, bow)
    assert torch.equal(s2[2], bow) and float(store.sum()) == 0.0
    assert float(tdb.erase_keyframe_bow(s2, 2).sum()) == 0.0


# ---------------------------------------------------------------------------
# one relocalization batch on a JAX run's map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reloc_case(tmp_path_factory):
    """A JAX run over frames 0-5 of the 10-frame orbit (2 keyframes), and
    the frame of frame 9's image: candidates = the newest keyframes."""
    out = tmp_path_factory.mktemp("reloc_seq")
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    synthetic.write_tum_sequence(out, K, synthetic.orbit_trajectory(10, radius=0.4,
                                                                    yaw_range=0.4),
                                 width=W, height=H, seed=5, depth_factor=5000.0)
    frames = list(dataset.TUMDataset(out, depth_factor=5000.0))
    js = _system(jcfg, jsys)
    for t, gray, depth in frames[:6]:
        js.track_rgbd(gray, depth, t)
    js.tracker.flush()
    t, gray, depth = frames[9]
    jfr = js.builder.build(gray, t - js.tracker.ts_epoch, depth)
    ts = _system(tcfg, tsys, device="cpu")
    return js, jfr, ts, frames


def _jax_first_stage(reloc, state, frame, cand, key):
    """JAX `Relocalizer._batch`'s matching, RANSAC and first pose LM for one
    candidate (`relocalization.py:123-145`), to read their counts."""
    cam = reloc.cam
    inv_ls2 = jnp.asarray(reloc.inv_level_sigma2)
    sigma2 = jnp.asarray(reloc.level_sigma2)[jnp.clip(frame.kp_octave, 0, reloc.n_levels - 1)]
    kf_pts = state.kf_kp_point[cand]
    kf_ok = state.kf_kp_valid[cand] & (kf_pts >= 0) & state.pt_valid[jnp.clip(kf_pts, 0)]
    matches, n = jmat.search_by_descriptor(
        frame.desc_bits, frame.valid, jham.unpack_bits(state.kf_desc[cand]), kf_ok,
        frame.kp_angle, state.kf_kp_angle[cand], th=jham.TH_LOW, nn_ratio=0.75)
    matched = jnp.where(matches >= 0, kf_pts[jnp.clip(matches, 0)], -1)
    pose, inl, n_r, ok = jepnp.ransac_pnp(
        key, state.pt_pos[jnp.clip(matched, 0)], frame.kp_xy, 5.991 * sigma2, matched >= 0,
        300, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, min_inliers=10)
    m2 = jnp.where(inl, matched, -1)
    obs = jpo.PoseObs(pt_w=state.pt_pos[jnp.clip(m2, 0)], uv=frame.kp_xy, ur=frame.kp_ur,
                      inv_sigma2=inv_ls2[jnp.clip(frame.kp_octave, 0)], valid=m2 >= 0)
    pose2, inlier, n_opt = jpo.pose_optimization_xla(cam, pose, obs)
    return n, matched, n_r, ok, pose2, jnp.where(inlier, m2, -1), n_opt


def test_relocalizer_batch_matches_jax(reloc_case):
    js, jfr, ts, _ = reloc_case
    jrel, trel = js.tracker.relocalizer, ts.tracker.relocalizer
    jst = js.tracker.map
    tst, tfr = interop.map_state_from_numpy(jst), interop.frame_from_numpy(jfr)
    cands = jrel._candidates(jst, jfr)
    assert cands == trel.candidates(tst, tfr) and len(cands) == 2
    frame_id = 10
    key = jax.random.PRNGKey(frame_id * 131 + cands[0])
    keys = jax.random.split(key, jrel.max_candidates)
    ids = np.full(jrel.max_candidates, cands[0], np.int32)
    ids[:len(cands)] = cands
    n_j, pose_j, matched_j, nopt_j = (np.asarray(x) for x in jrel._batch(
        jst, jfr, jnp.asarray(ids), key))
    first = jax.jit(lambda c, k: _jax_first_stage(jrel, jst, jfr, c, k))
    stages = [[np.asarray(x) for x in first(jnp.asarray(c), keys[i])]
              for i, c in enumerate(cands)]
    hyp = np.stack([jax_hypotheses(keys[i], stages[i][1] >= 0, 300)
                    for i in range(len(cands))])
    r = trel.batch(tst, tfr, cands, frame_id, hyp_idx=_t(hyp))
    C = len(cands)
    np.testing.assert_array_equal(_np(r.n_matches), n_j[:C])
    np.testing.assert_array_equal(_np(r.ransac_inliers), [int(s[2]) for s in stages])
    ok = np.array([bool(s[3]) for s in stages]) & (n_j[:C] >= 15)
    assert ok.all()
    np.testing.assert_array_equal(_np(r.n_opt_first), [int(s[6]) for s in stages])
    np.testing.assert_array_equal(_np(r.take1), [int(s[6]) < 50 for s in stages])
    np.testing.assert_array_equal(_np(r.n_opt), nopt_j[:C])
    np.testing.assert_array_equal(_np(r.matched), matched_j[:C])
    assert np.abs(_np(r.pose) - pose_j[:C]).max() <= POSE_TOL
    best = int(np.argmax(nopt_j))
    out = trel.relocalize(tst, tfr, frame_id)
    assert nopt_j[best] >= 50 and out is not None and out[2] == nopt_j[best]


def _jax_re_search(reloc, state, frame, cand, pose, matched, th, dist_th):
    """JAX `Relocalizer`'s re_search closure (`relocalization.py:91-117`)."""
    kf_pts = state.kf_kp_point[cand]
    safe = jnp.clip(kf_pts, 0)
    ok = state.kf_kp_valid[cand] & (kf_pts >= 0) & state.pt_valid[safe]
    already = jnp.zeros(state.pt_capacity, bool).at[jnp.clip(matched, 0)].set(matched >= 0)
    ok = ok & ~already[safe]
    from orbslam_mapsave_tpu.geometry import projection as jproj

    new_m, _, _ = jmat.search_by_projection_points(
        reloc.cam, pose, frame.kp_xy, frame.kp_octave, frame.desc_bits, frame.valid,
        matched >= 0, state.pt_pos[safe], state.pt_normal[safe], state.pt_min_dist[safe],
        state.pt_max_dist[safe], jham.unpack_bits(state.pt_desc[safe]), ok,
        jproj.compute_image_bounds(reloc.cam), reloc.scale_factors, th=th,
        n_levels=reloc.n_levels, scale_factor=reloc.scale_factor_, dist_th=dist_th,
        use_ratio=False)
    return jnp.where((new_m >= 0) & (matched < 0), kf_pts[jnp.clip(new_m, 0)], matched)


@pytest.mark.parametrize("step", [(10.0, 100), (3.0, 64)])
def test_ladder_re_search_matches_jax(reloc_case, step):
    """One ladder step (re-search + pose LM) for every candidate from JAX's
    pose and matches after the first pose LM, with a third of those matches
    dropped so the re-search has points to find."""
    js, jfr, ts, _ = reloc_case
    jrel, trel = js.tracker.relocalizer, ts.tracker.relocalizer
    jst = js.tracker.map
    tst, tfr = interop.map_state_from_numpy(jst), interop.frame_from_numpy(jfr)
    cands = jrel._candidates(jst, jfr)
    key = jax.random.PRNGKey(5)
    poses, starts = [], []
    for i, c in enumerate(cands):
        s = jax.jit(lambda c, k: _jax_first_stage(jrel, jst, jfr, c, k))(
            jnp.asarray(c), jax.random.fold_in(key, i))
        m = np.asarray(s[5]).copy()
        m[::3] = -1
        poses.append(np.asarray(s[4]))
        starts.append(m)
    th, dist_th = step
    jnew = [np.asarray(jax.jit(lambda c, p, m: _jax_re_search(jrel, jst, jfr, c, p, m, th,
                                                               dist_th))(
        jnp.asarray(c), jnp.asarray(p), jnp.asarray(m))) for c, p, m in zip(cands, poses, starts)]
    cand = torch.as_tensor(cands)
    tnew = trel._re_search(tst, tfr, cand, _t(np.stack(poses)), _t(np.stack(starts)), th,
                           dist_th)
    np.testing.assert_array_equal(_np(tnew), np.stack(jnew))
    assert (np.stack(jnew) >= 0).sum() > (np.stack(starts) >= 0).sum()
    tp, tm, tn = trel._opt_pose(tst, tfr, _t(np.stack(poses)), tnew)
    for i, m in enumerate(jnew):
        obs = jpo.PoseObs(pt_w=jst.pt_pos[jnp.clip(m, 0)], uv=jfr.kp_xy, ur=jfr.kp_ur,
                          inv_sigma2=jnp.asarray(jrel.inv_level_sigma2)[
                              jnp.clip(jfr.kp_octave, 0)], valid=jnp.asarray(m) >= 0)
        p, inl, n = jax.jit(lambda p, o: jpo.pose_optimization_xla(jrel.cam, p, o))(
            jnp.asarray(poses[i]), obs)
        assert int(tn[i]) == int(n)
        np.testing.assert_array_equal(_np(tm[i]), np.where(np.asarray(inl), m, -1))
        assert np.abs(_np(tp[i]) - np.asarray(p)).max() <= POSE_TOL


# ---------------------------------------------------------------------------
# the localization-only step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("map_gone", [True, False])
def test_localization_step_matches_jax(reloc_case, map_gone):
    """One fused step in localization-only mode (`allow_kf` False) from the
    JAX run's control state after frame 5, on frame 6. With every map
    point that the last frame matched gone (`pt_valid` cleared), only the
    last frame's temporal points carry the motion model: map-less odometry
    (mb_vo), the pose from the motion model, the map untouched. With the
    map intact: an ordinary tracked frame, no keyframe. Both as JAX."""
    js, _, ts, frames = reloc_case
    jst, jctrl = js.tracker.map, js.tracker.ctrl
    if map_gone:
        lm = np.asarray(jctrl.last_matched)
        valid = np.asarray(jst.pt_valid).copy()
        valid[lm[lm >= 0]] = False
        jst = jst._replace(pt_valid=jnp.asarray(valid))
    jctrl = jctrl._replace(allow_kf=jnp.asarray(False))
    t, gray, depth = frames[6]
    jfr = js.builder.build(gray, t - js.tracker.ts_epoch, depth)
    jm2, jc2, jout = js.tracker.step(jst, jctrl, jfr)
    tm2, tc2, tout = ts.tracker.step(interop.map_state_from_numpy(jst),
                                     interop.control_from_numpy(jctrl),
                                     interop.frame_from_numpy(jfr))
    assert tout.mode == int(jout.mode) == 2
    assert tout.mb_vo == bool(jout.mb_vo) == map_gone == tc2.mb_vo
    assert not tout.kf_created and not bool(jout.kf_created)
    assert tout.n_inliers == int(jout.n_inliers)
    assert np.abs(_np(tout.pose) - np.asarray(jout.pose)).max() <= POSE_TOL
    np.testing.assert_array_equal(_np(tc2.last_matched), np.asarray(jc2.last_matched))
    tmn = interop.map_state_to_numpy(tm2)
    for k, v in jm2._asdict().items():
        np.testing.assert_array_equal(tmn[k], np.asarray(v), err_msg=k)
    if map_gone:  # the map is left as it was under mb_vo
        for k, v in jst._asdict().items():
            np.testing.assert_array_equal(tmn[k], np.asarray(v), err_msg=k)


# ---------------------------------------------------------------------------
# the batched pose-LM dispatcher
# ---------------------------------------------------------------------------


def test_batched_dispatcher_equals_single_calls():
    """B = 5 problems of M = 256 edges (relocalization's candidate batch at
    a small width) through `pose_optimization_batched` on the CPU: each
    problem's pose, inliers and count equal a B = 1 `pose_optimization`."""
    probs = [make_problem(256, seed=20 + b) for b in range(5)]
    obs = batch_obs(probs, "cpu")
    pose0 = torch.eye(4).expand(5, 4, 4).contiguous()
    pose, inl, n = tpo.pose_optimization_batched(CAM, pose0, obs)
    assert pose.shape == (5, 4, 4) and inl.shape == (5, 256) and n.shape == (5,)
    for b in range(5):
        p1, i1, n1 = tpo.pose_optimization(CAM, pose0[b], tpo.PoseObs(*[x[b] for x in obs]))
        assert torch.equal(pose[b], p1) and torch.equal(inl[b], i1) and int(n[b]) == int(n1)
