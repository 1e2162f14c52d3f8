"""The RGB-D slice end to end, in the JAX package and in the port, with no
vocabulary (320x240, 600 ORB features, 32 keyframe / 8192 point capacity).

Tracking only (`enable_mapping=False`), on the sequence of
`test_rgbd_slam.py` (10 frames): frame by frame the same lost flags, the
same keyframe frames, the same point count, poses within 1e-4.

Tracking + local mapping (the default), on a 14-frame orbit with a wider
yaw on which the JAX package makes keyframes at frames 0, 4, 7 and 13, so
local BA and keyframe culling run at frames 7 and 13: frame by frame the
same lost flags, keyframe frames, keyframe and point counts, poses within
1e-3."""

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu import config as jcfg
from orbslam_mapsave_tpu.pipeline import system as jsys
from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.io import dataset, synthetic, trajectory
from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda
from orbslam_mapsave_tpu_torch.pipeline import system as tsys

torch.set_num_threads(2)
W, H = 320, 240
FX = 200.0


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    out = tmp_path_factory.mktemp("rgbd_seq_torch")
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synthetic.orbit_trajectory(10, radius=0.4, yaw_range=0.4)
    synthetic.write_tum_sequence(out, K, poses, width=W, height=H, seed=5,
                                 depth_factor=5000.0)
    return {"root": out, "poses": poses}


def _system(cfg_mod, sys_mod, max_points=8192, enable_mapping=False, vocabulary=None,
            **kw):
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=FX * 0.08, th_depth=50.0, depth_map_factor=5000.0, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints = 768
    cfg.max_keyframes = 32
    cfg.max_points = max_points
    return sys_mod.SLAMSystem(cfg, sys_mod.Sensor.RGBD, vocabulary=vocabulary,
                              enable_loop_closing=False, enable_mapping=enable_mapping,
                              **kw)


@pytest.fixture(scope="module")
def runs(seq):
    js = _system(jcfg, jsys)
    ts = _system(tcfg, tsys, device="cpu")
    rows = []
    for t, gray, depth in dataset.TUMDataset(seq["root"], depth_factor=5000.0):
        js.track_rgbd(gray, depth, t)
        js.tracker.flush()
        ts.track_rgbd(gray, depth, t)
        rows.append(dict(j=js.tracker.trajectory[-1], t=ts.tracker.trajectory[-1],
                         jn=(js.n_keyframes, js.n_points),
                         tn=(ts.n_keyframes, ts.n_points)))
    return js, ts, rows


def test_frame_by_frame(runs):
    _, _, rows = runs
    assert len(rows) == 10
    for i, r in enumerate(rows):
        (tj, pj, lj), (tt, pt, lt) = r["j"], r["t"]
        assert tj == tt and lj == lt, i
        assert r["jn"] == r["tn"], (i, r["jn"], r["tn"])
        assert np.abs(pj - pt).max() <= 1e-4, (i, np.abs(pj - pt).max())
    assert not any(r["t"][2] for r in rows)


def test_keyframes_and_map(runs):
    js, ts, _ = runs
    jv = np.asarray(js.map.kf_valid)
    np.testing.assert_array_equal(np.asarray(js.map.kf_frame_id)[jv],
                                  ts.map.kf_frame_id.numpy()[ts.map.kf_valid.numpy()])
    assert js.n_points == ts.n_points > 200
    np.testing.assert_allclose(np.asarray(js.map.kf_pose)[jv],
                               ts.map.kf_pose.numpy()[jv], atol=1e-4)


def test_stereo_keyframe_trajectory_matches_jax(runs, tmp_path):
    """`save_stereo_keyframe_trajectory` (per-frame [Rwc|twc] rows, the
    first keyframe at the origin): the same rows as JAX's within 1e-4."""
    js, ts, _ = runs
    js.save_stereo_keyframe_trajectory(tmp_path / "j.txt")
    ts.save_stereo_keyframe_trajectory(tmp_path / "t.txt")
    rj, rt = (np.loadtxt(tmp_path / f) for f in ("j.txt", "t.txt"))
    assert rj.shape == rt.shape == (10, 12)
    np.testing.assert_allclose(rt, rj, atol=1e-4)


def test_trajectory_quality(runs, seq):
    _, ts, _ = runs
    gt_ts = 1000.0 + np.arange(len(seq["poses"])) / 30.0
    est = [(t, np.linalg.inv(T)) for t, T, lost in ts.tracker.trajectory if not lost]
    ate = trajectory.ate_rmse(gt_ts, seq["poses"], np.array([e[0] for e in est]),
                              np.array([e[1] for e in est]))
    assert ate < 0.05


def test_change_calibration_as_jax(seq, tmp_path):
    """`change_calibration` after 5 tracked frames, to a settings file with
    another baseline, depth threshold and principal point (half a pixel
    off): both packages rebuild the camera, the frame builder's tables and
    the tracker's depth threshold alike, and track the next 5 frames to the
    same lost flags, keyframe and point counts and poses within 1e-4."""
    yaml = tmp_path / "cam2.yaml"
    yaml.write_text("%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in {
        "Camera.fx": FX, "Camera.fy": FX, "Camera.cx": W / 2 + 0.5, "Camera.cy": H / 2,
        "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
        "Camera.width": W, "Camera.height": H, "Camera.fps": 30.0,
        "Camera.bf": FX * 0.1, "ThDepth": 40.0, "DepthMapFactor": 5000.0}.items()))
    js = _system(jcfg, jsys)
    ts = _system(tcfg, tsys, device="cpu")
    frames = list(dataset.TUMDataset(seq["root"], depth_factor=5000.0))
    rows = []
    for i, (t, gray, depth) in enumerate(frames):
        if i == 5:
            js.tracker.flush()
            js.change_calibration(yaml)
            ts.change_calibration(yaml)
            jc, tc = js.cam, ts.cam
            for f in ("fx", "fy", "cx", "cy", "bf", "width", "height"):
                assert float(getattr(jc, f)) == float(getattr(tc, f)), f
            assert float(tc.cx) == W / 2 + 0.5 and float(tc.bf) == FX * 0.1
            np.testing.assert_array_equal(np.asarray(js.builder.bounds), ts.builder.bounds)
            np.testing.assert_array_equal(np.asarray(js.builder.inv_level_sigma2),
                                          ts.builder.inv_level_sigma2)
            assert js.tracker.cfg.th_depth == ts.tracker.cfg.th_depth == 0.1 * 40.0
            assert ts.tracker.builder is ts.builder and ts.tracker.cam is tc
            assert float(ts.tracker.K[0, 2]) == W / 2 + 0.5
        js.track_rgbd(gray, depth, t)
        js.tracker.flush()
        ts.track_rgbd(gray, depth, t)
        rows.append((js.tracker.trajectory[-1], ts.tracker.trajectory[-1],
                     (js.n_keyframes, js.n_points), (ts.n_keyframes, ts.n_points)))
    for i, ((_, pj, lj), (_, pt, lt), nj, nt) in enumerate(rows):
        assert lj == lt and nj == nt, (i, nj, nt)
        assert np.abs(pj - pt).max() <= 1e-4, (i, np.abs(pj - pt).max())
    assert not any(r[1][2] for r in rows)


@pytest.mark.parametrize("at", [3, 5])
def test_step_from_jax_state(seq, at):
    """One port step on the JAX run's own map, control state and frame
    (handed over through `interop`): the same outcome and map. Frame 5
    creates a keyframe on this sequence, frame 3 does not."""
    js = _system(jcfg, jsys)
    frames = list(dataset.TUMDataset(seq["root"], depth_factor=5000.0))
    for t, gray, depth in frames[:at]:
        js.track_rgbd(gray, depth, t)
    js.tracker.flush()
    t, gray, depth = frames[at]
    jfr = js.builder.build(gray, t - js.tracker.ts_epoch, depth)
    jmap, jctrl = js.tracker.map, js.tracker.ctrl
    tmap = interop.map_state_from_numpy(jmap)
    tctrl = interop.control_from_numpy(jctrl)
    tfr = interop.frame_from_numpy(jfr)
    np.testing.assert_array_equal(interop.frame_to_numpy(tfr)["desc"],
                                  np.asarray(jfr.desc))
    step = _system(tcfg, tsys, device="cpu").tracker.step
    tm2, tc2, tout = step(tmap, tctrl, tfr)
    jm2, jc2, jout = js.tracker.step(jmap, jctrl, jfr)
    assert tout.mode == int(jout.mode)
    assert tout.kf_created == bool(jout.kf_created) == (at == 5)
    assert tout.kf_slot == int(jout.kf_slot)
    assert tout.n_inliers == int(jout.n_inliers)
    assert np.abs(tout.pose.numpy() - np.asarray(jout.pose)).max() <= 1e-4
    tc = interop.control_to_numpy(tc2)
    np.testing.assert_array_equal(tc["last_matched"], np.asarray(jc2.last_matched))
    assert tc["ref_kf"] == int(jc2.ref_kf) and tc["frame_id"] == int(jc2.frame_id)
    tmn = interop.map_state_to_numpy(tm2)
    for k, v in jm2._asdict().items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(tmn[k], v, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(tmn[k], v, err_msg=k)


def test_compaction_matches_jax(seq, monkeypatch):
    """With 1024 point slots the second keyframe pushes the allocator past
    90% and both systems compact the map (slot recycling) mid-sequence."""
    from orbslam_mapsave_tpu_torch.slammap import mapstate

    calls = []
    compact = mapstate.compact_points
    monkeypatch.setattr(mapstate, "compact_points",
                        lambda st: calls.append(1) or compact(st))
    js = _system(jcfg, jsys, max_points=1024)
    ts = _system(tcfg, tsys, max_points=1024, device="cpu")
    for t, gray, depth in dataset.TUMDataset(seq["root"], depth_factor=5000.0):
        js.track_rgbd(gray, depth, t)
        js.tracker.flush()
        ts.track_rgbd(gray, depth, t)
        (_, pj, lj), (_, pt, lt) = js.tracker.trajectory[-1], ts.tracker.trajectory[-1]
        assert lj == lt and np.abs(pj - pt).max() <= 1e-4
        assert (js.n_keyframes, js.n_points) == (ts.n_keyframes, ts.n_points)
    assert len(calls) > 0
    np.testing.assert_array_equal(np.asarray(js.map.kf_kp_point),
                                  ts.map.kf_kp_point.numpy())


def test_lost_right_after_init_resets(seq):
    """A frame with no features is lost; with <= 5 keyframes the system
    starts over (`src/Tracking.cc:712-718`) and the next frame initializes
    a fresh map."""
    from orbslam_mapsave_tpu_torch.pipeline import tracking

    ts = _system(tcfg, tsys, device="cpu")
    frames = list(dataset.TUMDataset(seq["root"], depth_factor=5000.0))
    for t, gray, depth in frames[:3]:
        ts.track_rgbd(gray, depth, t)
    assert ts.tracking_state == tracking.OK
    t, gray, depth = frames[3]
    ts.track_rgbd(np.zeros_like(gray), np.zeros_like(depth), t)
    assert ts.tracking_state == tracking.NO_IMAGES_YET
    assert ts.n_keyframes == 0 and ts.tracker.trajectory == []
    t, gray, depth = frames[4]
    ts.track_rgbd(gray, depth, t)
    assert ts.tracking_state == tracking.OK and ts.n_keyframes == 1


def _hold_off_reset(tracker, hook: str):
    """Keep the lost-after-init reset flag down after each outcome read
    (`_record` in the port, `flush` in JAX), so a loss with few keyframes
    takes the relocalization path."""
    read = getattr(tracker, hook)

    def read_past_the_ladder(*a):
        read(*a)
        tracker.needs_reset = False

    setattr(tracker, hook, read_past_the_ladder)


def _counting(reloc, hits: list):
    """Wrap a Relocalizer's `relocalize` to note each call's success."""
    relocalize = reloc.relocalize

    def counted(*a):
        out = relocalize(*a)
        hits.append(out is not None)
        return out

    reloc.relocalize = counted


KIDNAP = [0, 1, 2, 3, 4, 5, None, 2, 3, 4, 5, 6, 7, 8, 9]  # None: a blank frame


@pytest.mark.parametrize("with_vocabulary", [False, True])
def test_lost_later_relocalizes_as_jax(seq, tmp_path, with_vocabulary):
    """Lost on a blank frame after frames 0-5 (past the early-reset ladder:
    its flag held off in both packages), then the camera jumps back to
    frame 2's view and the sequence runs on to frame 9. Both packages
    relocalize through their Relocalizer on the first frame after the blank
    — without a vocabulary over the newest keyframes, with one (and loop
    closing on, so a BoW store exists) over BoW candidates — to the same
    pose, and track on with the same states and keyframes: poses within
    1e-4, frame by frame. The JAX tracker reads its outcomes every frame,
    as the port does."""
    from orbslam_mapsave_tpu_torch.pipeline import tracking
    from orbslam_mapsave_tpu_torch.vocab import vocabulary

    frames = list(dataset.TUMDataset(seq["root"], depth_factor=5000.0))
    kw_t, kw_j = {}, {}
    if with_vocabulary:
        fr = _system(tcfg, tsys, device="cpu").builder.build(frames[0][1], 0.0, frames[0][2])
        voc = vocabulary.train(fr.desc[fr.valid].numpy(), k=4, L=2, seed=1)
        vocabulary.save_binary(tmp_path / "voc.bin", voc)
        from orbslam_mapsave_tpu.vocab import vocabulary as jvocabulary

        kw_t, kw_j = dict(vocabulary=voc), dict(vocabulary=jvocabulary.load_binary(
            tmp_path / "voc.bin"))
    systems = []
    for cfg_mod, sys_mod, kw, hook in ((jcfg, jsys, kw_j, "flush"),
                                       (tcfg, tsys, dict(kw_t, device="cpu"), "_record")):
        s = _system(cfg_mod, sys_mod, **kw)
        if with_vocabulary:  # _system turns loop closing off; the BoW store needs it
            s = sys_mod.SLAMSystem(s.cfg, sys_mod.Sensor.RGBD, enable_mapping=False, **kw)
        _hold_off_reset(s.tracker, hook)
        hits: list = []
        _counting(s.tracker.relocalizer, hits)
        systems.append((s, hits))
    (js, jhits), (ts, thits) = systems
    js.tracker.fetch_every = 1
    blank = (np.zeros_like(frames[0][1]), np.zeros_like(frames[0][2]))
    for j, i in enumerate(KIDNAP):
        gray, depth = blank if i is None else frames[i][1:]
        t = 1000.0 + j / 30.0
        js.track_rgbd(gray, depth, t)
        ts.track_rgbd(gray, depth, t)
        assert js.tracker.state == ts.tracker.state, j
        assert (js.n_keyframes, js.n_points) == (ts.n_keyframes, ts.n_points), j
        pj, pt = np.asarray(js.tracker.ctrl.pose), ts.tracker.ctrl.pose.numpy()
        assert np.abs(pj - pt).max() <= 1e-4, (j, np.abs(pj - pt).max())
        if i is None:
            assert ts.tracking_state == tracking.LOST
    # one failed attempt on the blank frame, one success on the next
    assert thits == jhits == [False, True]
    assert [lost for _, _, lost in ts.tracker.trajectory] == [i is None or j == 7
                                                              for j, i in enumerate(KIDNAP)]
    if with_vocabulary:
        assert ts.loop_closer.bow_store is not None


def test_cpu_run_used_plain_pose_opt(runs):
    assert pose_opt_cuda.launches == 0


def test_device_defaults_to_the_card(monkeypatch):
    """With no card, SLAMSystem without `device` raises and names the fix;
    `device="cpu"` still runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _system(tcfg, tsys)
    ts = _system(tcfg, tsys, device="cpu")
    assert ts.device.type == "cpu" and ts.builder.device.type == "cpu"
    assert ts.map.pt_pos.device.type == "cpu"


def test_stereo_system_builds_as_jax():
    """A STEREO system builds (stereo was the last sensor to port) with the
    JAX package's tracker settings: motion-model window 7, local search
    threshold 1 (JAX `system.py:76-81`, `Tracking.cc:1127,1445-1450`)."""
    ts = tsys.SLAMSystem(tcfg.SystemConfig(), tsys.Sensor.STEREO, device="cpu")
    js = jsys.SLAMSystem(jcfg.SystemConfig(), jsys.Sensor.STEREO)
    assert ts.tracker.cfg.motion_th == js.tracker.cfg.motion_th == 7.0
    assert ts.tracker.cfg.local_th == js.tracker.cfg.local_th == 1.0
    assert not ts.tracker.cfg.is_mono and ts.loop_closer is None


@pytest.fixture(scope="module")
def mapping_runs(tmp_path_factory):
    """Both systems with mapping over the 14-frame orbit; the port's local
    BA and keyframe culling calls are counted."""
    from orbslam_mapsave_tpu_torch.optim import local_ba
    from orbslam_mapsave_tpu_torch.pipeline import local_mapping

    out = tmp_path_factory.mktemp("rgbd_seq_mapping")
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synthetic.orbit_trajectory(14, radius=0.4, yaw_range=1.6)
    synthetic.write_tum_sequence(out, K, poses, width=W, height=H, seed=5,
                                 depth_factor=5000.0)
    calls = {"ba": 0, "cull": 0}
    ba, cull = local_ba.local_bundle_adjustment, local_mapping.keyframe_culling

    def counted(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    local_ba.local_bundle_adjustment = counted("ba", ba)
    local_mapping.keyframe_culling = counted("cull", cull)
    try:
        js = _system(jcfg, jsys, enable_mapping=True)
        ts = _system(tcfg, tsys, enable_mapping=True, device="cpu")
        rows = []
        for t, gray, depth in dataset.TUMDataset(out, depth_factor=5000.0):
            js.track_rgbd(gray, depth, t)
            js.tracker.flush()
            ts.track_rgbd(gray, depth, t)
            rows.append(dict(j=js.tracker.trajectory[-1], t=ts.tracker.trajectory[-1],
                             jn=(js.n_keyframes, js.n_points),
                             tn=(ts.n_keyframes, ts.n_points)))
    finally:
        local_ba.local_bundle_adjustment, local_mapping.keyframe_culling = ba, cull
    return js, ts, rows, calls


def test_mapping_frame_by_frame(mapping_runs):
    js, ts, rows, calls = mapping_runs
    assert len(rows) == 14 and not any(r["t"][2] for r in rows)
    for i, r in enumerate(rows):
        (tj, pj, lj), (tt, pt, lt) = r["j"], r["t"]
        assert tj == tt and lj == lt, i
        assert r["jn"] == r["tn"], (i, r["jn"], r["tn"])
        assert np.abs(pj - pt).max() <= 1e-3, (i, np.abs(pj - pt).max())
    jv = np.asarray(js.map.kf_valid)
    np.testing.assert_array_equal(np.asarray(js.map.kf_frame_id)[jv],
                                  ts.map.kf_frame_id.numpy()[ts.map.kf_valid.numpy()])
    assert int(jv.sum()) >= 4
    # local BA and keyframe culling ran at every keyframe after the second
    assert calls["ba"] == calls["cull"] == int(jv.sum()) - 2
    assert ts.tracker.ba_lanes_dropped == js.tracker.ba_lanes_dropped == 0
    assert ts.mapper.recent_start is None and ts.tracker.ctrl.recent_start > 0
