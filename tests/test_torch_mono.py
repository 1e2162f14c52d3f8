"""The monocular slice in the JAX package and in the port, on the sequence
of `test_mono_slam.py` (14 frames, 8 cm sideways per frame, BoxRoom seed 9,
320x240, 600 ORB features, u8 images as its TUM PNGs store them), with
local mapping and no vocabulary.

The JAX system runs once per module; each test compares against that run:
the same bootstrap frame, the same keyframe frames and point count, poses
frame by frame within 5e-4 (f32 Jacobi SVDs and LM steps in another order;
measured 8.7e-5), Sim3-aligned ATE no worse than JAX's + 0.01 m. On the
JAX run's bootstrap inputs, `create_initial_map_mono` gives an equal map
(points within 1e-5) and `full_bundle_adjustment(robust=True, n_iters=20)`
poses within 1e-4 and points within 1e-3; the mono step from the JAX run's
control state gives its outcome and map."""

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu import config as jcfg
from orbslam_mapsave_tpu.optim import global_ba as jgba
from orbslam_mapsave_tpu.pipeline import system as jsys
from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.io import synthetic, trajectory
from orbslam_mapsave_tpu_torch.optim import global_ba as tgba
from orbslam_mapsave_tpu_torch.pipeline import fused_step as tfs
from orbslam_mapsave_tpu_torch.pipeline import system as tsys
from orbslam_mapsave_tpu_torch.pipeline import tracking as ttrk

torch.set_num_threads(2)
W, H, FX = 320, 240, 200.0
N = 14
POSE_TOL = 5e-4


def lateral_frames():
    """(timestamps, ground-truth Twc, u8 images) of test_mono_slam.py's
    sequence."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = np.tile(np.eye(4), (N, 1, 1))
    poses[:, 0, 3] = 0.08 * np.arange(N)
    poses[:, 2, 3] = -0.01 * np.arange(N)
    room = synthetic.BoxRoom(half_size=2.0, seed=9)
    images = [room.render(K, T, W, H)[0].astype(np.uint8) for T in poses]
    return 1000.0 + np.arange(N) / 30.0, poses, images


def make_system(cfg_mod, sys_mod, **kw):
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                                      bf=0.0, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 32, 8192
    return sys_mod.SLAMSystem(cfg, sys_mod.Sensor.MONOCULAR, enable_loop_closing=False,
                              **kw)


def _kf_ids(slam) -> list:
    fid, valid = (np.asarray(interop._numpy(x)) for x in (slam.map.kf_frame_id,
                                                          slam.map.kf_valid))
    return fid[valid].tolist()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX system over the sequence, outcomes read every frame, with the
    bootstrap's map-creation and GBA inputs / outputs and every per-frame
    step's inputs / outputs kept."""
    stamps, poses, images = lateral_frames()
    js = make_system(jcfg, jsys)
    js.tracker.fetch_every = 1
    rec = {"steps": {}}
    k = js.tracker.k
    create = k["create_initial_map_mono"]

    def create_kept(*a):
        out = create(*a)
        rec["create"] = (a, out)
        return out

    k["create_initial_map_mono"] = create_kept
    composed = js.tracker._composed_mono

    def composed_kept(state, ctrl, image, ts):
        out = composed(state, ctrl, image, ts)
        rec["steps"][js.tracker.frame_id] = ((state, ctrl), out)
        return out

    js.tracker._composed_mono = composed_kept
    gba = jgba.full_bundle_adjustment

    def gba_kept(*a, **kw):
        out = gba(*a, **kw)
        rec["gba"] = (a[1], out)
        return out

    jgba.full_bundle_adjustment = gba_kept
    try:
        for t, g in zip(stamps, images):
            js.track_monocular(g.astype(np.float32), t)
            js.tracker.flush()
    finally:
        jgba.full_bundle_adjustment = gba
    return js, rec


@pytest.fixture(scope="module")
def port_run():
    stamps, _, images = lateral_frames()
    ts = make_system(tcfg, tsys, device="cpu")
    for t, g in zip(stamps, images):
        ts.track_monocular(g, t)
    return ts


def test_bootstrap_keyframes_and_poses(jax_run, port_run):
    js, _ = jax_run
    jt, tt = js.tracker.trajectory, port_run.tracker.trajectory
    assert [l for _, _, l in tt] == [l for _, _, l in jt]
    boot = next(i for i, (_, _, l) in enumerate(jt) if not l)
    assert boot == 1  # the bootstrap pair is frames 0 and 1
    assert _kf_ids(port_run) == _kf_ids(js)
    assert port_run.n_points == js.n_points
    assert port_run.n_keyframes >= 4  # mapping passes ran on the step's keyframes
    err = max(np.abs(np.asarray(p) - q).max() for (_, p, _), (_, q, _) in zip(jt, tt))
    assert err <= POSE_TOL


def test_sim3_ate(jax_run, port_run):
    stamps, poses, _ = lateral_frames()

    def ate(traj):
        ok = [i for i, (_, _, l) in enumerate(traj) if not l]
        est = np.linalg.inv(np.asarray([traj[i][1] for i in ok], np.float64))
        return trajectory.ate_rmse(stamps, poses, stamps[ok], est, with_scale=True)

    a_t, a_j = ate(port_run.tracker.trajectory), ate(jax_run[0].tracker.trajectory)
    assert a_t <= a_j + 0.01 and a_t < 0.06  # test_mono_slam.py's bound


def test_create_initial_map_and_bootstrap_gba(jax_run):
    js, rec = jax_run
    args, jout = rec["create"]
    state, f1, f2, fid1, fid2, m12, R21, t21, X, good = args
    tk = make_system(tcfg, tsys, device="cpu").tracker.k
    tensors = [interop._tensor(x, "cpu") for x in (m12, R21, t21, X, good)]
    tout = tk["create_initial_map_mono"](
        interop.map_state_from_numpy(state), interop.frame_from_numpy(f1),
        interop.frame_from_numpy(f2), int(fid1), int(fid2), *tensors)
    assert (tout[1], tout[2]) == (int(jout[1]), int(jout[2]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))  # matched2
    assert int(tout[4]) == int(jout[4]) > 100
    np.testing.assert_allclose(float(tout[5]), float(jout[5]), rtol=1e-6)
    tm, jm = interop.map_state_to_numpy(tout[0]), jout[0]._asdict()
    for key, v in jm.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(tm[key], v, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(tm[key], v, err_msg=key)
    # the 20 robust dense GBA iterations on the JAX run's created map
    jstate, (jposes, jpts, jcost) = rec["gba"]
    ts = make_system(tcfg, tsys, device="cpu")
    cam = ts.cam
    poses, pts, cost = tgba.full_bundle_adjustment(
        cam, interop.map_state_from_numpy(jstate), ts.builder.inv_level_sigma2_t,
        n_iters=20, robust=True, solver="dense")
    valid = np.asarray(jstate.kf_valid)
    np.testing.assert_allclose(poses.numpy()[valid], np.asarray(jposes)[valid], atol=1e-4)
    pv = np.asarray(jstate.pt_valid)
    np.testing.assert_allclose(pts.numpy()[pv], np.asarray(jpts)[pv], rtol=1e-3, atol=1e-3)
    assert float(cost) <= float(jcost) * (1 + 1e-3)
    # the pcg route on the same map (one free keyframe: CG is exact in a few
    # steps) lands where the dense route does
    pp, xp, cp = tgba.full_bundle_adjustment(
        cam, interop.map_state_from_numpy(jstate), ts.builder.inv_level_sigma2_t,
        n_iters=20, robust=True, solver="pcg")
    np.testing.assert_allclose(pp.numpy()[valid], poses.numpy()[valid], atol=1e-4)
    np.testing.assert_allclose(xp.numpy()[pv], pts.numpy()[pv], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(cp), float(cost), rtol=1e-3)


@pytest.mark.parametrize("kf_frame", [False, True])
def test_mono_step_from_jax_state(jax_run, kf_frame):
    """One port step on the JAX run's own map, control state and frame: the
    same outcome and map, on a frame that makes a keyframe (with its
    mapping pass) and on one that does not."""
    js, rec = jax_run
    kf_frames = set(_kf_ids(js))
    at = next(f for f in sorted(rec["steps"]) if (f in kf_frames) == kf_frame)
    (jmap, jctrl), (jm2, jc2, jout) = rec["steps"][at]
    frame = interop.frame_from_numpy(jc2.last_frame)
    step = make_system(tcfg, tsys, device="cpu").tracker.step
    tm2, tc2, tout = step(interop.map_state_from_numpy(jmap),
                          interop.control_from_numpy(jctrl), frame)
    assert tout.mode == int(jout.mode) == tfs.MODE_OK
    assert tout.kf_created == bool(jout.kf_created) == kf_frame
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
            np.testing.assert_allclose(tmn[k], v, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(tmn[k], v, err_msg=k)


def test_not_initialized_frame_passes_through(jax_run):
    """A mono step in NOT_INITIALIZED mode leaves the map alone (the
    bootstrap runs on the host; JAX `fused_step.py:394`)."""
    js, rec = jax_run
    (jmap, jctrl), (_, jc2, _) = rec["steps"][min(rec["steps"])]
    ctrl = interop.control_from_numpy(jctrl)._replace(mode=tfs.MODE_NOT_INITIALIZED)
    tmap = interop.map_state_from_numpy(jmap)
    tm2, tc2, tout = make_system(tcfg, tsys, device="cpu").tracker.step(
        tmap, ctrl, interop.frame_from_numpy(jc2.last_frame))
    assert tm2 is tmap and not tout.kf_created
    assert tout.mode == tc2.mode == tfs.MODE_NOT_INITIALIZED
    assert tc2.frame_id == ctrl.frame_id + 1


def test_tracker_config_per_sensor():
    """local_th 1 for every sensor but RGB-D (JAX `system.py:74-82`)."""
    mono = make_system(tcfg, tsys, device="cpu")
    assert mono.tracker.cfg.is_mono and mono.tracker.cfg.local_th == 1.0
    assert mono.mapper.is_mono and mono.mapper.n_tri_neighbors == 20
    assert isinstance(mono.tracker, ttrk.Tracker)
    with pytest.raises(ValueError):
        mono.track_rgbd(np.zeros((H, W), np.uint8), np.zeros((H, W), np.float32), 0.0)


def test_run_slam_mono(tmp_path):
    """`run_slam --sensor mono --device cpu` on a TUM copy of the first 5
    frames (at this file's capacities): bootstraps on frame 1 and tracks the
    rest (`--sensor stereo` is held in test_torch_stereo.py)."""
    from orbslam_mapsave_tpu_torch.apps import run_slam

    _, poses, _ = lateral_frames()
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    seq = synthetic.write_tum_sequence(tmp_path / "seq", K, poses[:5], width=W, height=H,
                                       seed=9)
    cam = tmp_path / "cam.yaml"
    cam.write_text("%YAML:1.0\n" + "\n".join(f"{k}: {v}" for k, v in {
        "Camera.fx": FX, "Camera.fy": FX, "Camera.cx": W / 2, "Camera.cy": H / 2,
        "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
        "Camera.width": W, "Camera.height": H, "Camera.fps": 30.0, "Camera.bf": 0.0,
        "ORBextractor.nFeatures": 600, "ORBextractor.scaleFactor": 1.5,
        "ORBextractor.nLevels": 4, "ORBextractor.iniThFAST": 20,
        "ORBextractor.minThFAST": 7}.items()) + "\n")
    base = ["--dataset", str(seq), "--camera-yaml", str(cam), "--device", "cpu"]
    systems = []
    init = tsys.SLAMSystem.__init__

    def keep(self, cfg, *a, **k):
        # the test's capacities: the bootstrap's dense GBA at run_slam's
        # default ones (512 keyframes, 65,536 points) is card work
        cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 32, 8192
        init(self, cfg, *a, **k)
        systems.append(self)

    tsys.SLAMSystem.__init__ = keep
    try:
        run_slam.main(base + ["--sensor", "mono", "--out", str(tmp_path / "a.txt"),
                              "--kf-out", str(tmp_path / "ak.txt")])
    finally:
        tsys.SLAMSystem.__init__ = init
    (slam,) = systems
    assert slam.sensor == tsys.Sensor.MONOCULAR and slam.device.type == "cpu"
    assert [l for _, _, l in slam.tracker.trajectory] == [True] + [False] * 4
    assert slam.n_keyframes >= 2
    assert len((tmp_path / "a.txt").read_text().splitlines()) >= 4
