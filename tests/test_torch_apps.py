"""Parity: the port's application layer against the JAX package's, on the
CPU: the human-pose tracker (`apps/human_pose.OpDetector`: Kalman, 3D
lift, mask, gait angles) fed the same keypoints, and fed each package's
PoseNet from the same weights; the UDP robot's command generators and a
loopback exchange; ArUco; `bin_vocabulary` round trips, each package
reading the other's files; the native TUM loader (loaded and rebuilt)
against the Python one; `utils/metrics`.
"""

import socket
import time

import jax
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.apps import aruco as jaruco
from orbslam_mapsave_tpu.apps import bin_vocabulary as jbin
from orbslam_mapsave_tpu.apps import human_pose as jhp
from orbslam_mapsave_tpu.apps import udp_robot as judp
from orbslam_mapsave_tpu.models import pose_net as jpn
from orbslam_mapsave_tpu.vocab import vocabulary as jvoc
from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.apps import aruco as taruco
from orbslam_mapsave_tpu_torch.apps import bin_vocabulary as tbin
from orbslam_mapsave_tpu_torch.apps import human_pose as thp
from orbslam_mapsave_tpu_torch.apps import udp_robot as tudp
from orbslam_mapsave_tpu_torch.io import dataset, native_loader
from orbslam_mapsave_tpu_torch.models import pose_net as tpn
from orbslam_mapsave_tpu_torch.models import pose_synth
from orbslam_mapsave_tpu_torch.utils import metrics
from orbslam_mapsave_tpu_torch.vocab import vocabulary as tvoc

torch.set_num_threads(2)


def _oracle(joints, rng):
    """A backbone returning the rendered joints with noise, as numpy."""
    def backbone(gray):
        kp = np.c_[joints + rng.normal(0, 1.0, joints.shape), rng.uniform(0.3, 1.0, 25)]
        kp[3, 2] = 0.01  # one joint below the confidence gate
        return kp
    return backbone


def _run_detector(mod, backbone, img, depth, n=4):
    det = mod.OpDetector(backbone=backbone, fx=100.0, fy=100.0, cx=48.0, cy=48.0,
                         mask_radius=8)
    masks = [det.run_frame(img, depth) for _ in range(n)]
    return det, masks


def test_opdetector_equals_jax(tmp_path):
    img, joints = pose_synth.render_stick_figure(np.random.default_rng(7), 96, 96)
    depth = np.full((96, 96), 2.0, np.float32)
    depth[40:50, 40:50] = 0.0  # holes: the median window skips them
    jd, jm = _run_detector(jhp, _oracle(joints, np.random.default_rng(3)), img, depth)
    td, tm = _run_detector(thp, _oracle(joints, np.random.default_rng(3)), img, depth)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jd.joints_2d, td.joints_2d)
    np.testing.assert_array_equal(jd.joints_3d, td.joints_3d)
    np.testing.assert_array_equal(jd.joints_conf, td.joints_conf)
    assert jd.gait_angles() == td.gait_angles()
    jd.save_skeleton(tmp_path / "j.txt")
    td.save_skeleton(tmp_path / "t.txt")
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
    assert thp.JOINTS == jhp.JOINTS and thp.LINKS == jhp.LINKS and thp.HIP_C == jhp.HIP_C
    assert thp.OpDetector().run_frame(img, depth) is None  # no backbone
    # too few confident joints: no person
    weak = np.zeros((25, 3))
    assert thp.OpDetector(backbone=lambda g: weak).run_frame(img, None) is None


def test_opdetector_on_posenet_backbones():
    """Each package's PoseNet from the same flax weights as the backbone:
    the smoothed joints within 0.5 px, the same lifted depths where both
    sample the same pixel window, the same gait-angle keys."""
    net, params = jpn.init_params(jax.random.PRNGKey(5), 96, 96, 16)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tnet = tpn.PoseNet(16)
    tnet.load_state_dict(interop.pose_net_params_from_flax(flat))
    img, _ = pose_synth.render_stick_figure(np.random.default_rng(2), 96, 96)
    depth = np.full((96, 96), 2.0, np.float32)
    jd, jm = _run_detector(jhp, jpn.make_backbone(net, params), img, depth, n=2)
    td, tm = _run_detector(thp, tpn.make_backbone(tnet), img, depth, n=2)
    assert np.abs(jd.joints_2d - td.joints_2d).max() <= 0.5
    assert np.abs(jd.joints_3d[:, 2] - td.joints_3d[:, 2]).max() <= 1e-6
    assert jd.gait_angles().keys() == td.gait_angles().keys()
    assert (jm[-1] != tm[-1]).mean() < 0.02


def test_udp_commands_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        hip = (rng.uniform(-1.5, 1.5), 0.0, rng.choice([0.0, rng.uniform(0.2, 3.0)]))
        th, lo, hi = rng.uniform(2, 20), rng.uniform(0.5, 1.2), rng.uniform(1.5, 2.5)
        assert tudp.generate_rot_cmd(hip, th) == judp.generate_rot_cmd(hip, th)
        assert (tudp.generate_forward_cmd(hip, th, lo, hi)
                == judp.generate_forward_cmd(hip, th, lo, hi))
        assert tudp.generate_backward_cmd(hip, th, lo, hi) == 0
    for mode in (0, 1, 2):
        cfg = tcfg.UDPConfig(robot_mode=mode)
        r = tudp.UDPRobot(cfg)
        r.update_hip((0.5, 0.0, 2.5))
        j = judp.UDPRobot(type(cfg)(robot_mode=mode))
        j.update_hip((0.5, 0.0, 2.5))
        assert r.current_command() == j.current_command()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_udp_loopback():
    """The server thread sends the hip command to 127.0.0.1, the client
    thread receives it; stop() ends both."""
    port = _free_port()
    cfg = tcfg.UDPConfig(ip_client="127.0.0.1", port_in=port, port_out=port,
                         send_interval_ms=10, receiver_interval_ms=50)
    robot = tudp.UDPRobot(cfg)
    robot.update_hip((0.0, 0.0, 3.0))  # straight ahead, far: forward (1)
    robot.start()
    try:
        t0 = time.time()
        while len(robot.control_command) < 3 and time.time() - t0 < 10:
            time.sleep(0.01)
    finally:
        robot.stop()
    assert robot.control_command[:3] == [1, 1, 1]
    assert not any(th.is_alive() for th in robot._threads)


def _marker_image():
    cv2 = pytest.importorskip("cv2")
    if not hasattr(cv2, "aruco"):
        pytest.skip("cv2 without the aruco module: the detector is a no-op")
    d = cv2.aruco.getPredefinedDictionary(0)
    img = np.full((480, 640), 255, np.uint8)
    img[180:300, 260:380] = cv2.aruco.generateImageMarker(d, 7, 120)
    return img


def test_aruco_equals_jax():
    img = _marker_image()
    K = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]])
    rt = taruco.ArucoDetector(K=K).detect(img)
    rj = jaruco.ArucoDetector(K=K).detect(img)
    assert rt.ids.ravel().tolist() == rj.ids.ravel().tolist() == [7]
    np.testing.assert_array_equal(rt.tvecs, rj.tvecs)
    np.testing.assert_array_equal(rt.rvecs, rj.rvecs)
    assert np.isfinite(rt.tvecs).all() and rt.tvecs[0, 2] > 0


def _tables_equal(a, b, weight_atol=0.0):
    assert (a.k, a.L, a.n_words) == (b.k, b.L, b.n_words)
    for f in ("parent", "children", "desc", "word_id"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)
    np.testing.assert_allclose(a.weight, b.weight, rtol=0, atol=weight_atol)


def test_bin_vocabulary_round_trips(synthetic_tum, tmp_path, capsys):
    """--train on a TUM sequence (ORB on the CPU), then .bin -> .txt in the
    JAX tool, .txt -> .bin in the port's, .bin -> .txt in the port's, .txt
    -> .bin in the JAX tool: every file holds the trained tree, and each
    package loads the other's files. The text format writes weights with 6
    decimals (`save_text`, as the reference), so the text copies hold the
    weights within 5e-7 plus a float32 rounding (1e-6 for weights up to
    ~10); the files written from a text copy are equal byte for byte."""
    voc = tbin.main(["--train", str(synthetic_tum["root"]), str(tmp_path / "a.bin"),
                     "--k", "4", "--L", "2", "--max-frames", "3", "--device", "cpu"])
    assert "trained" in capsys.readouterr().out and voc.n_words > 4
    jbin.main([str(tmp_path / "a.bin"), str(tmp_path / "b.txt")])
    tbin.main([str(tmp_path / "b.txt"), str(tmp_path / "c.bin"), "--device", "cpu"])
    tbin.main([str(tmp_path / "c.bin"), str(tmp_path / "d.txt")])
    jbin.main([str(tmp_path / "d.txt"), str(tmp_path / "e.bin")])
    assert (tmp_path / "c.bin").read_bytes() == (tmp_path / "e.bin").read_bytes()
    assert (tmp_path / "b.txt").read_text() == (tmp_path / "d.txt").read_text()
    for mod in (tvoc, jvoc):
        _tables_equal(mod.load(tmp_path / "a.bin"), voc)
        for p in ("b.txt", "c.bin", "d.txt"):
            _tables_equal(mod.load(tmp_path / p), voc, weight_atol=1e-6)


def _same_frames(nat, py):
    assert len(nat) == len(py)
    assert (nat.height, nat.width) == (480, 640)
    for i in (0, 5, len(py) - 1):
        t_py, g_py, d_py = py[i]
        t_nat, g_nat, d_nat = nat[i]
        assert abs(t_py - t_nat) < 1e-9
        np.testing.assert_allclose(g_nat, g_py, atol=1.0)
        np.testing.assert_allclose(d_nat, d_py, atol=1e-4)


def test_native_loader_matches_python(synthetic_tum):
    """As `test_native_io.py`: the native loader (the repository's library)
    against the port's `TUMDataset`, and a sequential pass with prefetch."""
    assert native_loader.available()
    root = synthetic_tum["root"]
    _same_frames(native_loader.NativeTUMDataset(root), dataset.TUMDataset(root))
    seen = sum(1 for _, g, d in native_loader.NativeTUMDataset(root, prefetch=6)
               if g.shape == (480, 640) and d is not None)
    assert seen == len(dataset.TUMDataset(root))


def test_native_loader_builds_from_source(synthetic_tum, monkeypatch):
    """Where native/liborbtpu_io.so does not load, the loader builds
    native/orbtpu_io.cpp into the port's _build/ and reads the same frames."""
    monkeypatch.setattr(native_loader, "_PREBUILT", native_loader._ROOT / "native" / "absent.so")
    monkeypatch.setattr(native_loader, "_TRIED", False)
    monkeypatch.setattr(native_loader, "_LIB", None)
    lib = native_loader.get_lib()
    assert lib is not None and "_build" in lib._name
    root = synthetic_tum["root"]
    _same_frames(native_loader.NativeTUMDataset(root), dataset.TUMDataset(root))


def test_metrics(tmp_path):
    m = metrics.Metrics()
    m.count("frames")
    m.count("frames", 2)
    m.gauge("fps", 31)
    x = torch.ones(3)
    for _ in range(3):
        with m.stage("track", sync=x):
            x = x + 1
    with m.stage("empty", sync=[x, None]):
        pass
    s = m.summary()
    assert s["counters"] == {"frames": 3} and s["gauges"] == {"fps": 31.0}
    assert s["stages"]["track"]["n"] == 3 and s["stages"]["track"]["total_ms"] >= 0
    m.dump(tmp_path / "m.json")
    assert "median_ms" in (tmp_path / "m.json").read_text()
    with metrics.profiler_trace(tmp_path / "trace"):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
