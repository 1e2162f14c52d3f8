"""Parity: the port's stereo path against the JAX package, on the stereo
pair and the 8-frame orbit of `test_stereo.py` (a BoxRoom rendered from the
left camera and from it moved 0.12 m along its x axis, 320x240, u8 images).

- `compute_stereo_matches` fed the same (JAX-extracted) keypoints: the same
  matched set, ur within 1e-4 px, depth within 1e-5 relative.
- `FrameBuilder.build_stereo`: the same keypoints, >= 99.5% of the
  descriptors bit-exact (ORB rounding ties, `test_torch_orb.py`), the same
  matched set, ur within 1e-4 px, depth within 1e-5 relative.
- `SLAMSystem.track_stereo` over the 8-frame orbit with local mapping and
  no loop closing (`test_stereo_slam_end_to_end`): frame by frame the same
  lost flags and keyframe / point counts, poses within 1e-3 (the tolerance
  of `test_torch_slice.py`'s mapping runs); the keyframes' frames equal.
- `run_slam --sensor stereo --device cpu` on a 5-frame KITTI-layout copy.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orbslam_mapsave_tpu import config as jcfg
from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.ops import hamming as jham
from orbslam_mapsave_tpu.ops import orb as jorb
from orbslam_mapsave_tpu.ops import stereo as jst
from orbslam_mapsave_tpu.pipeline import frame as jframe
from orbslam_mapsave_tpu.pipeline import system as jsys
from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.ops import orb as torb
from orbslam_mapsave_tpu_torch.ops import stereo as tst
from orbslam_mapsave_tpu_torch.pipeline import frame as tframe
from orbslam_mapsave_tpu_torch.pipeline import system as tsys

torch.set_num_threads(2)
W, H, FX, BASELINE = 320, 240, 200.0, 0.12
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
UR_TOL, DEPTH_RTOL, POSE_TOL = 1e-4, 1e-5, 1e-3


def _right(Twc: np.ndarray) -> np.ndarray:
    out = Twc.copy()
    out[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([BASELINE, 0, 0])
    return out


def _u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@lru_cache(maxsize=1)
def _pair():
    room = synthetic.BoxRoom(half_size=2.0, seed=7)
    return _u8(room.render(K, np.eye(4), W, H)[0]), _u8(room.render(K, _right(np.eye(4)), W,
                                                                    H)[0])


def _spec(mod):
    return mod.ORBSpec.create(H, W, n_features=600, n_levels=4, scale_factor=1.5, max_kp=768)


def _cams():
    kw = dict(bf=FX * BASELINE, width=W, height=H)
    return (jproj.Camera.create(FX, FX, W / 2, H / 2, **kw),
            tproj.Camera.create(FX, FX, W / 2, H / 2, **kw))


def _same_matches(ur_t, d_t, ur_j, d_j):
    ur_t, d_t, ur_j, d_j = (np.asarray(x) for x in (ur_t, d_t, ur_j, d_j))
    has = d_j > 0
    np.testing.assert_array_equal(d_t > 0, has)
    np.testing.assert_array_equal(ur_t[~has], ur_j[~has])
    np.testing.assert_allclose(ur_t[has], ur_j[has], atol=UR_TOL)
    np.testing.assert_allclose(d_t[has], d_j[has], rtol=DEPTH_RTOL)
    return int(has.sum())


def test_compute_stereo_matches():
    left, right = _pair()
    spec_j, spec_t = _spec(jorb), _spec(torb)
    jl, jr = (jax.jit(lambda im: jorb.extract(spec_j, im))(jnp.asarray(im, jnp.float32))
              for im in (left, right))
    args = []
    for kp in (jl, jr):
        args.append((kp["xy"], kp["octave"], jham.unpack_bits(kp["desc"]), kp["valid"]))
    ur_j, d_j = jax.jit(lambda a, b, l, r: jst.compute_stereo_matches(
        spec_j, a, b, *l, *r, bf=FX * BASELINE, fx=FX))(
        jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32), *args)
    targs = [tuple(torch.from_numpy(np.array(x)) for x in a) for a in args]
    ur_t, d_t = tst.compute_stereo_matches(
        spec_t, torch.from_numpy(left).float(), torch.from_numpy(right).float(),
        *targs[0], *targs[1], bf=FX * BASELINE, fx=FX)
    n = _same_matches(ur_t, d_t, ur_j, d_j)
    assert n >= 0.4 * int(np.asarray(jl["valid"]).sum())


def test_build_stereo():
    left, right = _pair()
    jc, tc = _cams()
    fj = jframe.FrameBuilder(jc, _spec(jorb)).build_stereo(left, right, 0.0)
    ft = tframe.FrameBuilder(tc, _spec(torb), "cpu").build_stereo(left, right, 0.0)
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    assert (ft.desc.numpy() == np.asarray(fj.desc)).all(-1)[ft.valid.numpy()].mean() >= 0.995
    np.testing.assert_array_equal(ft.kp_octave.numpy(), np.asarray(fj.kp_octave))
    np.testing.assert_allclose(ft.kp_xy_raw.numpy(), np.asarray(fj.kp_xy_raw), atol=1e-4)
    np.testing.assert_allclose(ft.kp_xy.numpy(), np.asarray(fj.kp_xy), atol=1e-4)
    assert _same_matches(ft.kp_ur, ft.kp_depth, fj.kp_ur, fj.kp_depth) > 200


def _system(cfg_mod, sys_mod, **kw):
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                                      bf=FX * BASELINE, th_depth=35.0, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 32, 8192
    return sys_mod.SLAMSystem(cfg, sys_mod.Sensor.STEREO, enable_loop_closing=False, **kw)


def test_stereo_slam_matches_jax():
    room = synthetic.BoxRoom(half_size=2.0, seed=7)
    poses = synthetic.orbit_trajectory(8, radius=0.4, yaw_range=0.4)
    js, ts = _system(jcfg, jsys), _system(tcfg, tsys, device="cpu")
    assert ts.tracker.cfg.motion_th == js.tracker.cfg.motion_th == 7.0
    assert ts.tracker.cfg.local_th == js.tracker.cfg.local_th == 1.0
    js.tracker.fetch_every = 1
    for i, Twc in enumerate(poses):
        left = _u8(room.render(K, Twc, W, H)[0])
        right = _u8(room.render(K, _right(Twc), W, H)[0])
        js.track_stereo(left, right, i / 30.0)
        js.tracker.flush()
        ts.track_stereo(left, right, i / 30.0)
        (tj, pj, lj), (tt, pt, lt) = js.tracker.trajectory[-1], ts.tracker.trajectory[-1]
        assert tj == tt and lj == lt and not lt, i
        assert (js.n_keyframes, js.n_points) == (ts.n_keyframes, ts.n_points), i
        assert np.abs(pj - pt).max() <= POSE_TOL, (i, np.abs(pj - pt).max())
    jv = np.asarray(js.map.kf_valid)
    np.testing.assert_array_equal(np.asarray(js.map.kf_frame_id)[jv],
                                  ts.map.kf_frame_id.numpy()[ts.map.kf_valid.numpy()])
    assert ts.n_points > 200


def test_run_slam_stereo(tmp_path):
    """`run_slam --sensor stereo --device cpu` on a KITTI-layout copy of 5
    frames of the orbit (at this file's capacities): every frame tracked,
    trajectories written; `--follow` with stereo exits, as in JAX."""
    import pytest

    from orbslam_mapsave_tpu_torch.apps import run_slam

    poses = synthetic.orbit_trajectory(8, radius=0.4, yaw_range=0.4)[:5]
    seq = synthetic.write_stereo_sequence(tmp_path / "seq", K, poses, width=W, height=H,
                                          baseline=BASELINE, seed=7)
    cam = tmp_path / "cam.yaml"
    cam.write_text("%YAML:1.0\n" + "\n".join(f"{k}: {v}" for k, v in {
        "Camera.fx": FX, "Camera.fy": FX, "Camera.cx": W / 2, "Camera.cy": H / 2,
        "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
        "Camera.width": W, "Camera.height": H, "Camera.fps": 30.0,
        "Camera.bf": FX * BASELINE, "ThDepth": 35.0, "ORBextractor.nFeatures": 600,
        "ORBextractor.scaleFactor": 1.5, "ORBextractor.nLevels": 4,
        "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7}.items()) + "\n")
    base = ["--dataset", str(seq), "--camera-yaml", str(cam), "--device", "cpu",
            "--sensor", "stereo"]
    systems = []
    init = tsys.SLAMSystem.__init__

    def keep(self, cfg, *a, **k):
        cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 32, 8192
        init(self, cfg, *a, **k)
        systems.append(self)

    tsys.SLAMSystem.__init__ = keep
    try:
        run_slam.main(base + ["--out", str(tmp_path / "a.txt"),
                              "--kf-out", str(tmp_path / "ak.txt")])
        with pytest.raises(SystemExit):
            run_slam.main(base + ["--follow"])
    finally:
        tsys.SLAMSystem.__init__ = init
    slam = systems[0]
    assert slam.sensor == tsys.Sensor.STEREO and slam.device.type == "cpu"
    assert [l for _, _, l in slam.tracker.trajectory] == [False] * 5
    assert slam.n_keyframes >= 1 and slam.n_points > 200
    assert len((tmp_path / "a.txt").read_text().splitlines()) == 5
