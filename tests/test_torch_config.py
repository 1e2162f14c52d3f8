"""Parity: the master-settings cascade (`Examples/Setting.yaml`: vocabulary,
camera settings, viewer and map-reuse switches, image path) in both
packages, and the port's `run_slam --settings` driven by it on the CPU.

The files are written into a temporary directory with the reference's keys
(`Examples/Setting.yaml:1-59` for the master file, `ORB_RGBD640x480.yaml`'s
sections for the camera file); the sequence is a short synthetic TUM orbit
made from a seed."""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu import config as jconfig
from orbslam_mapsave_tpu_torch import config as tconfig

torch.set_num_threads(2)
W, H, FX = 320, 240, 200.0

CAMERA = {
    "Camera.fx": FX, "Camera.fy": FX, "Camera.cx": W / 2, "Camera.cy": H / 2,
    "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
    "Camera.width": W, "Camera.height": H, "Camera.fps": 30.0, "Camera.bf": FX * 0.08,
    "Camera.RGB": 1, "ThDepth": 50.0, "DepthMapFactor": 5000.0,
    "ORBextractor.nFeatures": 600, "ORBextractor.scaleFactor": 1.5,
    "ORBextractor.nLevels": 4, "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7,
    "Viewer.KeyFrameSize": 0.05, "Viewer.PointSize": 2, "Viewer.ViewpointX": 0,
    "Viewer.ViewpointY": -0.7, "Viewer.ViewpointZ": -1.8, "Viewer.ViewpointF": 500,
    "Viewer.TrjHistory": 10, "Viewer.WindowSizeX": 1024, "Viewer.WindowSizeY": 768,
    "Send_inverval": 50, "Receiver_interval": 10, "Buf_size": 1024, "Port_in": 8008,
    "Port_out": 8009, "IP_client": '"146.169.195.98"', "timeout_max": 100,
    "Robot_mode": 1, "AngleThres": 10.0, "DistThresMin": 0.5, "DistThresMax": 1.5,
    "Aruco.dictionaryId": 10, "Aruco.estimatePose": 1, "Aruco.markerLength": 0.053,
}


def _write_yaml(path, entries: dict):
    path.write_text("%YAML:1.0\n# written by the test\n"
                    + "\n".join(f"{k}: {v}" for k, v in entries.items()) + "\n")
    return path


def _master(tmp_path, name: str, **switches) -> object:
    """A master Setting.yaml with the reference's keys; `switches` override
    the viewer / reuse / path entries."""
    entries = {
        "Video_source": '"0"',
        "Orb_Vocabulary": f'"{tmp_path / "ORBvoc.bin"}"',
        "Cam_Setting": f'"{tmp_path / "cam.yaml"}"',
        "is_UseViewer": 0,
        "is_ReuseMap": 0,
        "ReuseMap": f'"{tmp_path / "map.npz"}"',
        "LoadImagePath": f'"{tmp_path / "seq"}"',
        "is_DetectHuman": 1,
        "Openpose_Parameters": f'"{tmp_path / "Openpose_params.yml"}"',
        "is_DetectMarker": 0,
        "Aruco_Parameters": f'"{tmp_path / "detector_params.yml"}"',
    }
    entries.update(switches)
    return _write_yaml(tmp_path / name, entries)


@pytest.mark.parametrize("camera", ["written", "missing"])
def test_master_settings_as_jax(tmp_path, camera):
    """Both packages' `load_master_settings` on the same files give the same
    config, field by field (nested sections included); with the camera file
    present its values are in it, without it the defaults stand."""
    if camera == "written":
        _write_yaml(tmp_path / "cam.yaml", CAMERA)
    path = _master(tmp_path, "Setting.yaml", is_UseViewer=1, is_ReuseMap=1)
    cfg_t = tconfig.load_master_settings(path)
    cfg_j = jconfig.load_master_settings(path)
    got, ref = dataclasses.asdict(cfg_t), dataclasses.asdict(cfg_j)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == ref[k], k
    assert cfg_t.use_viewer and cfg_t.reuse_map and cfg_t.detect_human
    assert not cfg_t.detect_marker
    assert cfg_t.vocabulary_path == str(tmp_path / "ORBvoc.bin")
    assert cfg_t.reuse_map_path == str(tmp_path / "map.npz")
    assert cfg_t.load_image_path == str(tmp_path / "seq")
    default = tconfig.SystemConfig()
    if camera == "written":
        assert (cfg_t.camera.fx, cfg_t.camera.width, cfg_t.camera.depth_map_factor) == (
            FX, W, 5000.0)
        assert cfg_t.orb.n_features == 600 and cfg_t.udp.ip_client == "146.169.195.98"
        assert cfg_t.aruco.marker_length == 0.053 and cfg_t.viewer.trj_history == 10
    else:
        assert cfg_t.camera == default.camera and cfg_t.orb == default.orb


def test_run_slam_driven_by_settings(tmp_path, monkeypatch, capsys):
    """`run_slam --settings FILE --device cpu` with no --dataset, --camera-yaml
    or --vocabulary: the file names the images, the camera file and the
    vocabulary. A first file switches the viewer on and reuse off (a SLAM
    run that writes the viewer's PNGs; its map saved); a second switches the
    viewer off and reuse on (the run starts LOST in localization-only mode
    on the saved map, relocalizes and leaves the map as loaded)."""
    from orbslam_mapsave_tpu_torch.apps import run_slam
    from orbslam_mapsave_tpu_torch.io import mapio, synthetic
    from orbslam_mapsave_tpu_torch.pipeline import system as tsys
    from orbslam_mapsave_tpu_torch.vocab import vocabulary as tvoc

    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    synthetic.write_tum_sequence(tmp_path / "seq", K,
                                 synthetic.orbit_trajectory(10, radius=0.4, yaw_range=0.3),
                                 width=W, height=H, seed=5)
    _write_yaml(tmp_path / "cam.yaml", CAMERA)
    desc = np.random.default_rng(0).integers(0, 256, (600, 32), dtype=np.uint8)
    tvoc.save_binary(tmp_path / "ORBvoc.bin", tvoc.train(desc, k=4, L=2))
    monkeypatch.chdir(tmp_path)  # the viewer writes into ./viewer_out
    systems = []
    init = tsys.SLAMSystem.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        systems.append((self, self.localization_only, self.tracking_state))

    monkeypatch.setattr(tsys.SLAMSystem, "__init__", keep)
    m = tmp_path / "map.npz"
    run_slam.main(["--settings", str(_master(tmp_path, "slam.yaml", is_UseViewer=1)),
                   "--device", "cpu", "--out", "a.txt", "--kf-out", "ak.txt",
                   "--save-map", str(m)])
    out = capsys.readouterr().out
    assert "Vocabulary loaded (16 words)" in out and f"from {tmp_path / 'seq'}" in out
    slam, loc_only, _ = systems[0]
    assert not loc_only and slam.loop_closer.voc.n_words == 16
    assert (slam.cfg.camera.fx, slam.cfg.orb.n_features) == (FX, 600)
    assert sorted(p.name for p in (tmp_path / "viewer_out").iterdir()) == [
        "frame_000010.png", "map_000010.png"]
    assert len((tmp_path / "a.txt").read_text().splitlines()) == 10 and m.is_file()
    saved = mapio.map_summary(mapio.load_map(m))

    run_slam.main(["--settings", str(_master(tmp_path, "reuse.yaml", is_ReuseMap=1)),
                   "--device", "cpu", "--out", "b.txt", "--kf-out", "bk.txt"])
    slam, loc_only, state0 = systems[1]
    assert loc_only and state0 == 3  # LOST
    lost = [l for _, _, l in slam.tracker.trajectory]
    assert lost[0] and sum(not l for l in lost) >= 6
    assert mapio.map_summary(slam.map) == saved
    assert len(list((tmp_path / "viewer_out").iterdir())) == 2  # the viewer stayed off
