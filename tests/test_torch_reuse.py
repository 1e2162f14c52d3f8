"""Map reuse in both packages: a port mirror of `test_reuse_mode.py` at its
320x240 / 14-frame size (600 ORB features, 32 keyframe / 8192 point
capacity), with a vocabulary and loop closing on so the BoW store exists.

The JAX package maps the sequence and saves the map. Both packages load
it (`SLAMSystem(..., reuse_map_path=...)`): they start LOST in
localization-only mode, relocalize on the same first frame, localize at
least N - 3 frames with poses within 1e-4 of each other frame by frame,
and leave the map as loaded. Two cases: the BoW rows persisted in the
file (used as they are: no rebuild) and a file without them (both rebuild
the rows, which equal the persisted ones: words equal, weights within
1e-6)."""

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu import config as jcfg
from orbslam_mapsave_tpu.io import mapio as jmapio
from orbslam_mapsave_tpu.pipeline import loop_closing as jlc
from orbslam_mapsave_tpu.pipeline import system as jsys
from orbslam_mapsave_tpu.vocab import vocabulary as jvocabulary
from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch.io import dataset, synthetic
from orbslam_mapsave_tpu_torch.pipeline import loop_closing as tlc
from orbslam_mapsave_tpu_torch.pipeline import system as tsys
from orbslam_mapsave_tpu_torch.pipeline import tracking
from orbslam_mapsave_tpu_torch.vocab import vocabulary

torch.set_num_threads(2)
W, H, FX, N = 320, 240, 200.0, 14
POSE_TOL = 1e-4


def _config(cfg_mod):
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                                      bf=FX * 0.08, th_depth=50.0, depth_map_factor=5000.0,
                                      fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 32, 8192
    return cfg


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The sequence, both packages' copies of one vocabulary, and the JAX
    run's map saved with its BoW rows and without them."""
    out = tmp_path_factory.mktemp("reuse_seq_torch")
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    synthetic.write_tum_sequence(out, K, synthetic.orbit_trajectory(N, radius=0.4,
                                                                    yaw_range=0.4),
                                 width=W, height=H, seed=5)
    frames = list(dataset.TUMDataset(out, depth_factor=5000.0))
    probe = tsys.SLAMSystem(_config(tcfg), tsys.Sensor.RGBD, enable_mapping=False,
                            device="cpu")
    fr = probe.builder.build(frames[0][1], 0.0, frames[0][2])
    voc = vocabulary.train(fr.desc[fr.valid].numpy(), k=6, L=3, seed=1)
    vocabulary.save_binary(out / "voc.bin", voc)
    jvoc = jvocabulary.load_binary(out / "voc.bin")
    js = jsys.SLAMSystem(_config(jcfg), jsys.Sensor.RGBD, vocabulary=jvoc)
    js.tracker.fetch_every = 1
    for t, gray, depth in frames:
        js.track_rgbd(gray, depth, t)
    js.tracker.flush()
    with_rows, without = out / "map.npz", out / "map_norows.npz"
    js.save_map(with_rows)
    jmapio.save_map(without, js.map, ts_epoch=js.tracker.ts_epoch)
    return dict(frames=frames, voc=voc, jvoc=jvoc, paths=(with_rows, without),
                n_kf=js.n_keyframes, n_pt=int(js.map.n_pt), store=js.loop_closer.bow_store)


@pytest.mark.parametrize("rows", ["persisted", "rebuilt"])
def test_reuse_mode_matches_jax(saved, monkeypatch, rows):
    path = saved["paths"][0 if rows == "persisted" else 1]
    rebuilds = {"jax": 0, "port": 0}
    for key, mod in (("jax", jlc), ("port", tlc)):
        rebuild = mod.LoopCloser.rebuild_store

        def counted(self, state, key=key, rebuild=rebuild):
            rebuilds[key] += 1
            return rebuild(self, state)

        monkeypatch.setattr(mod.LoopCloser, "rebuild_store", counted)
    jr = jsys.SLAMSystem(_config(jcfg), jsys.Sensor.RGBD, vocabulary=saved["jvoc"],
                         reuse_map_path=str(path))
    tr = tsys.SLAMSystem(_config(tcfg), tsys.Sensor.RGBD, vocabulary=saved["voc"],
                         reuse_map_path=str(path), device="cpu")
    jr.tracker.fetch_every = 1
    assert jr.localization_only and tr.localization_only
    assert jr.tracker.state == tr.tracking_state == tracking.LOST
    assert rebuilds == ({"jax": 0, "port": 0} if rows == "persisted"
                        else {"jax": 1, "port": 1})
    store = tr.loop_closer.bow_store
    np.testing.assert_array_equal(store.word.numpy(), np.asarray(jr.loop_closer.bow_store.word))
    np.testing.assert_array_equal(store.word.numpy(), np.asarray(saved["store"].word))
    np.testing.assert_allclose(store.weight.numpy(), np.asarray(saved["store"].weight),
                               atol=0 if rows == "persisted" else 1e-6)
    states = []
    for t, gray, depth in saved["frames"]:
        jr.track_rgbd(gray, depth, t)
        tr.track_rgbd(gray, depth, t)
        assert jr.tracker.state == tr.tracking_state
        pj, pt = np.asarray(jr.tracker.ctrl.pose), tr.tracker.ctrl.pose.numpy()
        assert np.abs(pj - pt).max() <= POSE_TOL, np.abs(pj - pt).max()
        states.append(tr.tracking_state)
    lost_t = [lost for _, _, lost in tr.tracker.trajectory]
    assert lost_t == [lost for _, _, lost in jr.tracker.trajectory]
    assert states.index(tracking.OK) == 0  # relocalized on the first frame
    assert sum(not lost for lost in lost_t) >= N - 3
    assert tr.n_keyframes == jr.n_keyframes == saved["n_kf"]
    assert int(tr.map.n_pt) == int(jr.map.n_pt) == saved["n_pt"]
