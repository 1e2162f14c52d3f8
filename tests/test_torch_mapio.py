"""Parity: map files between the JAX package and the port.

- `io/mapio.py` (`orbtpu-map-v1`, a zip of .npy arrays): a map saved by
  either package loads in the other with every array equal, dtype and
  value, the BoW rows too; version and sentinel checks; the BoW rows of a
  file are used only with the vocabulary they were written for.
- `LoopCloser.rebuild_store` (map reuse without persisted rows): the same
  rows as JAX's (words equal, weights within 1e-6).
- `io/boost_parity.py` (the reference's boost archive): byte-identical
  files both ways, `test_persistence.py`'s golden fixture included, and
  each package loads the other's file to equal arrays.
- `apps/run_slam.py`: `--save-map` then `--reuse-map` with `--device cpu`
  on a tiny synthetic sequence (localization only: the map does not grow).

Maps come from `test_persistence.py`'s builders (made from a seed)."""

import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_persistence import _golden_bytes, _random_map, _tiny_map, build_small_map

from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.io import boost_parity as jboost
from orbslam_mapsave_tpu.io import mapio as jmapio
from orbslam_mapsave_tpu.pipeline import loop_closing as jlc
from orbslam_mapsave_tpu.vocab import database as jdb
from orbslam_mapsave_tpu.vocab import vocabulary as jvoc
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.io import boost_parity as tboost
from orbslam_mapsave_tpu_torch.io import mapio as tmapio
from orbslam_mapsave_tpu_torch.pipeline import loop_closing as tlc
from orbslam_mapsave_tpu_torch.vocab import database as tdb
from orbslam_mapsave_tpu_torch.vocab import vocabulary as tvoc

torch.set_num_threads(2)
CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0, width=640, height=480,
           th_depth=40.0)


def _assert_same_arrays(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _jax_arrays(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _bow_store(rng, K: int):
    store = jdb.empty_sparse_store(K, 16)
    words = np.sort(np.array([3, 7, 100] + [2**31 - 1] * 13))
    return jdb.add_keyframe_bow_sparse(store, 2, jnp.asarray(words, jnp.int32),
                                       jnp.asarray([0.5, 0.25, 0.25] + [0.0] * 13, jnp.float32))


def _zip_arrays(path) -> tuple[dict, dict]:
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("__meta__.json"))
        arrays = {n[:-4]: np.load(zf.open(n)) for n in zf.namelist() if n.endswith(".npy")}
    return meta, arrays


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_map_file_loads_in_the_other_package(rng, tmp_path, saver):
    """Save with one package (BoW rows and epoch included), load with the
    other: every MapState array and both BoW arrays equal in dtype and
    value; the files' metadata and arrays are the same."""
    jstate = build_small_map(rng)
    jstore = _bow_store(rng, jstate.kf_capacity)
    tstate = interop.map_state_from_numpy(jstate)
    tstore = interop.map_state_from_numpy(jstore)
    pj, pt = tmp_path / "jax.npz", tmp_path / "port.npz"
    jmapio.save_map(pj, jstate, ts_epoch=1.5e9, bow_store=jstore, voc_n_words=1000)
    tmapio.save_map(pt, tstate, ts_epoch=1.5e9, bow_store=tstore, voc_n_words=1000)
    mj, aj = _zip_arrays(pj)
    mt, at = _zip_arrays(pt)
    assert mj == mt
    _assert_same_arrays(aj, at)
    if saver == "jax":  # loaded by the port
        path, back = pj, interop.map_state_to_numpy(tmapio.load_map(pj))
        store, epoch = interop.map_state_to_numpy(tmapio.load_bow_store(pj, 1000)), \
            tmapio.read_ts_epoch(pj)
    else:  # loaded by JAX
        path, back = pt, _jax_arrays(jmapio.load_map(pt))
        store, epoch = _jax_arrays(jmapio.load_bow_store(pt, 1000)), jmapio.read_ts_epoch(pt)
    assert epoch == 1.5e9
    _assert_same_arrays(back, _jax_arrays(jstate))
    _assert_same_arrays(store, _jax_arrays(jstore))
    assert tmapio.map_summary(tmapio.load_map(path)) == jmapio.map_summary(jstate)


def test_bow_rows_only_for_their_vocabulary(rng, tmp_path):
    """A file's BoW rows load only for the vocabulary size they were saved
    with, and a file without rows has none (`test_bow_persist.py`)."""
    tstate = interop.map_state_from_numpy(build_small_map(rng))
    tstore = interop.map_state_from_numpy(_bow_store(rng, tstate.kf_capacity))
    p, p2 = tmp_path / "m.npz", tmp_path / "m2.npz"
    tmapio.save_map(p, tstate, bow_store=tstore, voc_n_words=1000)
    tmapio.save_map(p2, tstate)
    assert tmapio.load_bow_store(p, 999) is None
    assert tmapio.load_bow_store(p2, 1000) is None
    assert jmapio.load_bow_store(p, 999) is None and jmapio.load_bow_store(p2, 1000) is None
    assert tmapio.load_map(p).kf_capacity == 8


@pytest.mark.parametrize("field,value", [("sentinel", 0xDEADBEEE), ("version", "orbtpu-map-v0")])
def test_version_and_sentinel_checks(rng, tmp_path, field, value):
    """A file whose sentinel or version is wrong raises ValueError in both
    packages; the right file loads on the device named."""
    p = tmp_path / "m.npz"
    tmapio.save_map(p, interop.map_state_from_numpy(build_small_map(rng)))
    assert tmapio.load_map(p, device="cpu").kf_pose.device.type == "cpu"
    bad = tmp_path / "bad.npz"
    with zipfile.ZipFile(p) as src, zipfile.ZipFile(bad, "w") as dst:
        for n in src.namelist():
            data = src.read(n)
            if n == "__meta__.json":
                meta = json.loads(data)
                meta[field] = value
                data = json.dumps(meta)
            dst.writestr(n, data)
    with pytest.raises(ValueError, match="bad map file"):
        tmapio.load_map(bad)
    with pytest.raises(ValueError):
        jmapio.load_map(bad)


def test_old_files_without_octave_column_load_alike(rng, tmp_path):
    """A file from before `pt_obs_oct` / `n_obs_dropped` derives them as the
    JAX loader does."""
    p = tmp_path / "old.npz"
    jmapio.save_map(p, build_small_map(rng))
    old = tmp_path / "older.npz"
    with zipfile.ZipFile(p) as src, zipfile.ZipFile(old, "w") as dst:
        for n in src.namelist():
            if n not in ("pt_obs_oct.npy", "n_obs_dropped.npy"):
                dst.writestr(n, src.read(n))
    _assert_same_arrays(interop.map_state_to_numpy(tmapio.load_map(old)),
                        _jax_arrays(jmapio.load_map(old)))


def test_rebuild_store_matches_jax(rng):
    """`LoopCloser.rebuild_store` over a map with 3 live keyframes of random
    descriptors: the sparse rows of JAX's rebuild, words equal and weights
    within 1e-6; the rows of dead slots stay empty."""
    jstate = build_small_map(rng)
    desc = rng.integers(0, 256, (600, 32), dtype=np.uint8)
    voc_t = tvoc.train(desc, k=4, L=3, seed=2)
    jv = jvoc.Vocabulary(**{f: getattr(voc_t, f) for f in voc_t.__dataclass_fields__})
    sf = np.asarray([1.5**i for i in range(4)], np.float32)
    inv_ls2 = (1.0 / sf**2).astype(np.float32)
    args = (500.0, 500.0, 320.0, 240.0)
    jl = jlc.LoopCloser(jproj.Camera.create(*args, bf=40.0, width=640, height=480), inv_ls2,
                        jv, scale_factors=sf, n_levels=4, scale_factor=1.5)
    tl = tlc.LoopCloser(tproj.Camera.create(*args, bf=40.0, width=640, height=480), inv_ls2,
                        voc_t, scale_factors=sf, n_levels=4, scale_factor=1.5)
    jl.rebuild_store(jstate)
    tl.rebuild_store(interop.map_state_from_numpy(jstate))
    np.testing.assert_array_equal(tl.bow_store.word.numpy(), np.asarray(jl.bow_store.word))
    np.testing.assert_allclose(tl.bow_store.weight.numpy(), np.asarray(jl.bow_store.weight),
                               atol=1e-6)
    live = np.asarray(jstate.kf_valid)
    assert (tl.bow_store.weight.numpy()[live].sum(-1) > 0.99).all()
    assert (tl.bow_store.weight.numpy()[~live] == 0).all()
    assert isinstance(tl.bow_store, tdb.SparseBowStore)


def test_boost_golden_fixture(tmp_path):
    """`test_persistence.py`'s hand-assembled archive: the port writes it
    byte for byte from the same map, and reads it back to JAX's arrays."""
    tstate = interop.map_state_from_numpy(_tiny_map())
    p = tmp_path / "golden.bin"
    tboost.save_boost_map(p, tstate, CAM, scale_factor=1.5, n_levels=4)
    assert p.read_bytes() == _golden_bytes()
    back = tboost.load_boost_map(p, max_keyframes=2, max_points=4, n_features=2)
    _assert_same_arrays(interop.map_state_to_numpy(back),
                        _jax_arrays(jboost.load_boost_map(p, max_keyframes=2, max_points=4,
                                                          n_features=2)))


@pytest.mark.parametrize("trial", range(3))
def test_boost_files_byte_identical_both_ways(tmp_path, trial):
    """The randomized maps of `test_persistence.test_boost_fuzz_roundtrip`
    (its seed, its draws): the two writers' files are byte-identical, and
    each package loads the other's file to the arrays the other package
    loads."""
    rng = np.random.default_rng(5)
    for _ in range(trial + 1):
        jstate = _random_map(rng, n_kf=int(rng.integers(2, 6)), n_pt=int(rng.integers(10, 80)))
    pj, pt = tmp_path / "jax.bin", tmp_path / "port.bin"
    jboost.save_boost_map(pj, jstate, CAM, ts_epoch=1e9)
    tboost.save_boost_map(pt, interop.map_state_from_numpy(jstate), CAM, ts_epoch=1e9)
    assert pj.read_bytes() == pt.read_bytes()
    kw = dict(max_keyframes=16, max_points=256, n_features=48, ts_epoch=1e9)
    _assert_same_arrays(interop.map_state_to_numpy(tboost.load_boost_map(pj, **kw)),
                        _jax_arrays(jboost.load_boost_map(pt, **kw)))


def test_run_slam_save_then_reuse(tmp_path):
    """`run_slam --save-map`, then `--reuse-map` on the same tiny sequence
    with `--device cpu`: the second run starts LOST in localization-only
    mode, relocalizes, tracks most frames and leaves the map as loaded."""
    from orbslam_mapsave_tpu_torch.apps import run_slam
    from orbslam_mapsave_tpu_torch.io import synthetic
    from orbslam_mapsave_tpu_torch.pipeline import system as tsys

    W, H, FX = 320, 240, 200.0
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    seq = tmp_path / "seq"
    synthetic.write_tum_sequence(seq, K, synthetic.orbit_trajectory(6, radius=0.4,
                                                                      yaw_range=0.3),
                                 width=W, height=H, seed=5)
    cam = tmp_path / "cam.yaml"
    cam.write_text("%YAML:1.0\n" + "\n".join(f"{k}: {v}" for k, v in {
        "Camera.fx": FX, "Camera.fy": FX, "Camera.cx": W / 2, "Camera.cy": H / 2,
        "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
        "Camera.width": W, "Camera.height": H, "Camera.fps": 30.0, "Camera.bf": FX * 0.08,
        "ThDepth": 50.0, "DepthMapFactor": 5000.0, "ORBextractor.nFeatures": 600,
        "ORBextractor.scaleFactor": 1.5, "ORBextractor.nLevels": 4,
        "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7}.items()) + "\n")
    base = ["--dataset", str(seq), "--camera-yaml", str(cam), "--device", "cpu"]
    m = tmp_path / "map.npz"
    run_slam.main(base + ["--out", str(tmp_path / "a.txt"), "--kf-out", str(tmp_path / "ak.txt"),
                          "--save-map", str(m)])
    saved = tmapio.map_summary(tmapio.load_map(m))
    captured = []
    init = tsys.SLAMSystem.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        captured.append((self, self.localization_only, self.tracking_state))

    tsys.SLAMSystem.__init__ = keep
    try:
        run_slam.main(base + ["--out", str(tmp_path / "b.txt"),
                              "--kf-out", str(tmp_path / "bk.txt"), "--reuse-map", str(m)])
    finally:
        tsys.SLAMSystem.__init__ = init
    slam, loc_only, state0 = captured[0]
    assert loc_only and state0 == 3  # LOST
    lost = [l for _, _, l in slam.tracker.trajectory]
    assert lost[0] and sum(not l for l in lost) >= 4
    assert tmapio.map_summary(slam.map) == saved
    assert len((tmp_path / "b.txt").read_text().splitlines()) >= 4
    # the viewer flags run on the port (no longer an exit): the live page
    # is rewritten during the run and the final view written at the end
    run_slam.main(base + ["--out", str(tmp_path / "c.txt"), "--kf-out", str(tmp_path / "ck.txt"),
                          "--html-view", str(tmp_path / "v.html"), "--html-live", "1"])
    page = (tmp_path / "v.html").read_text()
    assert "__DATA__" not in page and '"traj": [[' in page and "<canvas" in page
    assert 'http-equiv="refresh"' not in page  # the final view is not a live page
