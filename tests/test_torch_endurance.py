"""Long-run machinery of the port against the JAX package: slot compaction
with loop closing live, O_BA escalation, the solver routes at the reference
scale, and tools/scale_endurance_torch.py's sequences.

(a) A whole RGB-D system in both packages (320x240, 600 ORB features,
    12 keyframe / 1,100 point slots, a vocabulary, loop closing on) over 24
    frames of an orbit whose camera makes a keyframe at nearly every frame
    (fps 1 and ThDepth 22: few close points, so `NeedNewKeyFrame` fires);
    local mapping culls the redundant ones, so both allocators cross the
    0.9 trigger and both point and keyframe compaction renumber the slots.
    Frame by frame: poses within 1e-4, lost flags, keyframe and point
    counts, the compactions run, `kf_kp_point`, the BoW rows (words equal,
    weights within 1e-6) and the detector's consistent groups. At 12 slots
    no keyframe reaches slot 11, where detection starts (JAX's detector
    also needs 30 slots for its top-30 covisibility), so the groups stay
    empty here: `remap_keyframes` is also held to JAX's directly, on
    groups, BoW rows and a last loop keyframe that a compaction moves.
(b) The same run's BA escalations and dropped lanes: its windows hold points
    seen by more than O_BA keyframes, and both packages count alike.
(c) The global-BA job's and the essential graph's solver at four capacities,
    K_cap 1,536 / P_cap 262,144 among them (the choice only: the solve is cut
    off where it would start).
(d) tools/scale_endurance_torch.py's poses and first frames equal those of
    tools/scale_endurance.py and tools/endurance.py, run in a subprocess
    (importing them sets a persistent JAX compile cache, pointed here at a
    temporary directory).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu import config as jcfg
from orbslam_mapsave_tpu.pipeline import system as jsys
from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu.vocab import vocabulary as jvocabulary
from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.pipeline import system as tsys
from orbslam_mapsave_tpu_torch.slammap import mapstate as tms
from orbslam_mapsave_tpu_torch.vocab import vocabulary

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
W, H, FX = 320, 240, 200.0
N_FRAMES = 24
POSE_TOL = 1e-4


def _frames():
    """u8 images and 1/5000-quantized depths of an orbit in the default
    room (the first 24 frames of a 40-frame, 0.8 rad yaw orbit)."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    room = synthetic.BoxRoom(half_size=2.0, seed=3)
    out = []
    for T in synthetic.orbit_trajectory(40, radius=0.5, yaw_range=0.8)[:N_FRAMES]:
        g, d = room.render(K, T, W, H)
        out.append((np.clip(g, 0, 255).astype(np.uint8),
                    (np.round(d * 5000.0) / 5000.0).astype(np.float32)))
    return out


def _config(mod):
    cfg = mod.SystemConfig()
    cfg.camera = mod.CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                                  bf=FX * 0.08, th_depth=22.0, fps=1)
    cfg.orb = mod.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 12, 1100
    return cfg


def _counting(mod, kinds: list, patches: list):
    """Wrap a mapstate module's compactions to append their kind."""
    for kind in ("points", "keyframes"):
        name = f"compact_{kind}"
        fn = getattr(mod, name)
        patches.append((mod, name, fn))
        setattr(mod, name, lambda st, fn=fn, kind=kind: kinds.append(kind) or fn(st))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages frame by frame; per frame the pose, lost flag, counts,
    compactions, forward references, BoW rows and consistent groups."""
    frames = _frames()
    ts = tsys.SLAMSystem(_config(tcfg), tsys.Sensor.RGBD, device="cpu",
                         enable_loop_closing=False)
    descs = [ts.builder.build(g, i / 30.0, d) for i, (g, d) in enumerate(frames[::3])]
    voc = vocabulary.train(np.concatenate([f.desc[f.valid].numpy() for f in descs]),
                           k=8, L=3, seed=1)
    path = tmp_path_factory.mktemp("endurance_voc") / "voc.bin"
    vocabulary.save_binary(path, voc)
    ts = tsys.SLAMSystem(_config(tcfg), tsys.Sensor.RGBD, vocabulary=voc, device="cpu")
    js = jsys.SLAMSystem(_config(jcfg), jsys.Sensor.RGBD,
                         vocabulary=jvocabulary.load_binary(path))
    js.tracker.fetch_every = 1
    tk, jk, patches, rows = [], [], [], []
    _counting(tms, tk, patches)
    _counting(jms, jk, patches)
    try:
        for i, (g, d) in enumerate(frames):
            t = 1000.0 + i / 30.0
            del tk[:], jk[:]
            js.track_rgbd(g.astype(np.float32), d, t)
            js.tracker.flush()
            ts.track_rgbd(g, d, t)
            rows.append(dict(
                j=js.tracker.trajectory[-1], t=ts.tracker.trajectory[-1],
                jn=(js.n_keyframes, js.n_points), tn=(ts.n_keyframes, ts.n_points),
                jk=list(jk), tk=list(tk),
                jfwd=_np(js.map.kf_kp_point).copy(), tfwd=_np(ts.map.kf_kp_point).copy(),
                jbow=[_np(x).copy() for x in js.loop_closer.bow_store],
                tbow=[_np(x).copy() for x in ts.loop_closer.bow_store],
                jgroups=[(sorted(g_), c) for g_, c in js.loop_closer.consistent_groups],
                tgroups=[(sorted(g_), c) for g_, c in ts.loop_closer.consistent_groups]))
    finally:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
    return js, ts, rows


def test_compaction_frame_by_frame(runs):
    _, _, rows = runs
    for i, r in enumerate(rows):
        (tj, pj, lj), (tt, pt, lt) = r["j"], r["t"]
        assert tj == tt and lj == lt, i
        assert r["jn"] == r["tn"], (i, r["jn"], r["tn"])
        assert r["jk"] == r["tk"], (i, r["jk"], r["tk"])
        assert np.abs(pj - pt).max() <= POSE_TOL, (i, np.abs(pj - pt).max())
        np.testing.assert_array_equal(r["tfwd"], r["jfwd"], err_msg=f"frame {i}")
        np.testing.assert_array_equal(r["tbow"][0], r["jbow"][0], err_msg=f"frame {i}")
        np.testing.assert_allclose(r["tbow"][1], r["jbow"][1], atol=1e-6, err_msg=f"frame {i}")
        assert r["tgroups"] == r["jgroups"], i
    kinds = [k for r in rows for k in r["tk"]]
    assert "points" in kinds and "keyframes" in kinds, kinds
    assert not any(r["t"][2] for r in rows)


def test_keyframe_compaction_recycles_culled_slots(runs):
    """Keyframe compaction here reclaims slots that local mapping culled
    (fewer live keyframes than the 13 allocated when it runs), and the BoW
    rows move with their keyframes: every live keyframe's row equals the
    row computed anew from its descriptors."""
    _, ts, rows = runs
    at = [i for i, r in enumerate(rows) if "keyframes" in r["tk"]]
    assert at and min(rows[i]["tn"][0] for i in at) < 13, [rows[i]["tn"] for i in at]
    st, lc = ts.map, ts.loop_closer
    m = lc.bow_store.word.shape[1]
    for kf in torch.nonzero(st.kf_valid).flatten().tolist():
        out = lc.transform(st.kf_desc[kf], st.kf_kp_valid[kf])
        w, v = vocabulary.sparse_bow(out["word"], out["weight"], m)
        assert torch.equal(w, lc.bow_store.word[kf]) and torch.equal(v, lc.bow_store.weight[kf])


def test_escalation_counts_as_jax(runs):
    """Keyframes at nearly every frame leave points seen by more than O_BA
    keyframes in the local windows: the BA escalates (O_BA -> O_BA_ESC) in
    both packages on the same steps, and drops the same lanes."""
    js, ts, _ = runs
    assert ts.tracker.ba_escalations > 0
    assert ts.tracker.ba_escalations == js.tracker.ba_escalations
    assert ts.tracker.ba_lanes_dropped == js.tracker.ba_lanes_dropped


class _Chosen(Exception):
    pass


# (keyframe slots, point slots, live keyframes) -> (GBA solver, essential-graph solver)
ROUTES = [((64, 32768, 23), ("dense", "dense")), ((400, 4096, 390), ("pcg", "cg")),
          ((512, 65536, 26), ("pcg_dual", "cg")), ((1536, 262144, 234), ("pcg_dual", "cg"))]


@pytest.mark.parametrize("caps,want", ROUTES)
def test_solver_routes_as_jax(caps, want, monkeypatch, tmp_path):
    """Both packages pick the same solver for a loop's global-BA job (the
    (P, O_GBA, K) one-hot's bytes, then the live keyframes) and for its
    essential graph (K_cap): each is recorded where its solve would start,
    and stopped there."""
    import jax

    from orbslam_mapsave_tpu.optim import global_ba as jgba
    from orbslam_mapsave_tpu.optim import pose_graph as jpg
    from orbslam_mapsave_tpu.pipeline import gba as jgba_mod
    from orbslam_mapsave_tpu_torch.optim import global_ba as tgba
    from orbslam_mapsave_tpu_torch.optim import pose_graph as tpg
    from orbslam_mapsave_tpu_torch.pipeline import gba as tgba_mod

    K, P, live = caps
    # on the tests' 8-device mesh the JAX job would take its sharded branch
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])
    got = {}
    for pkg, gmod, pmod in (("jax", jgba, jpg), ("torch", tgba, tpg)):
        def stop_gba(*a, solver, pkg=pkg, **k):
            got[(pkg, "gba")] = solver
            raise _Chosen

        def stop_graph(prob, *a, solver="dense", pkg=pkg, **k):
            got[(pkg, "essential")] = solver
            raise _Chosen

        monkeypatch.setattr(gmod, "gba_init", stop_gba)
        monkeypatch.setattr(pmod, "optimize_pose_graph", stop_graph)

    voc = vocabulary.train(np.random.default_rng(0).integers(0, 256, (64, 32), np.uint8),
                           k=2, L=1, seed=1)
    vocabulary.save_binary(tmp_path / "voc.bin", voc)
    tstate = tms.empty_map(K, P, 64, "cpu")
    valid = torch.zeros(K, dtype=torch.bool)
    valid[:live] = True
    tstate = tstate._replace(kf_valid=valid, n_kf=torch.tensor(live, dtype=torch.int32))
    jstate = jms.empty_map(K, P, 64)
    jstate = jstate._replace(kf_valid=jstate.kf_valid.at[:live].set(True),
                             n_kf=jstate.n_kf * 0 + live)
    js = jsys.SLAMSystem(_config(jcfg), jsys.Sensor.RGBD,
                         vocabulary=jvocabulary.load_binary(tmp_path / "voc.bin"))
    ts = tsys.SLAMSystem(_config(tcfg), tsys.Sensor.RGBD, vocabulary=voc, device="cpu")
    for slam, state, gba_mod, essential in (
            (js, jstate, jgba_mod, js.loop_closer._essential_graph),
            (ts, tstate, tgba_mod, ts.loop_closer._essential)):
        with pytest.raises(_Chosen):
            gba_mod.GBAJob(state, slam.cam, slam.builder.inv_level_sigma2)
        with pytest.raises(_Chosen):
            essential(state, 1, 0)
    assert got[("jax", "gba")] == got[("torch", "gba")] == want[0]
    assert got[("jax", "essential")] == got[("torch", "essential")] == want[1]


@pytest.mark.parametrize("last_loop", [3, 2])
def test_remap_keyframes_as_jax(last_loop, tmp_path):
    """`LoopCloser.remap_keyframes` on the same compaction in both packages:
    BoW rows moved to the new slots (the dead slots' dropped), consistent
    groups renumbered with dead members removed and emptied groups dropped,
    the last loop keyframe renumbered, or pushed past the refractory gate
    when its slot died (slot 3 lives, slot 2 dies here)."""
    K, M = 12, 6
    rng = np.random.default_rng(4)
    word = np.sort(rng.integers(0, 50, (K, M)), axis=1).astype(np.int32)
    weight = rng.random((K, M)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 0, 1, 1, 0, 1, 0, 0], bool)
    new_of_old = np.where(valid, np.cumsum(valid) - 1, -1).astype(np.int32)
    groups = [({0, 2, 7}, 2), ({4, 5}, 1), ({9}, 0), ({2, 3, 6}, 3)]
    voc = vocabulary.train(rng.integers(0, 256, (64, 32), np.uint8), k=2, L=1, seed=1)
    vocabulary.save_binary(tmp_path / "voc.bin", voc)
    from orbslam_mapsave_tpu.vocab import database as jdb
    from orbslam_mapsave_tpu_torch.vocab import database as tdb

    out = []
    for sys_mod, cfg_mod, db, arr, kw in (
            (jsys, jcfg, jdb, np.asarray, dict(vocabulary=jvocabulary.load_binary(
                tmp_path / "voc.bin"))),
            (tsys, tcfg, tdb, torch.as_tensor, dict(vocabulary=voc, device="cpu"))):
        lc = sys_mod.SLAMSystem(_config(cfg_mod), sys_mod.Sensor.RGBD, **kw).loop_closer
        lc.bow_store = db.SparseBowStore(word=arr(word), weight=arr(weight))
        lc.consistent_groups = [(set(g), c) for g, c in groups]
        lc.last_loop_kf = last_loop
        lc._pending_detect = lc._pending_sim3 = ("stale",)
        lc.remap_keyframes(new_of_old)
        assert lc._pending_detect is None and lc._pending_sim3 is None
        out.append((_np(lc.bow_store.word), _np(lc.bow_store.weight),
                    [(sorted(g), c) for g, c in lc.consistent_groups], lc.last_loop_kf))
    (jw, jv, jg, jl), (tw, tv, tg, tl) = out
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tv, jv)
    assert tg == jg == [([0, 4], 2), ([5], 0), ([2, 3], 3)]
    assert tl == jl == (2 if last_loop == 3 else -11)
    np.testing.assert_array_equal(tw[:6], word[valid])
    assert (tw[6:] == np.iinfo(np.int32).max).all() and (tv[6:] == 0).all()


REFERENCE_SEQUENCES = r"""
import json, os, pickle, sys
from pathlib import Path
import numpy as np
root, out = Path(sys.argv[1]), Path(sys.argv[2])
sys.path[:0] = [str(root / "tools"), str(root)]
import endurance, scale_endurance
from orbslam_mapsave_tpu.io import synthetic
render, seen = synthetic.BoxRoom.render, {}

def first_two(room, K, T, w, h):  # the first two frames of a sequence, the rest 1x1 blanks
    # keyed by the room itself, which the dict keeps alive: keyed by id(), a
    # second tool's room could reuse the freed first room's id and render blanks
    seen[room] = seen.get(room, 0) + 1
    if seen[room] <= 2:
        return render(room, K, T, w, h)
    return np.zeros((1, 1), np.float32), np.zeros((1, 1), np.float32)

synthetic.BoxRoom.render = first_two
pickle.dump = lambda *a, **k: None  # the tools cache whole sequences
endurance.CACHE = scale_endurance.CACHE = out.parent
res = {}
for name, tool in (("endurance", endurance), ("scale", scale_endurance)):
    data = tool.get_sequence()
    res[name + "_K"] = data["K"]
    res[name + "_poses"] = data["poses"]
    for i in range(2):
        res[f"{name}_gray{i}"], res[f"{name}_depth{i}"] = data["frames"][i]
np.savez(out, **res)
"""


def test_tool_sequences_equal_jax_tools(tmp_path):
    """tools/scale_endurance_torch.py builds the JAX tools' sequences: the
    intrinsics, all 8,000 / 1,200 poses and the first two rendered frames
    (u8 image, f16 depth) of each."""
    import os

    sys.path.insert(0, str(ROOT / "tools"))
    import scale_endurance_torch as tool

    out = tmp_path / "jax_tools.npz"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(JAX_PLATFORMS="cpu", SCALE_FRAMES="8000",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c", REFERENCE_SEQUENCES, str(ROOT), str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (f"the JAX tools' subprocess exited {proc.returncode}:\n"
                                  f"{proc.stderr[-4000:]}")
    ref = np.load(out)
    for wl in (tool.ENDURANCE, tool.SCALE):
        np.testing.assert_array_equal(wl.K, ref[wl.name + "_K"])
        np.testing.assert_array_equal(wl.poses(), ref[wl.name + "_poses"])
        frames = tool.render(wl, wl.poses(2), workers=1)
        for i, (g, d) in enumerate(frames):
            np.testing.assert_array_equal(g, ref[f"{wl.name}_gray{i}"])
            np.testing.assert_array_equal(d, ref[f"{wl.name}_depth{i}"])
    assert tool.SCALE.poses(600).shape == (600, 4, 4)
    np.testing.assert_array_equal(tool.SCALE.poses(600), ref["scale_poses"][:600])
