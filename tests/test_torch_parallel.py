"""Parity: the port's `parallel/` (torch.distributed ranks) against the JAX
package's (shard_map over a device mesh of the same size).

The ranks are subprocesses on the gloo backend, one per rank, each running
WORKER with the env triplet set (COORDINATOR_ADDRESS on a free port of
127.0.0.1, NUM_PROCESSES, PROCESS_ID), jax and the JAX package made
unimportable, its inputs read from one .npz; each rank writes its results
to its own .npz. One launch at world 2 and one at world 4 (module-scoped
fixtures) run every case; each rank has a timeout, is killed when it
hangs, and its stderr goes into the failure message. The JAX side runs in
this process on meshes of 2 and 4 of the tests' 8 virtual CPU devices.

- `dist_ba` on `test_distributed._make_problem`'s problem (6 cameras, 128
  points, 4 observations), 12 LM iterations (converged: at 8, JAX's own 2-
  and 4-device results are 8.8e-5 apart, where one step's accept test
  flips on f32 noise; at 12 within 3e-6): at world 2 and 4 against
  JAX's `make_distributed_ba` on 2 and 4 devices (poses 1e-4, points 1e-3,
  chi2 rtol 1e-3, the same inliers), world 4 against the port's world 1,
  and JAX's truth check (mean pose error < 5e-3, fixed cameras untouched).
- `dist_gba.distributed_full_ba` on `test_global_ba.make_map_state(n_kf=16,
  n_pt=512, obs_per_pt=5)` (capacities 20 / 528 so that the map can grow
  after the snapshot), 10 LM iterations: at world 2 and 4 against JAX's on
  2 and 4 devices, as converged iterates (poses 1e-4, points 1e-3, cost
  rtol 1e-3, the tolerances of test_torch_global_ba.py).
- The placement of `shard_map_state` and `shard_tables`: rank r holds rows
  [r K/n, (r+1) K/n) of every keyframe-major field and [r P/n, (r+1) P/n)
  of every point-major one; the counts and camera masks are whole.
- `dist_reloc` at world 4 on `test_distributed_relocalization_query`'s
  store (K 32, M 16, W 512, query row 13, top_k 3): the same slots as
  JAX's query, scores within 1e-6.
- `GBAJob` at world 2 takes its multi-rank branch and, applied to the map
  grown after the snapshot, equals JAX's `distributed_full_ba` on 2
  devices followed by JAX's `_apply_device` (poses 1e-4, points 1e-3).
- `Relocalizer.candidates` at world 2 (a vocabulary trained by the JAX
  package and handed over as a .bin file): the candidates that JAX's
  relocalizer gives from its sharded query on 2 devices.
- Every rank returns the same result (the ranks' collectives replicate it).
- Ranks whose replicas diverged (the last rank's map moves one point, its
  BoW store one weight) raise ValueError on every rank, before the
  distributed GBA and the sharded query, instead of mixing blocks.
- Each rank leaves the process group (barrier, destroy) before it exits:
  a rank that exits while its peers still hold the store's connections
  can abort.
- `local_ba.global_bundle_adjustment` in this process against JAX's on
  `test_local_ba.py`'s problem (8 cameras, 200 points): poses 1e-4,
  points 1e-3, chi2 rtol 1e-3, the same inliers.
- Without the env triplet no group forms, and the mesh has one rank whose
  collectives return their input.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from test_distributed import _make_problem
from test_global_ba import BF, CX, CY, FX, FY, make_map_state, mean_pose_err
from test_local_ba import make_ba_problem
from test_torch_global_ba import _grow

from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.optim import global_ba as jglob
from orbslam_mapsave_tpu.optim import local_ba as jlba
from orbslam_mapsave_tpu.parallel import dist_ba as jdba
from orbslam_mapsave_tpu.parallel import dist_gba as jdgba
from orbslam_mapsave_tpu.parallel import dist_reloc as jdrel
from orbslam_mapsave_tpu.pipeline import gba as jgba
from orbslam_mapsave_tpu.pipeline import relocalization as jrel
from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu.vocab import database as jdb
from orbslam_mapsave_tpu.vocab import vocabulary as jvoc
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.optim import local_ba as tlba
from orbslam_mapsave_tpu_torch.parallel import dist_ba as tdba
from orbslam_mapsave_tpu_torch.parallel import mesh as tmesh

ROOT = Path(__file__).resolve().parent.parent
POSE_TOL, PT_TOL, COST_RTOL = 1e-4, 1e-3, 1e-3
SCORE_TOL = 1e-6
RANK_TIMEOUT_S = 150
ISIG = np.array([1.0, 1 / 1.44, 1 / 1.5 ** 4, 1 / 1.5 ** 6], np.float32)
BA_ITERS, GBA_ITERS = 12, 10
RELOC_K, RELOC_M, RELOC_W, RELOC_Q, RELOC_TOP_K = 32, 16, 512, 13, 3

WORKER = r"""
import sys
from types import SimpleNamespace
sys.modules["jax"] = None
sys.modules["orbslam_mapsave_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.geometry import projection
from orbslam_mapsave_tpu_torch.optim import global_ba, local_ba
from orbslam_mapsave_tpu_torch.parallel import dist_ba, dist_gba, dist_reloc, mesh as pmesh
from orbslam_mapsave_tpu_torch.pipeline import gba, relocalization
from orbslam_mapsave_tpu_torch.vocab import database, vocabulary

src, out = np.load(sys.argv[1]), sys.argv[2]
assert pmesh.initialize_distributed("cpu")
mesh = pmesh.make_mesh(device="cpu")


def part(prefix):
    return {k[len(prefix):]: src[k] for k in src.files if k.startswith(prefix)}


def t(x):
    return torch.from_numpy(np.array(x))


def camera(c):
    return projection.Camera.create(*c[:4], bf=c[4], width=int(c[5]), height=int(c[6]))


res = {}
# dist_ba
cam = camera(src["ba_cam"])
prob = local_ba.BAProblem(**{k: t(v) for k, v in part("ba.").items()})
r = dist_ba.make_distributed_ba(cam, mesh, n_iters=int(src["ba_iters"]))(
    dist_ba.shard_problem(prob, mesh))
res.update({"ba_" + k: v for k, v in r._asdict().items()})
# dist_gba
gcam = camera(src["gba_cam"])
state = interop.map_state_from_numpy(part("gba."))
isig = t(src["isig"])
n_it = int(src["gba_iters"])
res["gba_poses"], res["gba_pts"], res["gba_cost"] = dist_gba.distributed_full_ba(
    gcam, state, isig, mesh, n_iters=n_it)
# placement
sh = dist_gba.shard_map_state(state, mesh)
for f in ("kf_pose", "kf_kp_xy", "covis", "pt_pos", "pt_obs_kf", "n_kf", "n_pt"):
    res["place_" + f] = getattr(sh, f)
tb = dist_gba.shard_tables(global_ba.build_tables(state, isig), mesh)
for f in ("po_cam", "po_uv", "cm_pt", "cm_valid", "pt_valid", "cam_free"):
    res["tb_" + f] = getattr(tb, f)
# dist_reloc
store = database.SparseBowStore(word=t(src["rq_word"]), weight=t(src["rq_weight"]))
q = int(src["rq_q"])
query = dist_reloc.make_distributed_query(mesh, top_k=int(src["rq_top_k"]))
res["rq_slots"], res["rq_scores"] = query(dist_reloc.shard_store(store, mesh),
                                          torch.ones(store.word.shape[0], dtype=torch.bool),
                                          store.word[q], store.weight[q])
# GBAJob
job = gba.GBAJob(state, gcam, isig, n_iters=n_it)
assert job._solver == "multi-rank" and job.done and not job.pump()
applied = job.apply(interop.map_state_from_numpy(part("grown.")))
res["job_pose"], res["job_pts"] = applied.kf_pose, applied.pt_pos
# Relocalizer.candidates
voc = vocabulary.load_binary(sys.argv[3])
rstore = database.SparseBowStore(word=t(src["rc_word"]), weight=t(src["rc_weight"]))
rel = relocalization.Relocalizer(gcam, isig, voc=voc, bow_store_ref=lambda: rstore)
rstate = interop.map_state_from_numpy(part("rcmap."))
frame = SimpleNamespace(desc=t(src["rc_desc"]), valid=t(src["rc_valid"]))
res["rc_cands"] = np.array(rel.candidates(rstate, frame), np.int64)
# diverged replicas: the last rank's map (store) differs in one value; every rank raises
last = mesh.rank == mesh.size - 1
bad = state._replace(pt_pos=state.pt_pos.clone())
bad.pt_pos[0, 0] += float(last)
bstore = rstore._replace(weight=rstore.weight.clone())
bstore.weight[3, 0] += 0.5 * float(last)
brel = relocalization.Relocalizer(gcam, isig, voc=voc, bow_store_ref=lambda: bstore)
for key, fn in (("gba", lambda: dist_gba.distributed_full_ba(gcam, bad, isig, mesh, n_iters=1)),
                ("reloc", lambda: brel.candidates(rstate, frame))):
    try:
        fn()
        res["diverged_" + key] = "no error"
    except ValueError as e:
        res["diverged_" + key] = str(e)
np.savez(out, **{k: v.numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in res.items()})
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, inputs: Path, voc_bin: Path, out_dir: Path) -> list[dict]:
    """Run WORKER on `world` gloo ranks; every rank's results."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}", NUM_PROCESSES=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = []
    for r in range(world):
        out = out_dir / f"w{world}_rank{r}.npz"
        procs.append((subprocess.Popen(
            [sys.executable, "-c", WORKER, str(inputs), str(out), str(voc_bin)],
            env=dict(env, PROCESS_ID=str(r)), cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), out))
    errors = []
    for r, (p, _) in enumerate(procs):
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errors.append(f"rank {r} of {world} killed after {RANK_TIMEOUT_S} s:\n{err[-3000:]}")
            continue
        if p.returncode != 0:
            errors.append(f"rank {r} of {world} exited {p.returncode}:\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    return [dict(np.load(out)) for _, out in procs]


def _reloc_store():
    """`test_distributed_relocalization_query`'s store."""
    rng = np.random.default_rng(3)
    K, M, W = RELOC_K, RELOC_M, RELOC_W
    words = np.sort(rng.choice(W, size=(K, M), replace=True), axis=1)
    for k in range(K):
        words[k] = np.sort(np.unique(np.concatenate(
            [words[k], rng.choice(W, M, replace=False)]))[:M])
    weights = rng.uniform(0.1, 1.0, (K, M)).astype(np.float32)
    weights /= weights.sum(1, keepdims=True)
    return words.astype(np.int32), weights


def _reloc_case():
    """A vocabulary trained by the JAX package, 16 keyframes' sparse BoW rows
    (slot 9 dead) built by its packed transform from descriptors that share
    a pool, and a query frame made from keyframe 6's descriptors, half of
    them with 4 bits of one byte flipped. Keyframes 3 and 12 (one in each
    half of the store) share most of keyframe 6's descriptors."""
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 256, (400, 32), dtype=np.uint8)
    voc = jvoc.train(pool, k=4, L=3, seed=1)
    K, N, m = 16, 64, 48
    transform = jvoc.make_transform_packed(voc)
    descs = np.stack([pool[rng.choice(400, N, replace=False)] for _ in range(K)])
    descs[3, :44], descs[12, :50] = descs[6, :44], descs[6, :50]
    valid = np.ones(N, bool)
    store = jdb.empty_sparse_store(K, m)
    for k in range(K):
        if k == 9:
            continue
        out = transform(jnp.asarray(descs[k]), jnp.asarray(valid))
        w, v = jvoc.sparse_bow(out["word"], out["weight"], m)
        store = jdb.add_keyframe_bow_sparse(store, k, w, v)
    q = descs[6].copy()
    q[::2, 0] ^= 0x0F
    mp = {k: np.asarray(v).copy() for k, v in jms.empty_map(K, 64, 8)._asdict().items()}
    mp["kf_valid"][:] = True
    mp["kf_valid"][9] = False
    return voc, store, q, valid, mp


def _cam_row(cam) -> list:
    return [cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Every case's inputs as numpy arrays, written to one .npz with the
    vocabulary's .bin beside it."""
    d = tmp_path_factory.mktemp("parallel")
    cam, prob, poses_true = _make_problem(np.random.default_rng(42))
    gcam, state, gposes_true, _ = make_map_state(np.random.default_rng(42), n_kf=16, n_pt=512,
                                       kf_cap=20, pt_cap=528, obs_per_pt=5, noise=0.2,
                                       pose_noise=0.04)
    gstate = {k: np.asarray(v) for k, v in state._asdict().items()}
    grown = _grow(interop.map_state_from_numpy(gstate))
    words, weights = _reloc_store()
    voc, rstore, rq, rvalid, rmap = _reloc_case()
    voc_bin = d / "voc.bin"
    jvoc.save_binary(voc_bin, voc)
    src = {"ba_cam": _cam_row(cam), "ba_iters": BA_ITERS, "gba_cam": _cam_row(gcam),
           "gba_iters": GBA_ITERS,
           "isig": ISIG, "rq_word": words, "rq_weight": weights, "rq_q": RELOC_Q,
           "rq_top_k": RELOC_TOP_K, "rc_word": np.asarray(rstore.word),
           "rc_weight": np.asarray(rstore.weight), "rc_desc": rq, "rc_valid": rvalid}
    src.update({"ba." + k: np.asarray(v) for k, v in prob._asdict().items()})
    src.update({"gba." + k: v for k, v in gstate.items()})
    src.update({"grown." + k: v for k, v in grown.items()})
    src.update({"rcmap." + k: v for k, v in rmap.items()})
    np.savez(d / "inputs.npz", **src)
    return SimpleNamespace(dir=d, inputs=d / "inputs.npz", voc_bin=voc_bin, cam=cam,
                           prob=prob, poses_true=poses_true, gcam=gcam, state=state,
                           gposes_true=gposes_true,
                           grown=grown, words=words, weights=weights, voc=voc,
                           rstore=rstore, rq=rq, rvalid=rvalid, rmap=rmap)


@pytest.fixture(scope="module")
def world2(case):
    return _launch(2, case.inputs, case.voc_bin, case.dir)


@pytest.fixture(scope="module")
def world4(case):
    return _launch(4, case.inputs, case.voc_bin, case.dir)


def _jmesh(n: int, axis: str) -> JMesh:
    return JMesh(np.array(jax.devices()[:n]), (axis,))


_JAX_DIST = {}


def _jax_dist_ba(case, n: int):
    if ("ba", n) not in _JAX_DIST:
        mesh = _jmesh(n, "pt")
        _JAX_DIST["ba", n] = jdba.make_distributed_ba(case.cam, mesh, n_iters=BA_ITERS)(
            jdba.shard_problem(case.prob, mesh))
    return _JAX_DIST["ba", n]


def _jax_dist_gba(case, n: int):
    if ("gba", n) not in _JAX_DIST:
        _JAX_DIST["gba", n] = jdgba.distributed_full_ba(
            case.gcam, case.state, jnp.asarray(ISIG), jdgba.make_mesh(n), n_iters=GBA_ITERS)
    return _JAX_DIST["gba", n]


def _check_ba(got: dict, ref):
    np.testing.assert_allclose(got["ba_cam_pose"], np.asarray(ref.cam_pose), atol=POSE_TOL)
    np.testing.assert_allclose(got["ba_pt_pos"], np.asarray(ref.pt_pos), atol=PT_TOL)
    np.testing.assert_allclose(got["ba_chi2"], float(ref.chi2), rtol=COST_RTOL)
    np.testing.assert_array_equal(got["ba_obs_inlier"], np.asarray(ref.obs_inlier))


def _ranks_agree(ranks: list[dict], keys):
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_ba_matches_jax_mesh(case, world, world2, world4):
    ranks = world2 if world == 2 else world4
    _ranks_agree(ranks, ("ba_cam_pose", "ba_pt_pos", "ba_obs_inlier", "ba_chi2"))
    _check_ba(ranks[0], _jax_dist_ba(case, world))


def test_dist_ba_world4_matches_world1_and_truth(case, world4):
    """The port at world 4 against one process (a mesh with no process
    group), and JAX's truth check on it."""
    tcam = tproj.Camera.create(case.cam.fx, case.cam.fy, case.cam.cx, case.cam.cy,
                               bf=case.cam.bf)
    tprob = tlba.BAProblem(*(torch.from_numpy(np.array(x)) for x in case.prob))
    mesh1 = tmesh.make_mesh(device="cpu")
    assert mesh1.size == 1 and not mesh1.grouped
    one = tdba.make_distributed_ba(tcam, mesh1, n_iters=BA_ITERS)(tdba.shard_problem(tprob,
                                                                                    mesh1))
    got = world4[0]
    np.testing.assert_allclose(got["ba_cam_pose"], one.cam_pose.numpy(), atol=POSE_TOL)
    np.testing.assert_allclose(got["ba_pt_pos"], one.pt_pos.numpy(), atol=PT_TOL)
    np.testing.assert_allclose(got["ba_chi2"], float(one.chi2), rtol=COST_RTOL)
    errs = [np.linalg.norm(np.asarray(jse3.se3_log(jnp.asarray(np.linalg.inv(b) @ a))))
            for a, b in zip(got["ba_cam_pose"].astype(np.float64), case.poses_true)]
    assert float(np.mean(errs)) < 5e-3, errs
    np.testing.assert_allclose(got["ba_cam_pose"][:2], np.asarray(case.prob.cam_pose)[:2],
                               atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_gba_matches_jax_mesh(case, world, world2, world4):
    ranks = world2 if world == 2 else world4
    _ranks_agree(ranks, ("gba_poses", "gba_pts", "gba_cost"))
    poses, pts, cost = _jax_dist_gba(case, world)
    got = ranks[0]
    np.testing.assert_allclose(got["gba_poses"], np.asarray(poses), atol=POSE_TOL)
    np.testing.assert_allclose(got["gba_pts"], np.asarray(pts), atol=PT_TOL)
    np.testing.assert_allclose(got["gba_cost"], float(cost), rtol=COST_RTOL)
    assert mean_pose_err(got["gba_poses"][:16], case.gposes_true) < 5e-3


@pytest.mark.parametrize("world", [2, 4])
def test_shard_placement(case, world, world2, world4):
    """JAX `test_shard_map_state_placement`: keyframe- and point-major rows
    in blocks, counts and camera masks whole."""
    ranks = world2 if world == 2 else world4
    st = {k: np.asarray(v) for k, v in case.state._asdict().items()}
    tb = {k: np.asarray(v) for k, v in
          jglob.build_tables(case.state, jnp.asarray(ISIG))._asdict().items()}
    K, P = st["kf_pose"].shape[0], st["pt_pos"].shape[0]
    for r, got in enumerate(ranks):
        ks = slice(r * K // world, (r + 1) * K // world)
        ps = slice(r * P // world, (r + 1) * P // world)
        for f in ("kf_pose", "kf_kp_xy", "covis"):
            np.testing.assert_array_equal(got["place_" + f], st[f][ks], err_msg=f)
        for f in ("pt_pos", "pt_obs_kf"):
            np.testing.assert_array_equal(got["place_" + f], st[f][ps], err_msg=f)
        for f in ("n_kf", "n_pt"):
            np.testing.assert_array_equal(got["place_" + f], st[f], err_msg=f)
        for f in ("cm_pt", "cm_valid"):
            np.testing.assert_array_equal(got["tb_" + f], tb[f][ks], err_msg=f)
        for f in ("po_cam", "po_uv", "pt_valid"):
            np.testing.assert_array_equal(got["tb_" + f], tb[f][ps], err_msg=f)
        np.testing.assert_array_equal(got["tb_cam_free"], tb["cam_free"])


def test_dist_reloc_matches_jax_mesh(case, world4):
    _ranks_agree(world4, ("rq_slots", "rq_scores"))
    store = jdb.SparseBowStore(word=jnp.asarray(case.words), weight=jnp.asarray(case.weights))
    mesh = _jmesh(4, "blk")
    slots, scores = jax.device_get(jdrel.make_distributed_query(mesh, top_k=RELOC_TOP_K)(
        jdrel.shard_store(store, mesh), jnp.ones(RELOC_K, bool), store.word[RELOC_Q],
        store.weight[RELOC_Q]))
    got = world4[0]
    np.testing.assert_array_equal(got["rq_slots"], slots)
    np.testing.assert_allclose(got["rq_scores"], scores, atol=SCORE_TOL)
    assert RELOC_Q in got["rq_slots"]


def test_gba_job_multi_rank_matches_jax(case, world2):
    _ranks_agree(world2, ("job_pose", "job_pts"))
    poses, pts, _ = _jax_dist_gba(case, 2)
    grown = jms.MapState(**{k: jnp.asarray(v) for k, v in case.grown.items()})
    ref = jgba._apply_device(grown, poses, pts, jnp.asarray(16, jnp.int32),
                             jnp.asarray(512, jnp.int32))
    got = world2[0]
    np.testing.assert_allclose(got["job_pose"], np.asarray(ref.kf_pose), atol=POSE_TOL)
    np.testing.assert_allclose(got["job_pts"], np.asarray(ref.pt_pos), atol=PT_TOL)
    # the keyframes made after the snapshot moved with their parents
    assert not np.allclose(got["job_pose"][16], case.grown["kf_pose"][16], atol=1e-6)


def test_relocalizer_candidates_multi_rank_matches_jax(case, world2, monkeypatch):
    """JAX's relocalizer on 2 of the 8 devices takes its sharded branch."""
    _ranks_agree(world2, ("rc_cands",))
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: devices[:2])
    jcam = jproj.Camera.create(FX, FY, CX, CY, bf=BF, width=320, height=240)
    rel = jrel.Relocalizer(jcam, ISIG, voc=case.voc, bow_store_ref=lambda: case.rstore)
    state = jms.MapState(**{k: jnp.asarray(v) for k, v in case.rmap.items()})
    frame = SimpleNamespace(desc=jnp.asarray(case.rq), valid=jnp.asarray(case.rvalid))
    want = rel._candidates(state, frame)
    assert rel._dist is not None and rel._dist[0].devices.size == 2
    assert len(want) > 1 and want[0] == 6
    np.testing.assert_array_equal(world2[0]["rc_cands"], want)


@pytest.mark.parametrize("what", ["gba", "reloc"])
def test_diverged_replicas_raise_on_every_rank(world2, what):
    for r, got in enumerate(world2):
        msg = str(got["diverged_" + what])
        assert "differs across ranks" in msg and msg.startswith(f"rank {r} of 2"), msg


def test_global_bundle_adjustment_matches_jax():
    cam, prob, _, _ = make_ba_problem(np.random.default_rng(42), n_cams=8, n_pts=200,
                                      noise=0.3, pose_noise=0.05)
    ref = jlba.global_bundle_adjustment(cam, prob, n_iters=20)
    tcam = tproj.Camera.create(cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf)
    got = tlba.global_bundle_adjustment(
        tcam, tlba.BAProblem(*(torch.from_numpy(np.array(x)) for x in prob)), n_iters=20)
    np.testing.assert_allclose(got.cam_pose.numpy(), np.asarray(ref.cam_pose), atol=POSE_TOL)
    np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(ref.pt_pos), atol=PT_TOL)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=COST_RTOL)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(ref.obs_inlier))


def test_mesh_without_a_process_group(monkeypatch):
    """No COORDINATOR_ADDRESS: no group, a one-rank mesh whose collectives
    return their input and whose replication check passes; a sharded axis
    must divide by the ranks."""
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert not tmesh.initialize_distributed("cpu")
    assert tmesh.world_size() == 1
    mesh = tmesh.make_mesh(device="cpu")
    x = torch.arange(6.0)
    assert mesh.psum(x) is x and mesh.pmax(x) is x and mesh.all_gather(x) is x
    assert mesh.axis_index() == 0 and torch.equal(tmesh.local_rows(x, mesh), x)
    tmesh.check_replicated(mesh, "x", torch.tensor(1.0))
    with pytest.raises(ValueError):
        tmesh.local_rows(x, tmesh.Mesh(4, 0, torch.device("cpu"), False))
