"""Parity: the port's loop closer against the JAX package on a synthetic
drifted loop, built with numpy and carried across with `interop`.

The map: a camera on a 0.5 m circle looks out at 1,200 points on a 4 m
cylinder, one keyframe every 22.5 degrees, 20 keyframes, so keyframes 16-19
see again what keyframes 0-3 saw. Odometry drift (yaw and translation
growing with the keyframe) moves the estimated poses and the points each
keyframe creates; a point seen by one of the last 3 keyframes is tracked
(its slot reused), any other gets a new slot, so the revisit duplicates the
old points and the two ends share no point: the loop is there to close.

Checked: the detection program (ids, scores within 1e-6, groups), the Sim3
chain fed the JAX run's RANSAC hypotheses (acceptance, S12 within 1e-4,
matched points and loop points equal), the correction program (the
window-bitmask quirk included: poses within 1e-4, points within 1e-3,
integer tables equal), the essential graph, and a process / poll sequence
over all keyframes that gives the same LoopEvents.

The monocular variant drifts in scale too (each keyframe's estimated world
is a similarity of the true one, its scale growing 1.2% per keyframe) and
has no depth: both packages' closers run with `fix_scale=False`, and the
Sim3 chain, the correction and the essential graph must carry the same
scale s != 1."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.pipeline import loop_closing as jlc
from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu.vocab import vocabulary as jvoc
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.pipeline import loop_closing as tlc
from orbslam_mapsave_tpu_torch.vocab import vocabulary as tvoc

torch.set_num_threads(2)
POSE_TOL, PT_TOL = 1e-4, 1e-3
W, H, F, BF = 640, 480, 320.0, 25.6
K_CAP, N_FEAT, P_CAP = 33, 384, 4096  # JAX top-k needs K >= 32
N_KF, STEP = 20, 2 * np.pi / 16
SCALES = np.array([1.5 ** i for i in range(4)], np.float32)
ISIG = (1.0 / SCALES ** 2).astype(np.float32)
QUERY, MATCH = 19, 3  # the keyframe that closes the loop and its match


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _true_pose(k, spiral=0.0):
    """Tcw of keyframe k: centre on the 0.5 m circle (a spiral growing by
    `spiral` m per keyframe), looking outward."""
    th = k * STEP
    f = np.array([np.sin(th), 0.0, np.cos(th)])
    R_wc = np.stack([np.array([np.cos(th), 0.0, -np.sin(th)]), [0.0, 1.0, 0.0], f], 1)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ ((0.5 + spiral * k) * f)
    return T


SCALE_DRIFT = 0.012  # per keyframe, the monocular variant's log-scale drift
SPIRAL = 0.02  # m per keyframe: the monocular revisit sees the place from 0.32 m
# farther out (at the same centre the loop's scale would be unobservable)


def _drift(k, scale_drift=0.0):
    """G_k: the estimated world is G_k applied to the true one (a Sim3 when
    the scale drifts)."""
    G = np.eye(4)
    G[:3, :3] = np.exp(scale_drift * k) * _rot_y(np.deg2rad(0.35 * k))
    G[:3, 3] = k * np.array([0.008, 0.003, -0.006])
    return G


@lru_cache(maxsize=2)
def _world(mono=False):
    """Every keyframe's features and every point slot, in creation order.
    Mono: the estimated Tcw of keyframe k is diag(s_k) T_k G_k^-1 (rigid:
    camera coordinates scale with the world), on the spiral."""
    scale_drift, spiral = (SCALE_DRIFT, SPIRAL) if mono else (0.0, 0.0)
    rng = np.random.default_rng(11)
    n_phys = 1200
    phi = rng.uniform(0, 2 * np.pi, n_phys)
    X = np.stack([4 * np.sin(phi), rng.uniform(-1.4, 1.4, n_phys), 4 * np.cos(phi)], -1)
    D = rng.integers(0, 256, (n_phys, 32), dtype=np.uint8)
    last_slot, last_kf = {}, {}
    slots = []  # (physical id, creating kf, position, max_dist, normal)
    kfs = []
    for k in range(N_KF):
        T = _true_pose(k, spiral)
        G = _drift(k, scale_drift)
        T_est = np.diag([np.exp(scale_drift * k)] * 3 + [1.0]) @ T @ np.linalg.inv(G)
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = F * pc[:, :2] / pc[:, 2:3] + [W / 2, H / 2]
        vis = np.nonzero((pc[:, 2] > 0.3) & (uv[:, 0] > 10) & (uv[:, 0] < W - 10)
                         & (uv[:, 1] > 10) & (uv[:, 1] < H - 10))[0]
        n_noise = 24
        if len(vis) > N_FEAT - n_noise:
            vis = np.sort(rng.choice(vis, N_FEAT - n_noise, replace=False))
        feats = []
        centre_est = np.linalg.inv(T_est)[:3, 3]
        for p in vis:
            if p in last_slot and last_kf[p] >= k - 3:
                s = last_slot[p]
            else:
                s = len(slots)
                Xe = G[:3, :3] @ X[p] + G[:3, 3]
                d = np.linalg.norm(Xe - centre_est)
                slots.append((p, k, Xe, 1.2 * d, (Xe - centre_est) / d))
                last_slot[p] = s
            last_kf[p] = k
            flip = (rng.random((32, 8)) < 0.02) * (1 << np.arange(8))
            feats.append((s, uv[p] + rng.normal(size=2) * 0.3, pc[p, 2],
                          D[p] ^ flip.sum(-1).astype(np.uint8)))
        for _ in range(n_noise):
            feats.append((-1, rng.uniform([10, 10], [W - 10, H - 10]), rng.uniform(2, 5),
                          rng.integers(0, 256, 32, dtype=np.uint8)))
        kfs.append((T_est, feats))
    return kfs, slots, D


def map_numpy(n_kf=N_KF, mono=False) -> dict:
    """The map after keyframe n_kf - 1, as numpy arrays of a JAX MapState
    (mono: with the scale drift, and no depth or right-u)."""
    kfs, slots, D = _world(mono)
    h = {k: np.array(v) for k, v in jms.empty_map(K_CAP, P_CAP, N_FEAT)._asdict().items()}
    obs = {}
    for k in range(n_kf):
        T_est, feats = kfs[k]
        h["kf_pose"][k] = T_est
        h["kf_valid"][k] = True
        h["kf_timestamp"][k] = 0.3 * k
        h["kf_frame_id"][k] = 10 * k
        h["kf_parent"][k] = k - 1
        for i, (s, uv, z, desc) in enumerate(feats):
            h["kf_kp_xy"][k, i] = uv
            h["kf_kp_ur"][k, i] = -1.0 if mono else uv[0] - BF / z
            h["kf_kp_depth"][k, i] = -1.0 if mono else z
            h["kf_kp_angle"][k, i] = 45.0 + (i % 5) * 0.3
            h["kf_kp_valid"][k, i] = True
            h["kf_desc"][k, i] = desc
            h["kf_kp_point"][k, i] = s
            if s >= 0:
                obs.setdefault(s, []).append((k, i))
    n_pt = max(obs) + 1
    for s, lanes in obs.items():
        p, k0, Xe, dmax, normal = slots[s]
        h["pt_pos"][s], h["pt_valid"][s], h["pt_desc"][s] = Xe, True, D[p]
        h["pt_normal"][s], h["pt_max_dist"][s] = normal, dmax
        h["pt_min_dist"][s] = dmax / 1.5 ** 3
        h["pt_ref_kf"][s] = h["pt_first_kf"][s] = k0
        h["pt_visible"][s] = h["pt_found"][s] = len(lanes)
        for j, (k, i) in enumerate(lanes[:jms.MAX_OBS]):
            h["pt_obs_kf"][s, j], h["pt_obs_idx"][s, j], h["pt_obs_oct"][s, j] = k, i, 0
    fwd = h["kf_kp_point"][:n_kf]
    for a in range(n_kf):
        for b in range(a + 1, n_kf):
            c = len(np.intersect1d(fwd[a][fwd[a] >= 0], fwd[b][fwd[b] >= 0]))
            h["covis"][a, b] = h["covis"][b, a] = c if c >= jms.COVIS_MIN_WEIGHT else 0
    h["n_kf"], h["n_pt"] = np.int32(n_kf), np.int32(n_pt)
    return h


def _jstate(h):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in h.items()})


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@lru_cache(maxsize=2)
def _closers(fix_scale=True):
    """One JAX and one port LoopCloser over the same trained vocabulary
    (JAX programs compile once per module and scale mode). The JAX closer
    starts no global BA; the port's starts its job at a loop event, and the
    tests compare before the job runs (tests/test_torch_global_ba.py holds
    the job)."""
    h = map_numpy()
    desc = h["kf_desc"][h["kf_kp_valid"]]
    jv, tv = jvoc.train(desc, k=8, L=3, seed=1), tvoc.train(desc, k=8, L=3, seed=1)
    kw = dict(scale_factors=SCALES, n_levels=4, scale_factor=1.5)
    jcl = jlc.LoopCloser(jproj.Camera.create(F, F, W / 2, H / 2, bf=BF, width=W, height=H),
                         ISIG, jv, fix_scale=fix_scale, enable_gba=False, **kw)
    tcl = tlc.LoopCloser(tproj.Camera.create(F, F, W / 2, H / 2, bf=BF, width=W, height=H),
                         ISIG, tv, fix_scale=fix_scale, **kw)
    return jcl, tcl


def _fresh(cl):
    """A closer's per-run state back to empty (both packages' fields)."""
    cl.bow_store = None
    cl.consistent_groups = []
    cl.events = []
    cl._pending_detect = cl._pending_sim3 = None
    cl.last_loop_kf = -tlc.REFRACTORY_KFS - 1
    if getattr(cl, "pending_gba", None) is not None:
        cl.pending_gba.abort()
        cl.pending_gba = None
    return cl


def _stores(h, fix_scale=True):
    """Both closers' BoW stores filled with every keyframe of h."""
    jcl, tcl = map(_fresh, _closers(fix_scale))
    js, ts = _jstate(h), interop.map_state_from_numpy(h)
    jcl._ensure_store(js)
    tcl._ensure_store(ts)
    for k in range(int(h["n_kf"])):
        jcl.bow_store, *_ = jcl._build_bow_add_one(jcl.bow_store.word.shape[1])(
            jcl.transform.tables, jcl.bow_store, js, jnp.asarray(k, jnp.int32))
        w, v = tcl.compute_bow(ts, k)
        tcl.bow_store = tlc.database.add_keyframe_bow_sparse(tcl.bow_store, k, w, v)
    carried = interop.map_state_from_numpy(jcl.bow_store)  # JAX store -> port
    assert isinstance(carried, tlc.database.SparseBowStore)
    np.testing.assert_array_equal(_np(tcl.bow_store.word), _np(carried.word))
    np.testing.assert_allclose(_np(tcl.bow_store.weight), _np(carried.weight), atol=1e-6)
    return jcl, tcl, js, ts


def test_map_is_a_closable_loop():
    h = map_numpy()
    assert h["covis"][QUERY, MATCH] == 0 and h["covis"][QUERY, QUERY - 1] > 100
    assert int(h["n_pt"]) < P_CAP and h["kf_kp_valid"].sum(-1).max() <= N_FEAT


def test_detect_device():
    jcl, tcl, js, ts = _stores(map_numpy())
    for kf in (12, 16, QUERY):
        qj = jcl.compute_bow(js, kf)
        qt = tcl.compute_bow(ts, kf)
        oj = jax.device_get(jlc._detect_device(jcl.bow_store, js, *qj, jnp.asarray(kf)))
        ot = tlc._detect_device(tcl.bow_store, ts, *qt, kf)
        live = np.isfinite(oj[1])
        np.testing.assert_array_equal(_np(ot[0])[live], oj[0][live])
        np.testing.assert_allclose(_np(ot[1]), oj[1], atol=1e-6)
        np.testing.assert_array_equal(_np(ot[2])[live], oj[2][live])
        assert bool(ot[3]) == bool(oj[3])
        if kf >= 16:  # the revisit finds its old place first
            assert int(_np(ot[0])[0]) == kf - 16


def _jax_hypotheses(tcl, ts, kf, cand):
    """The RANSAC hypotheses the JAX chain draws from PRNGKey(kf): 300
    draws of 3 matches without replacement over the descriptor matches."""
    from orbslam_mapsave_tpu_torch.ops import hamming, matching

    f1, f2 = tcl._per_feature_points(ts, kf), tcl._per_feature_points(ts, cand)
    matches, _ = matching.search_by_descriptor(
        hamming.unpack_bits(ts.kf_desc[kf]), f1["ok"], hamming.unpack_bits(ts.kf_desc[cand]),
        f2["ok"], ts.kf_kp_angle[kf], ts.kf_kp_angle[cand], th=hamming.TH_LOW, nn_ratio=0.75)
    m_ok = jnp.asarray(_np(matches) >= 0)
    p = m_ok.astype(jnp.float32) / jnp.maximum(m_ok.sum(), 1)
    keys = jax.random.split(jax.random.PRNGKey(kf), 300)
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.choice(k, m_ok.shape[0], (3,), replace=False, p=p))(keys)))


@lru_cache(maxsize=1)
def _chain():
    """The Sim3 chain of the closing pair on both sides, on the same map."""
    jcl, tcl = map(_fresh, _closers())
    h = map_numpy()
    js, ts = _jstate(h), interop.map_state_from_numpy(h)
    if jcl._sim3_device is None:
        jcl._sim3_device = jcl._build_sim3_device()
    oj = jax.device_get(jcl._sim3_device(js, jnp.asarray(QUERY, jnp.int32),
                                         jnp.asarray(MATCH, jnp.int32),
                                         jax.random.PRNGKey(QUERY)))
    ot = tcl._sim3_chain(ts, QUERY, MATCH, hyp_idx=_jax_hypotheses(tcl, ts, QUERY, MATCH))
    return h, oj, {k: _np(v) for k, v in ot.items()}


def test_sim3_chain_with_fed_hypotheses():
    _, oj, ot = _chain()
    assert bool(ot["accept"]) and bool(oj["accept"])
    np.testing.assert_allclose(ot["S12"], oj["S12"], atol=POSE_TOL)
    assert int(ot["n2"]) == int(oj["n2"]) >= 20
    np.testing.assert_array_equal(ot["matched_pt"], oj["matched_pt"])
    np.testing.assert_array_equal(ot["loop_pts"], oj["loop_pts"])
    assert (ot["matched_pt"] >= 0).sum() >= 40


@lru_cache(maxsize=1)
def _corrected():
    """The correction program on both sides from the same inputs."""
    jcl, tcl = _closers()
    h, _, ot = _chain()
    if jcl._correct_device is None:
        jcl._correct_device = jcl._build_correct_device()
    args = (ot["S12"], ot["matched_pt"], ot["loop_pts"])
    oj = jcl._correct_device(_jstate(h), jnp.asarray(QUERY, jnp.int32),
                             jnp.asarray(MATCH, jnp.int32), *map(jnp.asarray, args))
    otc = tcl._correct(interop.map_state_from_numpy(h), QUERY, MATCH,
                       *map(torch.from_numpy, args))
    return h, {k: np.asarray(v) for k, v in oj._asdict().items()}, \
        interop.map_state_to_numpy(otc)


def _assert_same_map(a: dict, b: dict):
    """Poses within 1e-4, live points within 1e-3, every other field equal."""
    for k in a:
        if k == "kf_pose":
            np.testing.assert_allclose(a[k], b[k], atol=POSE_TOL, err_msg=k)
        elif k in ("pt_pos", "pt_normal"):
            live = a["pt_valid"]
            np.testing.assert_allclose(a[k][live], b[k][live], atol=PT_TOL, err_msg=k)
        elif k in ("pt_min_dist", "pt_max_dist"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_correction_program():
    h, oj, ot = _corrected()
    _assert_same_map(ot, oj)
    assert MATCH in ot["kf_loop_edges"][QUERY] and QUERY in ot["kf_loop_edges"][MATCH]
    moved = np.abs(ot["kf_pose"] - h["kf_pose"]).max((1, 2)) > 1e-6
    assert moved[QUERY] and not moved[MATCH]


def test_correction_window_bitmask_quirk():
    """Kept for parity: the window bitmask is a MAX scatter into 32-slot
    int32 words, so each word keeps only its highest window keyframe, and
    bit 31 (negative) never wins. Here only the query (19) drives the point
    correction: the points that survive the fusion, seen by the window
    keyframes 16-18 and not by the query, keep their positions although
    those keyframes moved."""
    wmask = torch.zeros(64, dtype=torch.bool)
    wmask[[3, 5, 31, 40, 63]] = True
    obs = torch.tensor([[3, 5, -1], [31, -1, -1], [40, 2, 63], [-1, -1, -1]], dtype=torch.int32)
    np.testing.assert_array_equal(tlc._window_lanes(wmask, obs).numpy(),
                                  [[False, True, False], [False, False, False],
                                   [True, False, False], [False, False, False]])
    h, _, ot = _corrected()
    assert [k for k in range(K_CAP) if h["covis"][QUERY, k] > 0] == [16, 17, 18]
    obs = h["pt_obs_kf"]
    only = (h["pt_valid"] & np.isin(obs, [16, 17, 18]).any(-1) & ~(obs == QUERY).any(-1)
            & ot["pt_valid"])
    assert only.sum() >= 5
    np.testing.assert_array_equal(ot["pt_pos"][only], h["pt_pos"][only])
    moved = np.abs(ot["kf_pose"] - h["kf_pose"]).max((1, 2)) > 1e-6
    assert moved[16] and moved[17] and moved[18]


def _essential_exit_vs_full(tcl, h: dict) -> tuple:
    """The port's `_essential` on the map h twice: as it runs (the solver's
    early exit) and with `pose_graph._optimize_pose_graph_full` in the
    solver's place. Every map field bit-equal, the full loop 20 LM
    iterations. Returns (the map, the solvers asked for, the LM iterations
    the first run ran)."""
    pg = tlc.pose_graph
    solve_exit, runs = pg.optimize_pose_graph, []
    for solve in (solve_exit, pg._optimize_pose_graph_full):
        solvers = []

        def recorded(prob, *a, solve=solve, solvers=solvers, **k):
            solvers.append(k.get("solver"))
            return solve(prob, *a, **k)

        pg.optimize_pose_graph = recorded
        pg.reset_iterations()
        try:
            out = tcl._essential(interop.map_state_from_numpy(h), QUERY, MATCH)
        finally:
            pg.optimize_pose_graph = solve_exit
        runs.append((out, solvers, pg.iterations))
    (out, solvers, ran), (full, solvers_full, ran_full) = runs
    assert solvers == solvers_full and ran_full == 20
    differ = [k for k, a, b in zip(out._fields, out, full) if not torch.equal(a, b)]
    assert not differ, differ
    return out, solvers, ran


def test_essential_graph():
    """JAX parity, and the early exit: the edge buffer has dead lanes, so
    the solve stops after one linearization, bit-equal to the full loop."""
    jcl, tcl = _closers()
    _, _, ot = _corrected()
    if jcl._essential_device is None:
        jcl._essential_device = jcl._build_essential_device()
    oj = jcl._essential_device(_jstate(ot), jnp.asarray(QUERY, jnp.int32),
                               jnp.asarray(MATCH, jnp.int32))
    out, solvers, ran = _essential_exit_vs_full(tcl, ot)
    assert solvers == ["dense"] and ran == 1
    _assert_same_map(interop.map_state_to_numpy(out),
                     {k: np.asarray(v) for k, v in oj._asdict().items()})


def test_process_poll_sequence():
    """Every keyframe through `process` on the map as it stood after it,
    then the two flush polls: the same LoopEvents on both sides (each side
    draws its own RANSAC hypotheses) and the same corrected map (the port's
    global-BA job is queued, not yet pumped)."""
    jcl, tcl = map(_fresh, _closers())
    for k in range(N_KF):
        h = map_numpy(k + 1)
        jcl.process(_jstate(h), k)
        tcl.process(interop.map_state_from_numpy(h), k)
    h = map_numpy()
    js, ts = _jstate(h), interop.map_state_from_numpy(h)
    for _ in range(2):
        js, ts = jcl.poll_detect(js), tcl.poll_detect(ts)
    ev_j = [(e.query_kf, e.match_kf, e.n_inliers) for e in jcl.events]
    ev_t = [(e.query_kf, e.match_kf, e.n_inliers) for e in tcl.events]
    # the consistency chain (detections at 3 keyframes in a row before it,
    # with overlapping candidate groups) completes at keyframe 17, which
    # closes the loop on keyframe 1
    assert ev_t == ev_j and len(ev_t) == 1 and ev_t[0][:2] == (17, 1)
    assert tcl.last_loop_kf == 17
    # the port's global-BA job is queued and has not run yet
    job = tcl.pending_gba
    assert job is not None and job.iters_left == tlc.N_GBA_ITERS and not job.done
    _assert_same_map(interop.map_state_to_numpy(ts),
                     {k: np.asarray(v) for k, v in js._asdict().items()})


def test_process_poll_with_the_jax_vocabulary(tmp_path):
    """The port handed the JAX package's vocabulary through a .bin file (as
    the kidnap run is, where the two packages' own vocabularies differ):
    the same LoopEvents as the JAX closer's."""
    jcl, _ = map(_fresh, _closers())
    jvoc.save_binary(tmp_path / "voc.bin", jcl.voc)
    tcl = tlc.LoopCloser(tproj.Camera.create(F, F, W / 2, H / 2, bf=BF, width=W, height=H),
                         ISIG, tvoc.load_binary(tmp_path / "voc.bin"), scale_factors=SCALES,
                         n_levels=4, scale_factor=1.5)
    for k in range(N_KF):
        h = map_numpy(k + 1)
        jcl.process(_jstate(h), k)
        tcl.process(interop.map_state_from_numpy(h), k)
    h = map_numpy()
    js, ts = _jstate(h), interop.map_state_from_numpy(h)
    for _ in range(2):
        js, ts = jcl.poll_detect(js), tcl.poll_detect(ts)
    ev = [[(e.query_kf, e.match_kf, e.n_inliers) for e in cl.events] for cl in (jcl, tcl)]
    assert ev[0] == ev[1] and len(ev[0]) == 1


def test_remap_keyframes():
    """A keyframe compaction moves the BoW rows and the detector's host
    bookkeeping to the new slots, and drops the pending stages."""
    _, tcl, _, ts = _stores(map_numpy())
    tcl.consistent_groups = [({2, 5, 7}, 2), ({7}, 1)]
    tcl.last_loop_kf = 5
    tcl._pending_detect = (9, None)
    new_of_old = np.full(K_CAP, -1, np.int64)
    keep = [k for k in range(N_KF) if k != 2]
    new_of_old[keep] = np.arange(len(keep))
    rows = _np(tcl.bow_store.word).copy()
    tcl.remap_keyframes(new_of_old)
    np.testing.assert_array_equal(_np(tcl.bow_store.word)[:len(keep)], rows[keep])
    assert (_np(tcl.bow_store.word)[len(keep):] == tvoc._PAD).all()
    assert tcl.consistent_groups == [({4, 6}, 2), ({6}, 1)]
    assert tcl.last_loop_kf == 4 and tcl._pending_detect is None


@pytest.mark.parametrize("stage", ["detect", "sim3"])
def test_refractory_drops_stale_stages(stage):
    """A stage enqueued before a loop closed nearby is dropped when read."""
    _, tcl = _closers()
    tcl = _fresh(tcl)
    ts = interop.map_state_from_numpy(map_numpy())
    tcl.last_loop_kf = 15
    if stage == "detect":
        tcl._pending_detect = (17, None)
    else:
        tcl._pending_sim3 = (17, [3], None)
    out = tcl.poll_detect(ts)
    assert out is ts and tcl._pending_detect is None and tcl._pending_sim3 is None
    assert not tcl.events


def test_free_scale_loop():
    """The monocular variant (scale drift, no depth) through detection, the
    Sim3 chain fed JAX's hypotheses, the correction and the essential graph
    with `fix_scale=False` on both sides: the same results, and a recovered
    loop scale that is not 1."""
    h = map_numpy(mono=True)
    jcl, tcl, js, ts = _stores(h, fix_scale=False)
    assert not jcl.fix_scale and not tcl.fix_scale
    qj, qt = jcl.compute_bow(js, QUERY), tcl.compute_bow(ts, QUERY)
    oj = jax.device_get(jlc._detect_device(jcl.bow_store, js, *qj, jnp.asarray(QUERY)))
    ot = tlc._detect_device(tcl.bow_store, ts, *qt, QUERY)
    np.testing.assert_array_equal(_np(ot[0])[np.isfinite(oj[1])], oj[0][np.isfinite(oj[1])])
    assert int(_np(ot[0])[0]) == MATCH
    # the Sim3 chain
    if jcl._sim3_device is None:
        jcl._sim3_device = jcl._build_sim3_device()
    cj = jax.device_get(jcl._sim3_device(js, jnp.asarray(QUERY, jnp.int32),
                                         jnp.asarray(MATCH, jnp.int32),
                                         jax.random.PRNGKey(QUERY)))
    ct = {k: _np(v) for k, v in tcl._sim3_chain(
        ts, QUERY, MATCH, hyp_idx=_jax_hypotheses(tcl, ts, QUERY, MATCH)).items()}
    assert bool(ct["accept"]) and bool(cj["accept"])
    np.testing.assert_allclose(ct["S12"], cj["S12"], atol=POSE_TOL)
    assert int(ct["n2"]) == int(cj["n2"]) >= 20
    np.testing.assert_array_equal(ct["matched_pt"], cj["matched_pt"])
    s12 = np.cbrt(np.linalg.det(ct["S12"][:3, :3]))
    # camera 2 (the match) is scaled by s_3, camera 1 by s_19, near enough:
    # a tracked point keeps the scale of the keyframe that made it, up to 3
    # keyframes earlier
    np.testing.assert_allclose(s12, np.exp(SCALE_DRIFT * (QUERY - MATCH)), rtol=0.05)
    assert abs(s12 - 1.0) > 0.1
    # the correction and the essential graph carry that scale
    if jcl._correct_device is None:
        jcl._correct_device = jcl._build_correct_device()
    args = (ct["S12"], ct["matched_pt"], ct["loop_pts"])
    cor_j = jcl._correct_device(js, jnp.asarray(QUERY, jnp.int32),
                                jnp.asarray(MATCH, jnp.int32), *map(jnp.asarray, args))
    cor_t = tcl._correct(ts, QUERY, MATCH, *map(torch.from_numpy, args))
    a, b = (interop.map_state_to_numpy(cor_t),
            {k: np.asarray(v) for k, v in cor_j._asdict().items()})
    _assert_same_map(a, b)
    moved = np.abs(a["kf_pose"] - h["kf_pose"]).max((1, 2)) > 1e-6
    assert moved[QUERY] and not moved[MATCH]
    if jcl._essential_device is None:
        jcl._essential_device = jcl._build_essential_device()
    ess_j = jcl._essential_device(cor_j, jnp.asarray(QUERY, jnp.int32),
                                  jnp.asarray(MATCH, jnp.int32))
    ess_t = tcl._essential(cor_t, QUERY, MATCH)
    _assert_same_map(interop.map_state_to_numpy(ess_t),
                     {k: np.asarray(v) for k, v in ess_j._asdict().items()})


def _at_capacities(h: dict, K: int, P: int, N: int) -> dict:
    """The map h copied into an empty map of K keyframe, P point and N
    feature slots (the same live content, more padding)."""
    big = {k: np.array(v) for k, v in jms.empty_map(K, P, N)._asdict().items()}
    for k, v in h.items():
        if np.ndim(v) == 0:
            big[k] = v
        else:
            big[k][tuple(slice(0, d) for d in np.shape(v))] = v
    return big


def test_essential_graph_at_default_capacities():
    """The corrected map of test_essential_graph at SystemConfig's default
    capacities (512 keyframes, 65,536 points, 2,048 features): past
    K = 384 both loop closers run the CG essential graph, and the results
    agree as in test_essential_graph. The edge buffer has dead lanes, so
    the CG solve, like the dense one, returns its input
    (test_torch_pose_graph.py::test_cg_matches_jax[dead_lanes]); the port's
    early exit stops it after one linearization, bit-equal to the full
    loop."""
    from orbslam_mapsave_tpu_torch import config as tcfg

    cfg = tcfg.SystemConfig()
    jcl, tcl = _closers()
    _, _, ot = _corrected()
    h = _at_capacities(ot, cfg.max_keyframes, cfg.max_points, cfg.max_keypoints)
    assert h["kf_pose"].shape[0] == 512 > 384
    if jcl._essential_device is None:
        jcl._essential_device = jcl._build_essential_device()
    oj = jcl._essential_device(_jstate(h), jnp.asarray(QUERY, jnp.int32),
                               jnp.asarray(MATCH, jnp.int32))
    out, solvers, ran = _essential_exit_vs_full(tcl, h)
    assert solvers == ["cg"] and ran == 1
    _assert_same_map(interop.map_state_to_numpy(out),
                     {k: np.asarray(v) for k, v in oj._asdict().items()})
