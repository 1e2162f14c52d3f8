"""Local BA on the card, where each LM iteration is one CUDA graph replay
over static buffers (`local_ba._LMGraphs`), against a plain loop of
`local_ba._lm_step` on the caller's tensors (`eager_phase`,
`eager_local_ba`, the oracle `test_torch_local_ba.py` uses too) on the
same device.

The problems: those of `test_torch_local_ba.py` (`CASES`, its generator
and seeds, with the port's `se3_exp` in place of JAX's, which the card
lacks), robust and plain phases, `abort` both ways; its O_BA_ESC
escalation map (16 lanes); and the windows the port's own mapper builds on
the card over the orbit sequence of `test_torch_local_mapping.py`, with
64 keyframe slots so that they have the benchmark's shapes (C = 64,
L = 4,096, O = 8). Every `BAResult` field is bit-identical to the
oracle's, in as many LM iterations (`mapping.ba_graph_replays`); one graph
is captured per key; a result outlives the next call; a steady call makes
one host sync per LM iteration and no other.

Needs a CUDA device; skipped elsewhere. On the card (`tests/conftest.py`
imports jax, which the card lacks):
    python -m pytest tests/test_torch_local_ba_graph.py -q -m cuda --noconftest
"""

import linecache
import warnings

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch.geometry import projection, se3
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.optim import local_ba
from orbslam_mapsave_tpu_torch.pipeline import local_mapping
from orbslam_mapsave_tpu_torch.pipeline import system as tsys
from orbslam_mapsave_tpu_torch.slammap import mapstate as tms
from orbslam_mapsave_tpu_torch.utils import metrics

pytestmark = pytest.mark.cuda

CAM = projection.Camera.create(525.0, 525.0, 319.5, 239.5, bf=40.0)
CASES = {
    "clean": dict(noise=0.0),
    "noisy_outliers": dict(noise=0.4, outliers=0.1),
    "stereo": dict(stereo=True, noise=0.2),
    "stereo_outliers": dict(stereo=True, noise=0.3, outliers=0.1),
}
# The host reads a steady local BA makes besides the one read of `small`
# after each LM iteration (`local_ba._run_phase`): none. The one-hot, the costs,
# the inlier split, the SO(3) projection (`rt_to_mat`'s device fill) and
# the copies into and out of the static buffers all stay on the device.
WRAPPER_READS: tuple = ()


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def empty_graphs():
    local_ba._GRAPHS.clear()
    yield
    local_ba._GRAPHS.clear()


def _problem(seed, dev, n_cams=6, n_pts=120, obs_per_pt=4, noise=0.3, pose_noise=0.02,
             pt_noise=0.05, stereo=False, outliers=0.0) -> local_ba.BAProblem:
    """`test_torch_local_ba._problem`, with the port's se3_exp (float64)."""
    rng = np.random.default_rng(seed)

    def exp(xi):
        return se3.se3_exp(torch.from_numpy(np.asarray(xi, np.float64))).numpy()

    pts_true = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                         rng.uniform(4, 9, n_pts)], axis=-1)
    poses_true = np.zeros((n_cams, 4, 4))
    for c in range(n_cams):
        poses_true[c] = exp(np.concatenate([[0.3 * c, 0.02 * c, 0.01 * c],
                                            rng.normal(size=3) * 0.01]))
    O = obs_per_pt
    obs_cam = np.full((n_pts, O), -1, np.int32)
    obs_uv = np.zeros((n_pts, O, 2), np.float32)
    obs_ur = np.full((n_pts, O), -1.0, np.float32)
    for p in range(n_pts):
        for lane, c in enumerate(rng.choice(n_cams, size=O, replace=False)):
            pc = poses_true[c, :3, :3] @ pts_true[p] + poses_true[c, :3, 3]
            u = 525.0 * pc[0] / pc[2] + 319.5 + rng.normal() * noise
            v = 525.0 * pc[1] / pc[2] + 239.5 + rng.normal() * noise
            obs_cam[p, lane] = c
            obs_uv[p, lane] = (u, v)
            if stereo:
                obs_ur[p, lane] = u - 40.0 / pc[2] + rng.normal() * noise
    obs_uv[:int(outliers * n_pts), 0, 0] += 80.0
    poses0 = poses_true.copy()
    for c in range(2, n_cams):
        poses0[c] = exp(rng.normal(size=6) * pose_noise) @ poses_true[c]
    pts0 = pts_true + rng.normal(size=pts_true.shape) * pt_noise
    d = dict(cam_pose=poses0.astype(np.float32), cam_fixed=np.arange(n_cams) <= 1,
             cam_valid=np.ones(n_cams, bool), pt_pos=pts0.astype(np.float32),
             pt_valid=np.ones(n_pts, bool), obs_cam=obs_cam, obs_uv=obs_uv, obs_ur=obs_ur,
             obs_inv_sigma2=np.ones((n_pts, O), np.float32), obs_valid=obs_cam >= 0)
    return local_ba.BAProblem(**{k: torch.from_numpy(np.array(v)).to(dev)
                                 for k, v in d.items()})


def eager_phase(cam, poses, pts, prob, oh, active, robust, n_iters, lam0):
    """`local_ba._run_phase` as a plain loop of `_lm_step` on the caller's
    tensors: (poses, pts, cost, the LM iterations run)."""
    free = (prob.cam_valid & ~prob.cam_fixed)[:, None]
    cur = local_ba._cost_at(cam, poses, pts, prob, oh, active, robust)
    lam, small = lam0, torch.zeros((), dtype=torch.int32, device=pts.device)
    n = 0
    while n < n_iters:
        poses, pts, lam, cur, small = local_ba._lm_step(cam, prob, oh, active, robust, free,
                                                        poses, pts, lam, cur, small)
        n += 1
        if int(small) >= 2:
            break
    return se3.orthonormalize(poses), pts, cur, n


def eager_local_ba(cam, prob, abort=False):
    """`local_ba.local_bundle_adjustment`'s schedule on `eager_phase`:
    (the `BAResult`, the LM iterations run)."""
    oh = local_ba._onehot_cam(prob)
    struct = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    lam0 = torch.full((), 1e-4, dtype=prob.pt_pos.dtype, device=prob.pt_pos.device)
    poses, pts, _, n = eager_phase(cam, prob.cam_pose, prob.pt_pos, prob, oh, struct, True, 5,
                                   lam0)
    if not abort:
        active, _ = local_ba._inliers(cam, poses, pts, prob, oh, struct)
        poses, pts, _, nb = eager_phase(cam, poses, pts, prob, oh, active, False, 10, lam0)
        n += nb
    inlier, chi2 = local_ba._inliers(cam, poses, pts, prob, oh, struct)
    total = torch.sum(torch.where(inlier, chi2, torch.zeros_like(chi2)))
    return local_ba.BAResult(cam_pose=poses, pt_pos=pts, obs_inlier=inlier, chi2=total), n


def _counters(fn, *args):
    """(the tracer's counters while fn runs, its result)."""
    metrics.reset()
    metrics.enable()
    try:
        out = fn(*args)
        torch.cuda.synchronize()
        s = metrics.summary()
    finally:
        metrics.disable()
        metrics.reset()
    return s["counters"], out


def _assert_same(got, want, what):
    for name, a, b in zip(local_ba.BAResult._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert torch.equal(a, b), (what, name, (a != b).sum().item())


def _assert_graph_equals_eager(cam, prob, abort, what):
    want, n_eager = eager_local_ba(cam, prob, abort)
    counters, got = _counters(local_ba.local_bundle_adjustment, cam, prob, 5, 10, abort)
    _assert_same(got, want, what)
    assert counters["mapping.ba_graph_replays"] == n_eager > 0, what
    return counters


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_graph_phase_is_bit_identical_to_eager(dev, case, robust):
    prob = _problem(3, dev, **CASES[case])
    oh = local_ba._onehot_cam(prob)
    act = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    lam0 = torch.full((), 1e-4, device=dev)
    *want, n_eager = eager_phase(CAM, prob.cam_pose, prob.pt_pos, prob, oh, act, robust, 10,
                                 lam0)
    static = local_ba._graphs_for(CAM, prob, oh)
    counters, got = _counters(local_ba._run_phase, static, prob.cam_pose, prob.pt_pos, act,
                              robust, 10, lam0)
    for name, a, b in zip(("poses", "pts", "cur"), got, want):
        assert torch.equal(a, b), (case, robust, name)
    assert counters["mapping.ba_graph_replays"] == n_eager >= 2
    assert counters["mapping.ba_graph_captures"] == 1


@pytest.mark.parametrize("abort", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_graph_local_ba_is_bit_identical_to_eager(dev, case, abort):
    counters = _assert_graph_equals_eager(CAM, _problem(3, dev, **CASES[case]), abort,
                                          (case, abort))
    assert counters["mapping.ba_graph_captures"] == (1 if abort else 2)
    # the keys captured, and the second problem of the shape captures none
    counters = _assert_graph_equals_eager(CAM, _problem(4, dev, **CASES[case]), abort,
                                          (case, abort, "second"))
    assert "mapping.ba_graph_captures" not in counters


def _escalation_map(dev):
    """`test_torch_local_ba._escalation_map`'s keyframes and points, built
    with the port's map updates alone: point 0 is observed by 12 keyframes,
    so its window escalates to O_BA_ESC lanes."""
    rng = np.random.default_rng(42)  # the tests' `rng` fixture
    n_kf, n_feat, n_extra = 14, 96, 60
    pos = rng.normal(size=(20 + n_extra, 3)) + np.array([0, 0, 5.0])
    poses = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    poses[:, 0, 3] = -0.05 * np.arange(n_kf)
    obs = {k: [(k, 0)] for k in range(12)}
    for k in range(2):
        obs[k] += [(12 + i, 1 + i) for i in range(19)]
    for e in range(n_extra):
        q, r = divmod(e, 12)
        obs.setdefault(2 + r, []).append((12 + q, 20 + e))
        obs.setdefault(2 + (r + 1) % 12, []).append((17 + q, 20 + e))
        obs[0].append((32 + e, 20 + e))
    st = tms.empty_map(16, 256, n_feat, device=dev)

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for i in range(n_kf):
        xy = rng.uniform(100, 500, (n_feat, 2))
        ur = np.full(n_feat, -1.0)
        for f, p in obs.get(i, []):
            pc = pos[p] + poses[i, :3, 3]
            xy[f] = 320.0 * pc[:2] / pc[2] + [320.0, 240.0] + rng.normal(size=2) * 0.5
            ur[f] = xy[f, 0] - 12.8 / pc[2]
        st, _ = tms.add_keyframe(
            st, t32(poses[i]), float(i), i, t32(xy), t32(ur), t32(rng.uniform(0.5, 3, n_feat)),
            torch.zeros(n_feat, dtype=torch.int32, device=dev), torch.zeros(n_feat, device=dev),
            torch.ones(n_feat, dtype=torch.bool, device=dev),
            torch.as_tensor(rng.integers(0, 256, (n_feat, 32)).astype(np.uint8), device=dev))
    st, slots = tms.add_points(st, t32(pos + rng.normal(size=pos.shape) * 0.02),
                               torch.zeros((len(pos), 32), dtype=torch.uint8, device=dev), 0, 0,
                               torch.ones(len(pos), dtype=torch.bool, device=dev))
    for k, lst in obs.items():
        f, p = np.array(lst).T
        st = tms.add_observations(st, k, slots[torch.as_tensor(p, device=dev)],
                                  torch.as_tensor(f.astype(np.int32), device=dev),
                                  torch.ones(len(f), dtype=torch.bool, device=dev))
    covis = st.covis.clone()
    covis[13, :13] = covis[:13, 13] = 30
    return st._replace(covis=covis)


def test_escalated_window_is_bit_identical_to_eager(dev):
    st = _escalation_map(dev)
    win = local_mapping.build_ba_window(st, 13)
    assert int(local_mapping.count_truncated_ba_lanes(st, win, local_mapping.O_BA)) > 0
    prob = local_mapping.assemble_ba_obs(st, win, torch.ones(4, device=dev),
                                         local_mapping.O_BA_ESC)
    assert prob.obs_cam.shape[1] == local_mapping.O_BA_ESC == 16
    cam = projection.Camera.create(320.0, 320.0, 320.0, 240.0, bf=12.8)
    for abort in (False, True):
        _assert_graph_equals_eager(cam, prob, abort, ("escalated", abort))


W, H, FX = 320, 240, 200.0


@pytest.fixture(scope="module")
def mapper_windows(dev):
    """(camera, problem, abort) of every local BA the port's mapper runs on
    the card over `test_torch_local_mapping.orbit_frames()`, at that
    module's system with 64 keyframe slots."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    room = synthetic.BoxRoom(half_size=2.0, seed=5)
    cfg = tcfg.SystemConfig()
    cfg.camera = tcfg.CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                                   bf=FX * 0.08, th_depth=50.0, depth_map_factor=5000.0,
                                   fps=30)
    cfg.orb = tcfg.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 64, 8192
    slam = tsys.SLAMSystem(cfg, tsys.Sensor.RGBD, vocabulary=None, enable_loop_closing=False,
                           device=dev)
    kept, solve = [], local_ba.local_bundle_adjustment

    def keep(cam, prob, *a, **k):
        kept.append((cam, local_ba.BAProblem(*[x.clone() for x in prob]),
                     bool(k.get("abort", False))))
        return solve(cam, prob, *a, **k)

    local_ba.local_bundle_adjustment = keep
    try:
        for i, T in enumerate(synthetic.orbit_trajectory(14, radius=0.4, yaw_range=1.6)):
            g, d = room.render(K, T, W, H)
            slam.track_rgbd(np.round(np.clip(g, 0, 255)).astype(np.float32),
                            (np.round(d * 5000.0) / 5000.0).astype(np.float32),
                            1000.0 + i / 30.0)
        torch.cuda.synchronize()
    finally:
        local_ba.local_bundle_adjustment = solve
    assert len(kept) >= 2
    return kept


def test_mapper_windows_are_bit_identical_to_eager(dev, mapper_windows):
    for i, (cam, prob, abort) in enumerate(mapper_windows):
        assert (prob.cam_pose.shape[0],) + tuple(prob.obs_cam.shape) == (64, 4096, 8)
        for ab in sorted({abort, False}):
            _assert_graph_equals_eager(cam, prob, ab, ("window", i, ab))


def test_one_capture_per_key(dev, mapper_windows):
    cam, prob, _ = mapper_windows[-1]
    counters, _ = _counters(lambda: [local_ba.local_bundle_adjustment(c, p)
                                     for c, p, _ in mapper_windows])
    assert counters["mapping.ba_graph_captures"] == 2  # (64, 4096, 8): robust and plain
    small = _problem(3, dev, **CASES["stereo"])
    counters, _ = _counters(lambda: [local_ba.local_bundle_adjustment(CAM, small),
                                     local_ba.local_bundle_adjustment(cam, prob),
                                     local_ba.local_bundle_adjustment(CAM, small)])
    assert counters["mapping.ba_graph_captures"] == 2  # (6, 120, 4): its own key
    assert len(local_ba._GRAPHS) == 2


def test_result_outlives_the_next_call(dev, mapper_windows):
    (c1, p1, _), (c2, p2, _) = mapper_windows[-2:]
    first = local_ba.local_bundle_adjustment(c1, p1)
    kept = [x.clone() for x in first]
    second = local_ba.local_bundle_adjustment(c2, p2)
    torch.cuda.synchronize()
    assert not torch.equal(first.pt_pos, second.pt_pos)
    for name, a, b in zip(local_ba.BAResult._fields, first, kept):
        assert torch.equal(a, b), name


def test_steady_call_reads_the_host_once_per_iteration(dev, mapper_windows):
    cam, prob, _ = mapper_windows[-1]
    local_ba.local_bundle_adjustment(cam, prob)  # the captures
    counters, _ = _counters(local_ba.local_bundle_adjustment, cam, prob)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            local_ba.local_bundle_adjustment(cam, prob)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    sites = [(w.filename, w.lineno) for w in seen if metrics.SYNC_MESSAGE in str(w.message)]
    reads = [s for s in sites if "int(static.state[4])" in linecache.getline(*s)]
    assert len(reads) == counters["mapping.ba_graph_replays"] > 0
    assert sorted(set(sites) - set(reads)) == sorted(WRAPPER_READS), sites
