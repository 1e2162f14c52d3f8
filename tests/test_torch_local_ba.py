"""Parity: the port's Schur local BA against the JAX package, on the
synthetic multi-view problems of `test_local_ba.py` (made from a seed with
numpy) and on the O_BA lane-escalation map. One LM step: camera steps
within 2e-3 of max|dx|, point steps within 1e-3; a full local BA within
1e-4 (poses) and 1e-3 (points), with the same inliers except a flip within
1e-4 (relative) of its chi2 gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.optim import lm as jlm
from orbslam_mapsave_tpu.optim import local_ba as jba
from orbslam_mapsave_tpu.pipeline import local_mapping as jlmap
from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.optim import lm as tlm
from orbslam_mapsave_tpu_torch.optim import local_ba as tba
from orbslam_mapsave_tpu_torch.pipeline import local_mapping as tlmap
from orbslam_mapsave_tpu_torch.slammap import mapstate as tms
from test_torch_local_ba_graph import eager_local_ba, eager_phase

torch.set_num_threads(2)
CAM_ARGS = (525.0, 525.0, 319.5, 239.5)


def _problem(seed, n_cams=6, n_pts=120, obs_per_pt=4, noise=0.3, pose_noise=0.02,
             pt_noise=0.05, stereo=False, outliers=0.0):
    """`test_local_ba.make_ba_problem` as numpy arrays, plus a share of
    corrupted observations (80 px on u)."""
    rng = np.random.default_rng(seed)
    pts_true = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                         rng.uniform(4, 9, n_pts)], axis=-1)
    poses_true = np.zeros((n_cams, 4, 4))
    for c in range(n_cams):
        xi = np.concatenate([[0.3 * c, 0.02 * c, 0.01 * c], rng.normal(size=3) * 0.01])
        poses_true[c] = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
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
    n_bad = int(outliers * n_pts)
    obs_uv[:n_bad, 0, 0] += 80.0
    poses0 = poses_true.copy()
    for c in range(2, n_cams):
        xi = rng.normal(size=6) * pose_noise
        poses0[c] = np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ poses_true[c]
    pts0 = pts_true + rng.normal(size=pts_true.shape) * pt_noise
    return dict(cam_pose=poses0.astype(np.float32), cam_fixed=np.arange(n_cams) <= 1,
                cam_valid=np.ones(n_cams, bool), pt_pos=pts0.astype(np.float32),
                pt_valid=np.ones(n_pts, bool), obs_cam=obs_cam, obs_uv=obs_uv,
                obs_ur=obs_ur, obs_inv_sigma2=np.ones((n_pts, O), np.float32),
                obs_valid=obs_cam >= 0)


def _both(d):
    cam_j = jproj.Camera.create(*CAM_ARGS, bf=40.0)
    cam_t = tproj.Camera.create(*CAM_ARGS, bf=40.0)
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    pt = tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    return cam_j, pj, cam_t, pt


CASES = {
    "clean": dict(noise=0.0),
    "noisy_outliers": dict(noise=0.4, outliers=0.1),
    "stereo": dict(stereo=True, noise=0.2),
    "stereo_outliers": dict(stereo=True, noise=0.3, outliers=0.1),
}


def test_inv3x3():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    A[0] = 0.0  # singular: det clamped to 1e-20 on both sides
    np.testing.assert_allclose(tlm.inv3x3(torch.from_numpy(A)).numpy()[1:],
                               np.asarray(jlm.inv3x3(jnp.asarray(A)))[1:], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tlm.inv3x3(torch.from_numpy(A)).numpy()[0],
                                  np.asarray(jlm.inv3x3(jnp.asarray(A)))[0])


# the JAX references, compiled once instead of run op by op
_jit_step = jax.jit(jba._build_and_solve, static_argnums=0)
_jit_lba = jax.jit(jba.local_bundle_adjustment, static_argnums=(0, 2, 3))


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_build_and_solve_step(case, robust):
    """One damped LM step from the perturbed start. Both sides solve the
    reduced camera system in float32, and each lies about as far from the
    port's float64 solve as from the other (measured: cameras up to 1.3e-3
    of max|dx|, points up to 3e-4 absolute with steps up to 5.5). Held:
    cameras within 2e-3 of max|dx|, points within 1e-3, both sides against
    float64 and against each other; the acceptance cost within 1e-5
    relative."""
    d = _problem(1, **CASES[case])
    cam_j, pj, cam_t, pt = _both(d)
    p64 = tba.BAProblem(*[x.double() if x.is_floating_point() else x for x in pt])
    oh_j, oh_t = jba._onehot_cam(pj), tba._onehot_cam(pt)
    np.testing.assert_array_equal(np.asarray(oh_j), oh_t.numpy())
    act_j = pj.obs_valid & (pj.obs_cam >= 0) & pj.pt_valid[:, None]
    act_t = pt.obs_valid & (pt.obs_cam >= 0) & pt.pt_valid[:, None]
    for lam in (1e-4, 1e-2):
        dcj, dpj = _jit_step(cam_j, pj.cam_pose, pj.pt_pos, pj, oh_j, act_j,
                             jnp.asarray(robust), jnp.float32(lam))
        dct, dpt = tba._build_and_solve(cam_t, pt.cam_pose, pt.pt_pos, pt, oh_t, act_t,
                                        robust, torch.tensor(lam))
        dc64, dp64 = tba._build_and_solve(cam_t, p64.cam_pose, p64.pt_pos, p64,
                                          tba._onehot_cam(p64), act_t, robust,
                                          torch.tensor(lam, dtype=torch.float64))
        for a, b, ref, tol in ((dcj, dct, dc64, 2e-3 * float(dc64.abs().max())),
                               (dpj, dpt, dp64, 1e-3)):
            a, b, ref = np.asarray(a), b.numpy(), ref.numpy()
            assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), np.abs(a).max())
            assert np.abs(b - ref).max() <= tol and np.abs(a - ref).max() <= tol
    cj = float(jax.jit(jba._cost_at, static_argnums=0)(cam_j, pj.cam_pose, pj.pt_pos, pj,
                                                        oh_j, act_j, jnp.asarray(robust)))
    ct = float(tba._cost_at(cam_t, pt.cam_pose, pt.pt_pos, pt, oh_t, act_t, robust))
    assert abs(cj - ct) <= 1e-5 * abs(cj)


def test_indefinite_system_gives_zero_camera_step():
    """A negative damping makes the reduced system indefinite: the Cholesky
    fails (info != 0, no exception) and the camera step is zero, as the
    JAX version's NaN -> 0."""
    cam_j, pj, cam_t, pt = _both(_problem(2))
    oh_j, oh_t = jba._onehot_cam(pj), tba._onehot_cam(pt)
    act_j = pj.obs_valid & (pj.obs_cam >= 0)
    act_t = pt.obs_valid & (pt.obs_cam >= 0)
    dcj, dpj = _jit_step(cam_j, pj.cam_pose, pj.pt_pos, pj, oh_j, act_j,
                         jnp.asarray(True), jnp.float32(-3.0))
    dct, dpt = tba._build_and_solve(cam_t, pt.cam_pose, pt.pt_pos, pt, oh_t, act_t,
                                    True, torch.tensor(-3.0))
    assert not np.asarray(dcj).any() and not dct.any()
    assert torch.isfinite(dpt).all()
    np.testing.assert_allclose(dpt.numpy(), np.asarray(dpj), rtol=1e-4, atol=1e-6)


def _gate_flips(cam_t, pt, res_t, inl_j):
    """Inlier flips between the two runs, each checked to lie within 1e-4
    (relative) of its gate at the port's result."""
    inl_t = res_t.obs_inlier.numpy()
    flips = np.argwhere(inl_t != inl_j)
    if len(flips):
        oh = tba._onehot_cam(pt)
        _, _, _, chi2, _, _, is_st = tba._edge_terms_po(cam_t, res_t.cam_pose, res_t.pt_pos,
                                                        pt, oh)
        for l, o in flips:
            gate = tlm.CHI2_STEREO if bool(is_st[l, o]) else tlm.CHI2_MONO
            assert abs(float(chi2[l, o]) / gate - 1.0) <= 1e-4, (l, o)
    return len(flips)


@pytest.mark.parametrize("abort", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_local_bundle_adjustment(case, abort):
    cam_j, pj, cam_t, pt = _both(_problem(3, **CASES[case]))
    rj = _jit_lba(cam_j, pj, 5, 10, jnp.asarray(abort))
    rt = tba.local_bundle_adjustment(cam_t, pt, abort=abort)
    np.testing.assert_allclose(rt.cam_pose.numpy(), np.asarray(rj.cam_pose), atol=1e-4)
    np.testing.assert_allclose(rt.pt_pos.numpy(), np.asarray(rj.pt_pos), atol=1e-3)
    assert _gate_flips(cam_t, pt, rt, np.asarray(rj.obs_inlier)) == 0
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-3, atol=1e-4)
    # fixed cameras do not move (beyond the final SO(3) projection)
    np.testing.assert_allclose(rt.cam_pose.numpy()[:2], pt.cam_pose.numpy()[:2], atol=1e-7)


def _counting(monkeypatch):
    """Counts the calls of `_lm_step`: the LM iterations run."""
    calls = [0]
    step = tba._lm_step

    def counted(*a):
        calls[0] += 1
        return step(*a)

    monkeypatch.setattr(tba, "_lm_step", counted)
    return calls


@pytest.mark.parametrize("robust", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_lm_step_on_static_buffers_equals_the_functional_loop(case, robust, monkeypatch):
    """`_run_phase` on `_LMGraphs`' static buffers, as a CUDA graph replays
    it (here the eager body), gives the plain `_lm_step` loop's phase
    (`eager_phase`) bit for bit in as many iterations; what it returns is
    copied out of the buffers, so it outlives the next problem loaded into
    them."""
    _, _, cam, pt = _both(_problem(3, **CASES[case]))
    oh = tba._onehot_cam(pt)
    act = pt.obs_valid & (pt.obs_cam >= 0) & pt.pt_valid[:, None]
    lam0 = torch.full((), 1e-4)
    *want, n_eager = eager_phase(cam, pt.cam_pose, pt.pt_pos, pt, oh, act, robust, 10, lam0)
    calls = _counting(monkeypatch)
    graphs = tba._LMGraphs(cam, pt).load(pt, oh)
    got = tba._run_phase(graphs, pt.cam_pose, pt.pt_pos, act, robust, 10, lam0)
    assert calls[0] == n_eager >= 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    kept = [x.clone() for x in got]
    _, _, _, p2 = _both(_problem(5, **CASES[case]))
    tba._run_phase(graphs.load(p2, tba._onehot_cam(p2)), p2.cam_pose, p2.pt_pos, act, robust,
                   10, lam0)
    assert not torch.equal(graphs.state[1], kept[1])
    for a, b in zip(got, kept):
        assert torch.equal(a, b)


@pytest.mark.parametrize("abort", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_local_ba_on_static_buffers_equals_eager(case, abort):
    """The whole schedule with both phases on one set of static buffers
    (phase A's and B's steps share the problem) equals the plain loop's
    (`eager_local_ba`), every field bit for bit, and so does a second call
    on the same buffers."""
    _, _, cam, pt = _both(_problem(3, **CASES[case]))
    want, _ = eager_local_ba(cam, pt, abort)
    for _ in range(2):
        got = tba.local_bundle_adjustment(cam, pt, abort=abort)
        for name, a, b in zip(tba.BAResult._fields, got, want):
            assert torch.equal(a, b), name


def test_ba_reduces_error_and_abort_does_less():
    """Behaviour as `test_local_ba.py` checks it: the clean problem
    converges, and an aborted BA (phase A only) ends at a cost no lower
    than the full schedule."""
    d = _problem(4, noise=0.0)
    _, _, cam_t, pt = _both(d)
    full = tba.local_bundle_adjustment(cam_t, pt)
    cut = tba.local_bundle_adjustment(cam_t, pt, abort=True)
    assert float(cut.chi2) >= float(full.chi2) - 1e-6
    assert float(full.chi2) < 1e-2


def _escalation_map(rng):
    """`test_local_ba.test_ba_lane_escalation`'s map: point 0 is observed
    by 12 keyframes (lanes 0-11), so an 8-lane window truncates it; points
    1-19 by keyframes 0 and 1. So that the BA is well posed, the keyframes
    step 5 cm apart, every observation is the stereo projection of its
    point plus 0.5 px of noise, and 60 more points, each seen by keyframe
    0 and two of keyframes 2-13, give those ten observations each."""
    n_kf, n_feat = 14, 96
    n_extra = 60
    pos = rng.normal(size=(20 + n_extra, 3)) + np.array([0, 0, 5.0])
    poses = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    poses[:, 0, 3] = -0.05 * np.arange(n_kf)
    obs = {k: [(k, 0)] for k in range(12)}  # KF -> [(feature, point)]
    for k in range(2):
        obs[k] += [(12 + i, 1 + i) for i in range(19)]
    for e in range(n_extra):
        q, r = divmod(e, 12)
        obs.setdefault(2 + r, []).append((12 + q, 20 + e))
        obs.setdefault(2 + (r + 1) % 12, []).append((17 + q, 20 + e))
        obs[0].append((32 + e, 20 + e))
    # built with the port's map updates (held to JAX in test_torch_mapstate)
    st = tms.empty_map(16, 256, n_feat)
    for i in range(n_kf):
        xy = rng.uniform(100, 500, (n_feat, 2))
        ur = np.full(n_feat, -1.0)
        for f, p in obs.get(i, []):
            pc = pos[p] + poses[i, :3, 3]
            xy[f] = 320.0 * pc[:2] / pc[2] + [320.0, 240.0] + rng.normal(size=2) * 0.5
            ur[f] = xy[f, 0] - 12.8 / pc[2]
        t32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
        st, _ = tms.add_keyframe(
            st, torch.from_numpy(poses[i]), float(i), i, t32(xy), t32(ur),
            t32(rng.uniform(0.5, 3, n_feat)), torch.zeros(n_feat, dtype=torch.int32),
            torch.zeros(n_feat), torch.ones(n_feat, dtype=torch.bool),
            torch.from_numpy(rng.integers(0, 256, (n_feat, 32)).astype(np.uint8)))
    st, slots = tms.add_points(st, t32(pos + rng.normal(size=pos.shape) * 0.02),
                               torch.zeros((len(pos), 32), dtype=torch.uint8), 0, 0,
                               torch.ones(len(pos), dtype=torch.bool))
    for k, lst in obs.items():
        f, p = np.array(lst).T
        st = tms.add_observations(st, k, slots[torch.from_numpy(p)],
                                  torch.from_numpy(f.astype(np.int32)),
                                  torch.ones(len(f), dtype=torch.bool))
    covis = st.covis.clone()
    covis[13, :13] = covis[:13, 13] = 30
    d = interop.map_state_to_numpy(st._replace(covis=covis))
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()}), slots.numpy()


def test_ba_lane_escalation(rng):
    """The 12-observer point escalates the window to O_BA_ESC lanes: the
    same lane counts, the same escalated problem, and the mapper's BA on
    both sides reports escalation with nothing dropped and the same poses."""
    jst, slots = _escalation_map(rng)
    tst = interop.map_state_from_numpy(jst)
    wj = jax.jit(jlmap.build_ba_window)(jst, jnp.asarray(13, jnp.int32))
    wt = tlmap.build_ba_window(tst, 13)
    for k in wj:
        np.testing.assert_array_equal(np.asarray(wj[k]), wt[k].numpy(), err_msg=k)
    for lanes, want in ((tlmap.O_BA, 4), (tlmap.O_BA_ESC, 0)):
        assert int(tlmap.count_truncated_ba_lanes(tst, wt, lanes)) == want
        assert int(jlmap.count_truncated_ba_lanes(jst, wj, lanes)) == want
    inv2 = np.ones(4, np.float32)
    pj = jax.jit(jlmap.assemble_ba_obs, static_argnums=3)(jst, wj, inv2, jlmap.O_BA_ESC)
    pt = tlmap.assemble_ba_obs(tst, wt, torch.from_numpy(inv2), tlmap.O_BA_ESC)
    for k, v in pj._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), getattr(pt, k).numpy(), err_msg=k)
    l = int(np.nonzero(wt["lidx"].numpy() == int(slots[0]))[0][0])
    assert int(pt.obs_valid[l].sum()) == 12

    # the JAX mapper's escalated branch (`LocalMapper._ba`): BA over the
    # 16-lane problem, then the write-back
    cam_j = jproj.Camera.create(320.0, 320.0, 320.0, 240.0, bf=12.8)
    cam_t = tproj.Camera.create(320.0, 320.0, 320.0, 240.0, bf=12.8)
    res = _jit_lba(cam_j, pj, 5, 10, jnp.asarray(False))
    sj = jax.jit(jlmap.apply_ba_result)(jst, res, wj["cam_slots"], wj["lidx"], pj)
    mt = tlmap.LocalMapper(cam_t, inv2)
    st2, dt, et = mt._ba(tst, 13, False)
    assert et and dt == 0
    np.testing.assert_allclose(st2.kf_pose.numpy(), np.asarray(sj.kf_pose), atol=1e-4)
    np.testing.assert_allclose(st2.pt_pos.numpy(), np.asarray(sj.pt_pos), atol=1e-3)
    np.testing.assert_array_equal(st2.kf_kp_point.numpy(), np.asarray(sj.kf_kp_point))
    np.testing.assert_array_equal(st2.pt_obs_kf.numpy(), np.asarray(sj.pt_obs_kf))
