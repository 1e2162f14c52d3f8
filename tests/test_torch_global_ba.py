"""Parity: the port's dense-route global BA and global-BA job against the
JAX package, on the synthetic maps of `test_global_ba.py` (made from a seed
with numpy, carried across with `interop`). Tables equal; LM iterations:
poses within 1e-4, points within 1e-3, the initial cost within 1e-5 and the
first step's within 1e-3 relative, the small-gain counter's rule on each
side; `GBAJob.apply` on a map grown after the snapshot: poses within 1e-4,
points within 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_global_ba import BF, CX, CY, FX, FY, make_map_state, mean_pose_err

from orbslam_mapsave_tpu.optim import global_ba as jgba
from orbslam_mapsave_tpu.pipeline import gba as jgjob
from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.optim import global_ba as tgba
from orbslam_mapsave_tpu_torch.pipeline import gba as tgjob

torch.set_num_threads(2)
POSE_TOL, PT_TOL = 1e-4, 1e-3
ISIG = np.array([1.0, 1 / 1.44, 1 / 1.5 ** 4, 1 / 1.5 ** 6], np.float32)
TCAM = tproj.Camera.create(FX, FY, CX, CY, bf=BF, width=320, height=240)


def _case(seed=42, **kw):
    """(JAX cam, JAX state, port state, true poses); kf capacity 13 keeps
    the JAX job on its single-device path under the tests' 8-device mesh."""
    kw.setdefault("kf_cap", 13)
    cam, state, poses_true, _ = make_map_state(np.random.default_rng(seed), **kw)
    h = {k: np.array(v) for k, v in state._asdict().items()}
    # uneven octaves, so the per-octave information matters
    h["kf_kp_octave"] = (np.arange(h["kf_kp_octave"].size) % 4).reshape(
        h["kf_kp_octave"].shape).astype(h["kf_kp_octave"].dtype)
    state = jms.MapState(**{k: jnp.asarray(v) for k, v in h.items()})
    return cam, state, interop.map_state_from_numpy(h), poses_true


def test_build_tables():
    _, js, ts, _ = _case(n_kf=10, n_pt=300)
    tj = jgba.build_tables(js, jnp.asarray(ISIG))
    tt = tgba.build_tables(ts, torch.from_numpy(ISIG))
    for f, a, b in zip(tt._fields, tt, tj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert int(tt.po_valid.sum()) > 1000 and int(tt.cm_valid.sum()) == int(tt.po_valid.sum())


@pytest.mark.parametrize("robust", [False, True])
def test_gba_iterations(robust):
    """gba_init, then 10 gba_iterate steps compared step by step. Near the
    optimum the accept test compares costs that differ by float32 noise, so
    there an accept (and the small-gain counter) may differ for a step;
    the steps and the converged map agree within the tolerances."""
    cam, js, ts, poses_true = _case(n_kf=10, n_pt=300, noise=0.2 if robust else 0.0,
                                    pose_noise=0.01, pt_noise=0.02)
    tbj, cj = jgba.gba_init(cam, js, jnp.asarray(ISIG), robust=robust)
    tbt, ct = tgba.gba_init(TCAM, ts, torch.from_numpy(ISIG), robust=robust)
    np.testing.assert_allclose(float(ct[3]), float(cj[3]), rtol=1e-5)
    for i in range(10):
        cj = jgba.gba_iterate(cam, tbj, *cj, robust=robust)
        ct = tgba.gba_iterate(TCAM, tbt, *ct, robust=robust)
        np.testing.assert_allclose(ct[0].numpy(), np.asarray(cj[0]), atol=POSE_TOL)
        np.testing.assert_allclose(ct[1].numpy(), np.asarray(cj[1]), atol=PT_TOL)
        if i == 0:
            np.testing.assert_allclose(float(ct[3]), float(cj[3]), rtol=1e-3)
    n = 10
    assert mean_pose_err(ct[0].numpy()[:n], poses_true) < 0.6 * mean_pose_err(
        np.asarray(js.kf_pose)[:n], poses_true)


def test_small_gain_counter():
    """An accepted step that gains less than rtol * cost counts up, any
    other accepted step resets the count, a rejected one keeps it and
    multiplies lambda by 5; from 2 on the carry passes through untouched.
    Each side is driven with its own costs."""
    cam, js, ts, _ = _case(n_kf=8, n_pt=200)
    sides = [(jgba, cam, js, jnp.asarray(ISIG), lambda x: jnp.asarray(x, jnp.float32),
              lambda x: jnp.asarray(x, jnp.int32)),
             (tgba, TCAM, ts, torch.from_numpy(ISIG), lambda x: torch.tensor(x, dtype=torch.float32),
              lambda x: torch.tensor(x, dtype=torch.int32))]
    for mod, c, st, isig, f32, i32 in sides:
        tb, (poses, pts, lam, cur, small) = mod.gba_init(c, st, isig)
        new = float(mod.gba_iterate(c, tb, poses, pts, lam, f32(1e30), i32(0))[3])
        for cur_, small_in, small_out, accepted in (
                (new * (1 + 1e-6), 0, 1, True), (new * (1 + 1e-6), 1, 2, True),
                (new * 2.0, 1, 0, True), (new * (1 - 1e-3), 1, 1, False)):
            out = mod.gba_iterate(c, tb, poses, pts, lam, f32(cur_), i32(small_in))
            assert int(out[4]) == small_out, (mod.__name__, cur_, small_in)
            assert np.isclose(float(out[2]), float(lam) * (0.5 if accepted else 5.0))
        out = mod.gba_iterate(c, tb, poses, pts, lam, f32(new * 2.0), i32(2))
        assert float(out[3]) == float(np.float32(new * 2.0)) and int(out[4]) == 2


def _grow(state):
    """The map after the snapshot: two new keyframes down the spanning tree
    (slot n_kf's parent is slot 4, the next one's parent is slot n_kf), a
    culled old keyframe, and new points referenced to old and new
    keyframes."""
    h = interop.map_state_to_numpy(state)
    n_kf, n_pt = int(h["n_kf"]), int(h["n_pt"])
    rng = np.random.default_rng(9)
    for s, par in ((n_kf, 4), (n_kf + 1, n_kf)):
        T = h["kf_pose"][par].copy()
        T[:3, 3] += rng.normal(size=3) * 0.1
        h["kf_pose"][s], h["kf_valid"][s], h["kf_parent"][s] = T, True, par
    h["kf_valid"][6] = False
    new = np.arange(n_pt, n_pt + 12)
    h["pt_pos"][new] = rng.normal(size=(12, 3)) + [0, 0, 7]
    h["pt_valid"][new] = True
    h["pt_ref_kf"][new] = np.array([2, n_kf, n_kf + 1, -1] * 3)
    h["n_kf"], h["n_pt"] = np.int32(n_kf + 2), np.int32(n_pt + 12)
    return h


def test_gba_job_apply_on_grown_map():
    cam, js, ts, _ = _case(n_kf=9, n_pt=250, pt_cap=270)
    jjob = jgjob.GBAJob(js, cam, jnp.asarray(ISIG), n_iters=3)
    tjob = tgjob.GBAJob(ts, TCAM, ISIG, n_iters=3)
    assert jjob._incremental and jjob._solver == tjob._solver == "dense"
    jjob.pump(max_iters=2)
    tjob.pump(max_iters=2)
    assert not tjob.done and tjob.iters_left == 1
    h = _grow(ts)
    oj = jjob.apply(jms.MapState(**{k: jnp.asarray(v) for k, v in h.items()}))
    ot = tjob.apply(interop.map_state_from_numpy(h))
    assert tjob.done and tjob.applied
    np.testing.assert_allclose(ot.kf_pose.numpy(), np.asarray(oj.kf_pose), atol=POSE_TOL)
    np.testing.assert_allclose(ot.pt_pos.numpy(), np.asarray(oj.pt_pos), atol=PT_TOL)
    # the new keyframes moved with their parents, the culled one did not
    assert not np.allclose(ot.kf_pose.numpy()[10], h["kf_pose"][10], atol=1e-6)
    np.testing.assert_array_equal(ot.kf_pose.numpy()[6], h["kf_pose"][6])
    # an aborted job leaves the map as it is
    tjob2 = tgjob.GBAJob(ts, TCAM, ISIG, n_iters=3)
    tjob2.pump(1)
    tjob2.abort()
    assert tjob2.done
    out = tjob2.apply(ts)
    np.testing.assert_array_equal(out.kf_pose.numpy(), ts.kf_pose.numpy())


def test_mono_bootstrap_full_ba():
    """The one-shot full BA of the monocular bootstrap (dense route, 20
    robust iterations) gives the JAX package's result."""
    cam, js, ts, _ = _case(n_kf=10, n_pt=300, noise=0.2, pose_noise=0.01, pt_noise=0.02)
    pj, xj, cj = jgba.full_bundle_adjustment(cam, js, jnp.asarray(ISIG), n_iters=20,
                                             robust=True, solver="dense")
    pt, xt, ct = tgba.full_bundle_adjustment(TCAM, ts, torch.from_numpy(ISIG), n_iters=20,
                                             robust=True, solver="dense")
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=POSE_TOL)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=PT_TOL)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3)


@pytest.mark.parametrize("solver", ["pcg", "pcg_dual"])
def test_pcg_routes_match_jax_and_dense(solver):
    """`full_bundle_adjustment` by each PCG route (12 iterations, 100 CG
    iterations): within POSE_TOL / PT_TOL of JAX's same route on the
    10-keyframe map the other tests here use, and, as
    test_pcg_dual_matches_dense holds JAX, converged like the port's dense
    route on that test's map (40 keyframes, 800 points): mean pose error
    within 1.5x, cost within 5%. On the 40-keyframe map (translations up to
    10 m) even the dense routes of the two packages end 3e-4 apart in
    float32, so the JAX comparison runs on the smaller map."""
    cam, js, ts, _ = _case(n_kf=10, n_pt=300, noise=0.2, pose_noise=0.01, pt_noise=0.02)
    pj, xj, cj = jgba.full_bundle_adjustment(cam, js, jnp.asarray(ISIG), n_iters=12,
                                             solver=solver, cg_iters=100)
    pt, xt, ct = tgba.full_bundle_adjustment(TCAM, ts, torch.from_numpy(ISIG), n_iters=12,
                                             solver=solver, cg_iters=100)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=POSE_TOL)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=PT_TOL)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3)

    _, _, ts, poses_true = _case(n_kf=40, n_pt=800, obs_per_pt=6, noise=0.2,
                                 pose_noise=0.04, kf_cap=40)
    isig = torch.ones(4)
    pt, _, ct = tgba.full_bundle_adjustment(TCAM, ts, isig, n_iters=12, solver=solver)
    pd, _, cd = tgba.full_bundle_adjustment(TCAM, ts, isig, n_iters=12, solver="dense")
    err0 = mean_pose_err(ts.kf_pose.numpy()[:40], poses_true)
    err_d = mean_pose_err(pd.numpy()[:40], poses_true)
    err_p = mean_pose_err(pt.numpy()[:40], poses_true)
    assert err_d < err0 * 0.1, (err0, err_d)
    assert err_p < max(1.5 * err_d, 1e-4), (err_d, err_p)
    assert float(ct) < 1.05 * float(cd) + 1e-3, (cd, ct)


@pytest.mark.parametrize("solver", ["pcg", "pcg_dual"])
def test_gba_iterations_pcg(solver):
    """gba_init + 10 gba_iterate steps of each PCG route (the loop
    closer's job), robust, against JAX's same route: the initial cost
    within 1e-5, the first step's within 1e-3 relative, the converged
    poses within POSE_TOL and points within PT_TOL. (A CG step that stops
    at 1e-3 of its residual is inexact: the early iterates of the two
    packages differ by up to 2e-4, the converged ones agree.) "auto" picks
    dense up to K = 384, as in JAX."""
    cam, js, ts, _ = _case(n_kf=10, n_pt=300, noise=0.2, pose_noise=0.01, pt_noise=0.02)
    assert tgba._route("auto", 13) == "dense" and tgba._route("auto", 385) == "pcg"
    tbj, cj = jgba.gba_init(cam, js, jnp.asarray(ISIG), robust=True, solver=solver)
    tbt, ct = tgba.gba_init(TCAM, ts, torch.from_numpy(ISIG), robust=True, solver=solver)
    np.testing.assert_allclose(float(ct[3]), float(cj[3]), rtol=1e-5)
    for i in range(10):
        cj = jgba.gba_iterate(cam, tbj, *cj, robust=True, solver=solver)
        ct = tgba.gba_iterate(TCAM, tbt, *ct, robust=True, solver=solver)
        if i == 0:
            np.testing.assert_allclose(float(ct[3]), float(cj[3]), rtol=1e-3)
    np.testing.assert_allclose(ct[0].numpy(), np.asarray(cj[0]), atol=POSE_TOL)
    np.testing.assert_allclose(ct[1].numpy(), np.asarray(cj[1]), atol=PT_TOL)


def test_gba_job_at_default_capacities():
    """A global-BA job on a map at SystemConfig's default capacities (512
    keyframes, 65,536 points, 2,048 keypoints) with 10 live keyframes: the
    (P,O,K) one-hot would take 2 GiB, so the job runs pcg_dual, and its
    result equals the JAX job's single-device route (gba_init + gba_iterate
    with solver="pcg_dual"; under the tests' 8-device mesh the JAX GBAJob
    itself would take its sharded branch): poses within POSE_TOL, points
    within PT_TOL."""
    from orbslam_mapsave_tpu_torch import config as tcfg

    cfg = tcfg.SystemConfig()
    caps = dict(kf_cap=cfg.max_keyframes, pt_cap=cfg.max_points, n_feat=cfg.max_keypoints)
    assert (caps["kf_cap"], caps["pt_cap"], caps["n_feat"]) == (512, 65536, 2048)
    cam, js, ts, poses_true = _case(n_kf=10, n_pt=300, pose_noise=0.01, pt_noise=0.02, **caps)
    n_iters = 3
    tjob = tgjob.GBAJob(ts, TCAM, ISIG, n_iters=n_iters)
    assert tjob._solver == "pcg_dual"
    tbj, cj = jgba.gba_init(cam, js, jnp.asarray(ISIG), solver="pcg_dual")
    for _ in range(n_iters):
        cj = jgba.gba_iterate(cam, tbj, *cj, solver="pcg_dual")
    out = tjob.apply(ts)
    assert tjob.applied
    pj = np.asarray(jgba.se3.orthonormalize(cj[0]))
    np.testing.assert_allclose(out.kf_pose.numpy(), pj, atol=POSE_TOL)
    np.testing.assert_allclose(out.pt_pos.numpy(), np.asarray(cj[1]), atol=PT_TOL)
    assert mean_pose_err(out.kf_pose.numpy()[:10], poses_true) < mean_pose_err(
        ts.kf_pose.numpy()[:10], poses_true)
