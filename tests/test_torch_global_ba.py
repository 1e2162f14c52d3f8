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


def test_scale_and_mono_routes_wait():
    """The scale slice's solvers still raise; the one-shot full BA of the
    monocular bootstrap (dense route, 20 robust iterations) is ported and
    gives the JAX package's result."""
    cam, js, ts, _ = _case(n_kf=10, n_pt=300, noise=0.2, pose_noise=0.01, pt_noise=0.02)
    with pytest.raises(NotImplementedError):
        tgba.gba_init(TCAM, ts, torch.from_numpy(ISIG), solver="pcg")
    with pytest.raises(NotImplementedError):
        tgba.full_bundle_adjustment(TCAM, ts, torch.from_numpy(ISIG), solver="pcg")
    pj, xj, cj = jgba.full_bundle_adjustment(cam, js, jnp.asarray(ISIG), n_iters=20,
                                             robust=True, solver="dense")
    pt, xt, ct = tgba.full_bundle_adjustment(TCAM, ts, torch.from_numpy(ISIG), n_iters=20,
                                             robust=True, solver="dense")
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=POSE_TOL)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=PT_TOL)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3)
