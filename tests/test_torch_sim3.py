"""Parity: the port's Sim3 group functions, Horn / RANSAC Sim3, OptimizeSim3
and the two Sim3-guided searches against the JAX package on the same numpy
inputs (made from a seed). Tolerances: 1e-4 for Sim3 matrices, tangents and
points, 1e-3 px for reprojections; integer outputs (inlier masks, match
tables, counts) equal. RANSAC is fed the JAX run's hypothesis indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.ops import hamming as jham
from orbslam_mapsave_tpu.ops import matching as jmat
from orbslam_mapsave_tpu.ops import sim3solver as jsim
from orbslam_mapsave_tpu.optim import sim3_opt as jopt
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.geometry import se3 as tse3
from orbslam_mapsave_tpu_torch.ops import hamming as tham
from orbslam_mapsave_tpu_torch.ops import matching as tmat
from orbslam_mapsave_tpu_torch.ops import sim3solver as tsim
from orbslam_mapsave_tpu_torch.optim import sim3_opt as topt

torch.set_num_threads(2)
TOL = 1e-4
FX, CX, CY = 520.0, 320.0, 240.0


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _random_sim3(rng, n, scale=True):
    xi = np.concatenate([rng.normal(size=(n, 3)) * 0.5, rng.normal(size=(n, 3)) * 0.6,
                         rng.normal(size=(n, 1)) * (0.2 if scale else 0.0)], -1)
    return xi.astype(np.float32)


def test_sim3_group_functions():
    rng = np.random.default_rng(0)
    xi = _random_sim3(rng, 64)
    xi[:4, 3:6] = 0.0  # theta -> 0 limit
    xi[4:8, 6] = 0.0  # sigma -> 0 limit
    xi[8:10] = 0.0
    Sj = jax.jit(jse3.sim3_exp)(jnp.asarray(xi))
    St = tse3.sim3_exp(_t(xi))
    np.testing.assert_allclose(_np(St), np.asarray(Sj), atol=TOL)
    np.testing.assert_allclose(_np(tse3.sim3_log(St)), np.asarray(jax.jit(jse3.sim3_log)(Sj)),
                               atol=TOL)
    np.testing.assert_allclose(_np(tse3.sim3_log(St)), xi, atol=TOL)  # round trip
    np.testing.assert_allclose(_np(tse3.sim3_inv(St)), np.asarray(jse3.sim3_inv(Sj)), atol=TOL)
    for a, b in zip(tse3.sim3_split(St), jse3.sim3_split(Sj)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=TOL)
    s, R, t = (x.numpy() for x in tse3.sim3_split(St))
    np.testing.assert_allclose(_np(tse3.sim3_make(_t(s), _t(R), _t(t))),
                               np.asarray(jse3.sim3_make(jnp.asarray(s), jnp.asarray(R),
                                                         jnp.asarray(t))), atol=TOL)
    drift = (np.asarray(Sj) + rng.normal(size=Sj.shape).astype(np.float32) * 1e-3)
    drift[:, 3] = [0, 0, 0, 1]
    np.testing.assert_allclose(_np(tse3.sim3_orthonormalize(_t(drift))),
                               np.asarray(jse3.sim3_orthonormalize(jnp.asarray(drift))),
                               atol=TOL)
    pts = rng.normal(size=(64, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tse3.sim3_transform_points(St, _t(pts))),
                               np.asarray(jse3.sim3_transform_points(Sj, jnp.asarray(pts))),
                               atol=TOL)


def _matched_clouds(rng, M=400, fix_scale=True, outliers=0.3):
    """Matched camera-frame point sets of two keyframes related by a Sim3,
    their pixels, and a share of wrong matches."""
    pc2 = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                    rng.uniform(2, 6, M)], -1).astype(np.float32)
    xi = np.array([0.1, -0.05, 0.2, 0.05, -0.1, 0.08, 0.0 if fix_scale else 0.1], np.float32)
    S12 = np.asarray(jse3.sim3_exp(jnp.asarray(xi)))
    pc1 = (pc2 @ S12[:3, :3].T + S12[:3, 3]).astype(np.float32)
    pc1 += rng.normal(size=pc1.shape).astype(np.float32) * 0.002
    bad = rng.random(M) < outliers
    pc1[bad] = pc1[rng.permutation(M)][bad]
    uv1 = FX * pc1[:, :2] / pc1[:, 2:] + [CX, CY]
    uv2 = FX * pc2[:, :2] / pc2[:, 2:] + [CX, CY]
    valid = rng.random(M) > 0.1
    return pc1, pc2, uv1.astype(np.float32), uv2.astype(np.float32), valid, S12


def test_horn_sim3():
    rng = np.random.default_rng(1)
    p1 = rng.normal(size=(16, 6, 3)).astype(np.float32)
    p2 = rng.normal(size=(16, 6, 3)).astype(np.float32)
    w = (rng.random((16, 6)) > 0.2).astype(np.float32)
    for fix in (True, False):
        a = tsim.horn_sim3(_t(p1), _t(p2), _t(w), fix_scale=fix)
        b = jsim.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w), fix_scale=fix)
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=TOL)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_ransac_sim3_with_jax_hypotheses(fix_scale):
    rng = np.random.default_rng(2)
    pc1, pc2, uv1, uv2, valid, _ = _matched_clouds(rng, fix_scale=fix_scale)
    M = pc1.shape[0]
    me = np.full(M, 9.210 * 1.44, np.float32)
    key = jax.random.PRNGKey(17)
    # the hypotheses ransac_sim3 draws from this key
    p = jnp.asarray(valid, jnp.float32) / max(valid.sum(), 1)
    idx = jax.vmap(lambda k: jax.random.choice(k, M, (3,), replace=False, p=p))(
        jax.random.split(key, 300))
    Sj, inl_j, n_j, ok_j = jsim.ransac_sim3(
        key, jnp.asarray(pc1), jnp.asarray(pc2), jnp.asarray(uv1), jnp.asarray(uv2), 300,
        fix_scale, max_err1=jnp.asarray(me), max_err2=jnp.asarray(me),
        valid=jnp.asarray(valid), fx=FX, fy=FX, cx=CX, cy=CY, min_inliers=20)
    St, inl_t, n_t, ok_t = tsim.ransac_sim3(
        _t(pc1), _t(pc2), _t(uv1), _t(uv2), 300, fix_scale, max_err1=_t(me),
        max_err2=_t(me), valid=_t(valid), fx=FX, fy=FX, cx=CX, cy=CY, min_inliers=20,
        hyp_idx=_t(idx))
    np.testing.assert_allclose(_np(St), np.asarray(Sj), atol=TOL)
    np.testing.assert_array_equal(_np(inl_t), np.asarray(inl_j))
    assert int(n_t) == int(n_j) and bool(ok_t) == bool(ok_j) and bool(ok_t)
    # the port's own draws: distinct valid matches, the same answer
    gen = torch.Generator().manual_seed(5)
    hyp = tsim.draw_hypotheses(_t(valid), 300, gen)
    assert all(len(set(r)) == 3 and valid[r].all() for r in hyp.tolist())
    S2, inl2, _, ok2 = tsim.ransac_sim3(
        _t(pc1), _t(pc2), _t(uv1), _t(uv2), 300, fix_scale, max_err1=_t(me),
        max_err2=_t(me), valid=_t(valid), fx=FX, fy=FX, cx=CX, cy=CY, generator=gen)
    assert bool(ok2) and np.abs(_np(S2) - np.asarray(Sj)).max() < 1e-2


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3(fix_scale):
    rng = np.random.default_rng(3)
    pc1, pc2, uv1, uv2, valid, S12 = _matched_clouds(rng, M=300, fix_scale=fix_scale,
                                                     outliers=0.1)
    uv1 = uv1 + rng.normal(size=uv1.shape).astype(np.float32) * 0.5
    is2 = (1.0 / 1.5 ** (2 * rng.integers(0, 4, (2, 300)))).astype(np.float32)
    init = np.asarray(jse3.sim3_exp(jnp.asarray([0.01, 0.02, -0.01, 0.01, 0.0, -0.02,
                                                 0.0 if fix_scale else 0.03]))) @ S12
    obs = dict(pc1=pc1, pc2=pc2, uv1=uv1, uv2=uv2, inv_sigma2_1=is2[0],
               inv_sigma2_2=is2[1], valid=valid)
    cam_j = jproj.Camera.create(FX, FX, CX, CY, bf=40.0, width=640, height=480)
    cam_t = tproj.Camera.create(FX, FX, CX, CY, bf=40.0, width=640, height=480)
    Sj, inl_j, n_j = jopt.optimize_sim3(
        cam_j, jnp.asarray(init, jnp.float32),
        jopt.Sim3Obs(**{k: jnp.asarray(v) for k, v in obs.items()}), fix_scale)
    St, inl_t, n_t = topt.optimize_sim3(
        cam_t, _t(init.astype(np.float32)), topt.Sim3Obs(**{k: _t(v) for k, v in obs.items()}),
        fix_scale)
    np.testing.assert_allclose(_np(St), np.asarray(Sj), atol=TOL)
    np.testing.assert_array_equal(_np(inl_t), np.asarray(inl_j))
    assert int(n_t) == int(n_j) > 150


def test_free_scale_ransac_then_optimize():
    """The monocular chain, 7 DoF: RANSAC fed JAX's draws, then OptimizeSim3
    from its result, on clouds related by a Sim3 with s = e^0.1; both steps
    as JAX, and the scale recovered."""
    rng = np.random.default_rng(4)
    pc1, pc2, uv1, uv2, valid, S12 = _matched_clouds(rng, fix_scale=False, outliers=0.2)
    M = pc1.shape[0]
    me = np.full(M, 9.210, np.float32)
    key = jax.random.PRNGKey(23)
    p = jnp.asarray(valid, jnp.float32) / max(valid.sum(), 1)
    idx = jax.vmap(lambda k: jax.random.choice(k, M, (3,), replace=False, p=p))(
        jax.random.split(key, 300))
    Sj, inl_j, _, _ = jsim.ransac_sim3(
        key, jnp.asarray(pc1), jnp.asarray(pc2), jnp.asarray(uv1), jnp.asarray(uv2), 300,
        False, max_err1=jnp.asarray(me), max_err2=jnp.asarray(me),
        valid=jnp.asarray(valid), fx=FX, fy=FX, cx=CX, cy=CY, min_inliers=20)
    St, inl_t, _, ok_t = tsim.ransac_sim3(
        _t(pc1), _t(pc2), _t(uv1), _t(uv2), 300, False, max_err1=_t(me), max_err2=_t(me),
        valid=_t(valid), fx=FX, fy=FX, cx=CX, cy=CY, min_inliers=20, hyp_idx=_t(idx))
    np.testing.assert_allclose(_np(St), np.asarray(Sj), atol=TOL)
    np.testing.assert_array_equal(_np(inl_t), np.asarray(inl_j))
    obs = dict(pc1=pc1, pc2=pc2, uv1=uv1, uv2=uv2, inv_sigma2_1=np.ones(M, np.float32),
               inv_sigma2_2=np.ones(M, np.float32), valid=_np(inl_t))
    cam_j = jproj.Camera.create(FX, FX, CX, CY, bf=40.0, width=640, height=480)
    cam_t = tproj.Camera.create(FX, FX, CX, CY, bf=40.0, width=640, height=480)
    Oj, oinl_j, on_j = jopt.optimize_sim3(
        cam_j, Sj, jopt.Sim3Obs(**{k: jnp.asarray(v) for k, v in obs.items()}), False)
    Ot, oinl_t, on_t = topt.optimize_sim3(
        cam_t, St, topt.Sim3Obs(**{k: _t(v) for k, v in obs.items()}), False)
    np.testing.assert_allclose(_np(Ot), np.asarray(Oj), atol=TOL)
    np.testing.assert_array_equal(_np(oinl_t), np.asarray(oinl_j))
    assert int(on_t) == int(on_j) >= 20
    s = float(tse3.sim3_split(Ot)[0])
    assert abs(s - np.exp(0.1)) < 5e-3 and abs(s - 1.0) > 0.09


def _two_keyframes(rng, N=600):
    """Two keyframes' feature tables seeing one point cloud, descriptors
    with per-view bit noise."""
    P = 500
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(2.5, 6, P)], -1).astype(np.float32)
    desc = rng.integers(0, 256, (P, 32), dtype=np.uint8)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jse3.se3_exp(jnp.asarray([0.15, -0.02, 0.05, 0.02, 0.08, -0.01],
                                             jnp.float32)))
    out = []
    for T in (T1, T2):
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = FX * pc[:, :2] / pc[:, 2:] + [CX, CY] + rng.normal(size=(P, 2)) * 0.4
        order = rng.permutation(P)
        xy = np.zeros((N, 2), np.float32)
        xy[:P] = uv[order]
        xy[P:] = rng.uniform([0, 0], [640, 480], (N - P, 2))
        oc = rng.integers(0, 3, N).astype(np.int32)
        d = rng.integers(0, 256, (N, 32), dtype=np.uint8)
        flip = rng.random((P, 32)) < 0.03
        d[:P] = desc[order] ^ (flip * rng.integers(1, 256, (P, 32))).astype(np.uint8)
        pt_id = np.full(N, -1, np.int32)
        pt_id[:P] = order
        out.append(dict(T=T, xy=xy, oct=oc, desc=d, pt=pt_id, valid=np.ones(N, bool)))
    dist = np.linalg.norm(X - 0.0, axis=-1)
    return X, desc, dist, out


def test_search_by_sim3_and_scw():
    rng = np.random.default_rng(4)
    X, desc, dist, (k1, k2) = _two_keyframes(rng)
    S12 = k1["T"] @ np.linalg.inv(k2["T"])  # camera 2 -> camera 1 (scale 1)
    sf = np.array([1.5 ** i for i in range(4)], np.float32)
    bounds = np.array([0, 640, 0, 480], np.float32)
    cam_j = jproj.Camera.create(FX, FX, CX, CY, bf=40.0, width=640, height=480)
    cam_t = tproj.Camera.create(FX, FX, CX, CY, bf=40.0, width=640, height=480)

    def side(k, conv, unpack):
        ok = k["pt"] >= 0
        w = X[np.clip(k["pt"], 0, None)]
        d = dist[np.clip(k["pt"], 0, None)]
        return [conv(a) for a in (k["xy"], k["oct"])] + [unpack(conv(k["desc"]))] + [
            conv(a) for a in (k["valid"], w, ok, 0.5 * d, 2.0 * d)] + [
            unpack(conv(desc[np.clip(k["pt"], 0, None)]))]

    already1 = np.zeros(600, bool)
    already1[:40] = True
    already2 = np.zeros(600, bool)
    already2[10:30] = True
    mj, nj = jax.jit(lambda *a: jmat.search_by_sim3(cam_j, *a, bounds=bounds, scale_factors=sf))(
        jnp.asarray(k1["T"]), jnp.asarray(k2["T"]), jnp.asarray(S12, jnp.float32),
        *side(k1, jnp.asarray, jham.unpack_bits), *side(k2, jnp.asarray, jham.unpack_bits),
        jnp.asarray(already1), jnp.asarray(already2))
    mt, nt = tmat.search_by_sim3(
        cam_t, _t(k1["T"]), _t(k2["T"]), _t(S12.astype(np.float32)),
        *side(k1, _t, tham.unpack_bits), *side(k2, _t, tham.unpack_bits),
        _t(already1), _t(already2), bounds, sf)
    np.testing.assert_array_equal(_np(mt), np.asarray(mj))
    assert int(nt) == int(nj) > 100

    # Scw projection of the cloud into keyframe 2 (a Sim3 pose with scale 1.2)
    Scw = np.diag([1.2, 1.2, 1.2, 1.0]).astype(np.float32) @ k2["T"]
    normal = X / np.linalg.norm(X, axis=-1, keepdims=True)
    ok = rng.random(500) > 0.05
    matched = np.zeros(600, bool)
    matched[::7] = True
    args = (X, ok, 0.5 * dist, 2.0 * dist, normal)
    pj, npj = jax.jit(lambda *a: jmat.search_by_projection_scw(
        cam_j, *a, bounds=bounds, scale_factors=sf))(
        jnp.asarray(Scw), *map(jnp.asarray, args), jham.unpack_bits(jnp.asarray(desc)),
        jnp.asarray(k2["xy"]), jnp.asarray(k2["oct"]), jham.unpack_bits(jnp.asarray(k2["desc"])),
        jnp.asarray(k2["valid"]), jnp.asarray(matched))
    pt_, npt = tmat.search_by_projection_scw(
        cam_t, _t(Scw), *map(_t, args), tham.unpack_bits(_t(desc)), _t(k2["xy"]),
        _t(k2["oct"]), tham.unpack_bits(_t(k2["desc"])), _t(k2["valid"]), _t(matched),
        bounds, sf)
    np.testing.assert_array_equal(_np(pt_), np.asarray(pj))
    assert int(npt) == int(npj) > 200
