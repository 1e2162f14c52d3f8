"""Parity: the port's monocular two-view initializer (`ops/initializer.py`)
and `matching.search_for_initialization` against the JAX package on the
same numpy inputs (made from a seed).

Tolerances: normalization, homography / fundamental scores and parallax
cosines 1e-4 relative; H and F compared up to sign; decompositions as sets
of (R, t) within 1e-4 (the SVD's sign and basis choices order them); the
whole bootstrap on `test_solvers.py`'s three scenes, fed the JAX run's 200
hypothesis draws: equal success, `used_h`, winning candidate and good mask,
R21 and t21 within 1e-4, points within 1e-3 relative. The match search
gives identical match arrays on two real ORB frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_solvers
from orbslam_mapsave_tpu import config as jcfg
from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.ops import initializer as jini
from orbslam_mapsave_tpu.ops import matching as jmat
from orbslam_mapsave_tpu.pipeline import system as jsys
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.ops import initializer as tini
from orbslam_mapsave_tpu_torch.ops import matching as tmat

torch.set_num_threads(2)
REL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_hypotheses(key, valid: np.ndarray, n_hyp: int = 200) -> np.ndarray:
    """The (n_hyp, 8) match indices `jini.initialize_two_view(key, ...)`
    draws."""
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(p.sum(), 1)
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, valid.shape[0], (8,), replace=False, p=p))(keys))


def _pure_rotation(rng):
    """`test_solvers.test_initializer_rejects_pure_rotation`'s scene: no
    translation, so the parallax gate must reject."""
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], np.float32)
    n = 300
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 9, n)], -1)
    R21 = np.asarray(jse3.so3_exp(jnp.asarray([0.0, -0.1, 0.0])))
    pc2 = pts @ R21.T
    uv1 = np.stack([fx * pts[:, 0] / pts[:, 2] + cx, fy * pts[:, 1] / pts[:, 2] + cy], -1)
    uv2 = np.stack([fx * pc2[:, 0] / pc2[:, 2] + cx, fy * pc2[:, 1] / pc2[:, 2] + cy], -1)
    valid = np.all((uv2 > 0) & (uv2 < [640, 480]), -1)
    return (jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
            jnp.asarray(valid), jnp.asarray(K), R21, np.zeros(3))


SCENES = {  # (scene, PRNGKey of test_solvers.py)
    "general": (lambda rng: test_solvers._make_two_view(rng, planar=False), 2),
    "planar": (lambda rng: test_solvers._make_two_view(rng, planar=True), 3),
    "pure_rotation": (_pure_rotation, 4),
}


def _scene(name):
    make, seed = SCENES[name]
    return make(np.random.default_rng(42)), jax.random.PRNGKey(seed)


def _sets_match(Rj, tj, Rt, tt, tol=1e-4):
    """Every JAX (R, t) has a port (R, t) within tol, and back."""
    d = (np.abs(Rj[:, None] - Rt[None]).max(axis=(-1, -2))
         + np.abs(tj[:, None] - tt[None]).max(-1))
    return bool((d.min(1) <= tol).all() and (d.min(0) <= tol).all())


def _same_up_to_sign(a, b, tol):
    a = a / np.abs(a).max(axis=(-1, -2), keepdims=True)
    b = b / np.abs(b).max(axis=(-1, -2), keepdims=True)
    s = np.sign(np.sum(a * b, axis=(-1, -2), keepdims=True))
    np.testing.assert_allclose(a, s * b, atol=tol)


def test_normalize_and_dlt():
    rng = np.random.default_rng(0)
    pts = rng.uniform([0, 0], [640, 480], (300, 2)).astype(np.float32)
    valid = rng.random(300) < 0.8
    pj, Tj = jini.normalize_points(jnp.asarray(pts), jnp.asarray(valid))
    pt_, Tt = tini.normalize_points(_t(pts), _t(valid))
    np.testing.assert_allclose(_np(pt_), np.asarray(pj), rtol=REL, atol=1e-5)
    np.testing.assert_allclose(_np(Tt), np.asarray(Tj), rtol=REL, atol=1e-7)
    # 8-point sets of a noisy two-view scene, normalized
    (uv1, uv2, v, K, _, _), _ = _scene("general")
    idx = np.stack([rng.choice(int(np.sum(v)), 8, replace=False) for _ in range(50)])
    s1 = np.asarray(uv1)[np.asarray(v)][idx] / 320.0 - 1.0
    s2 = np.asarray(uv2)[np.asarray(v)][idx] / 320.0 - 1.0
    _same_up_to_sign(_np(tini._dlt_h(_t(s1), _t(s2))),
                     np.asarray(jini._dlt_h(jnp.asarray(s1), jnp.asarray(s2))), 1e-3)
    _same_up_to_sign(_np(tini._dlt_f(_t(s1), _t(s2))),
                     np.asarray(jini._dlt_f(jnp.asarray(s1), jnp.asarray(s2))), 1e-3)


def test_check_h_and_f():
    """Both scores on the planar scene's own homography and fundamental
    matrix, each perturbed 16 ways, and one singular homography (its
    inverse is not finite)."""
    (uv1, uv2, valid, K, R21, t21), _ = _scene("planar")
    rng = np.random.default_rng(1)
    Kn = np.asarray(K, np.float64)
    Kinv = np.linalg.inv(Kn)
    tx = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]], [-t21[1], t21[0], 0]])
    F = Kinv.T @ tx @ R21 @ Kinv
    H = Kn @ (R21 + np.outer(t21, [0.0, 0.0, 1.0]) / 5.0) @ Kinv  # the plane z = 5
    Fs = F * (1.0 + rng.normal(0, 1e-3, (16, 3, 3)))
    Hs = H * (1.0 + rng.normal(0, 1e-3, (16, 3, 3)))
    Hs[0] = 0.0
    for fn_j, fn_t, M in ((jini._check_h, tini._check_h, Hs), (jini._check_f, tini._check_f, Fs)):
        M = M.astype(np.float32)
        sj, ij = fn_j(jnp.asarray(M), uv1, uv2, valid)
        st, it = fn_t(_t(M), _t(uv1), _t(uv2), _t(valid))
        assert np.asarray(ij).sum() > 100
        np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=REL, atol=1e-3)
        np.testing.assert_array_equal(_np(it), np.asarray(ij))


def test_decompositions_and_check_rt():
    """E and H of the planar scene's motion (exact, then two perturbed
    copies) decomposed by both packages; CheckRT over the 12 candidates as
    one batch against JAX's one candidate at a time."""
    (uv1, uv2, valid, K, R21, t21), _ = _scene("planar")
    rng = np.random.default_rng(2)
    Kn = np.asarray(K, np.float64)
    for i in range(3):
        R = R21 @ np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 1e-3 * i, 3))))
        t = t21 + rng.normal(0, 4e-3 * i, 3)
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = (tx @ R).astype(np.float32)
        Ej = jini.decompose_e(jnp.asarray(E))
        Rt_, tt_ = tini.decompose_e(_t(E))
        Rje = np.stack([np.asarray(r) for r, _ in Ej])
        tje = np.stack([np.asarray(x) for _, x in Ej])
        assert _sets_match(Rje, tje, _np(Rt_), _np(tt_))
        H = (Kn @ (R + np.outer(t, [0.0, 0.0, 1.0]) / 5.0) @ np.linalg.inv(Kn)).astype(
            np.float32)
        Hj = jini.decompose_h(jnp.asarray(H), K)
        Rh, th = tini.decompose_h(_t(H), _t(K))
        Rjh = np.stack([np.asarray(r) for r, _ in Hj])
        tjh = np.stack([np.asarray(x) for _, x in Hj])
        assert _sets_match(Rjh, tjh, _np(Rh), _np(th))
        # CheckRT over all 12 candidates at once against JAX's one by one
        Rs, ts = np.concatenate([Rje, Rjh]), np.concatenate([tje, tjh])
        n_t, cos_t, good_t, X_t = tini.check_rt(_t(Rs), _t(ts), _t(uv1), _t(uv2),
                                                _t(valid), _t(K))
        for c in range(12):
            n_j, cos_j, good_j, X_j = jini.check_rt(jnp.asarray(Rs[c]), jnp.asarray(ts[c]),
                                                    uv1, uv2, valid, K)
            assert int(n_t[c]) == int(n_j)
            np.testing.assert_array_equal(_np(good_t[c]), np.asarray(good_j))
            np.testing.assert_allclose(float(cos_t[c]), float(cos_j), rtol=1e-6)
            g = np.asarray(good_j)
            np.testing.assert_allclose(_np(X_t[c])[g], np.asarray(X_j)[g], rtol=1e-3,
                                       atol=1e-4)
        assert int(n_t.max()) > 250  # the true motion is among the candidates


@pytest.mark.parametrize("name", list(SCENES))
def test_initialize_two_view_with_jax_draws(name):
    (uv1, uv2, valid, K, R21, t21), key = _scene(name)
    oj = jax.device_get(jini.initialize_two_view(key, uv1, uv2, valid, 200, K))
    idx = jax_hypotheses(key, np.asarray(valid))
    ot = tini.initialize_two_view(_t(uv1), _t(uv2), _t(valid), _t(K), 200, hyp_idx=_t(idx))
    assert bool(ot["success"]) == bool(oj["success"])
    assert bool(ot["used_h"]) == bool(oj["used_h"])
    assert int(ot["n_good"]) == int(oj["n_good"])
    np.testing.assert_allclose(float(ot["sh"]), float(oj["sh"]), rtol=REL)
    np.testing.assert_allclose(float(ot["sf"]), float(oj["sf"]), rtol=REL)
    if name == "pure_rotation":
        assert not bool(ot["success"])
        return
    assert bool(ot["success"])
    # the winner: the JAX candidate whose (R, t) is the one returned
    Rj, tj = oj["R21"], oj["t21"]
    np.testing.assert_allclose(_np(ot["R21"]), Rj, atol=1e-4)
    np.testing.assert_allclose(_np(ot["t21"]), tj, atol=1e-4)
    good = oj["good"]
    np.testing.assert_array_equal(_np(ot["good"]), good)
    X = oj["points3d"][good]
    np.testing.assert_allclose(_np(ot["points3d"])[good], X, rtol=1e-3, atol=1e-4)
    # and the bootstrap recovers the true motion (as test_solvers.py asserts)
    np.testing.assert_allclose(_np(ot["R21"]), R21, atol=3e-2)


def test_draw_hypotheses():
    valid = torch.zeros(300, dtype=torch.bool)
    valid[::3] = True
    gen = torch.Generator().manual_seed(0)
    idx = tini.draw_hypotheses(valid, 200, gen)
    assert idx.shape == (200, 8)
    assert bool(valid[idx].all())
    assert all(len(set(r.tolist())) == 8 for r in idx)


def _orb_frames():
    """Two 320x240 mono frames 8 cm apart of `test_mono_slam.py`'s lateral
    sequence, built by the JAX package's FrameBuilder."""
    W, H, FX = 320, 240, 200.0
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    room = synthetic.BoxRoom(half_size=2.0, seed=9)
    cfg = jcfg.SystemConfig()
    cfg.camera = jcfg.CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                                   bf=0.0, fps=30)
    cfg.orb = jcfg.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints = 768
    slam = jsys.SLAMSystem(cfg, jsys.Sensor.MONOCULAR, enable_loop_closing=False,
                           enable_mapping=False)
    out = []
    for i in (0, 1):
        T = np.eye(4)
        T[0, 3], T[2, 3] = 0.08 * i, -0.01 * i
        g = room.render(K, T, W, H)[0].astype(np.uint8)
        out.append(jax.device_get(slam.builder.build(g.astype(np.float32), i / 30.0)))
    return out


def test_search_for_initialization_on_orb_frames():
    f1, f2 = _orb_frames()
    args = []
    for f in (f1, f2):
        args += [f.kp_xy, f.kp_angle, f.desc_bits, f.valid & (f.kp_octave == 0)]
    mj, nj = jmat.search_for_initialization(*[jnp.asarray(a) for a in args])
    mt, nt = tmat.search_for_initialization(*[_t(a) for a in args])
    assert int(nj) > 100  # enough for the bootstrap to try
    np.testing.assert_array_equal(_np(mt), np.asarray(mj))
    assert int(nt) == int(nj)
