"""Parity: the port's EPnP and RANSAC PnP against the JAX package on the
problems of `test_epnp.py` (exact, minimal 4-point, outliers, a `valid`
mask), made from a seed with numpy. RANSAC is fed the JAX run's own
hypothesis indices (`jax.random.choice` with the keys `ransac_pnp` splits),
so both sides solve the same 4-point sets. Tolerances: poses within 1e-3
of each other, inlier masks and counts equal. A minimal 4-point set has a
4-dimensional null space whose basis each eigensolver picks its own way,
and its pose depends on that basis: there the null spaces are compared as
spaces, the pose stage from JAX's basis (1e-4), and each package's share
of minimal sets that recover the true pose."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_epnp import make_pnp

from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.ops import epnp as jepnp
from orbslam_mapsave_tpu_torch.ops import epnp as tepnp

torch.set_num_threads(2)
POSE_TOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _pose_err(T, T_ref) -> float:
    """|se3_log(inv(T_ref) @ T)| in the JAX package's own log."""
    return float(np.linalg.norm(np.asarray(jse3.se3_log(jnp.asarray(
        np.linalg.inv(np.asarray(T_ref, np.float64)) @ np.asarray(T, np.float64),
        jnp.float32)))))


def jax_hypotheses(key, valid: np.ndarray, n_hyp: int) -> np.ndarray:
    """The (n_hyp, 4) indices `jepnp.ransac_pnp(key, ...)` draws."""
    M = valid.shape[0]
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(p.sum(), 1)
    keys = jax.random.split(key, n_hyp)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(k, M, (4,), replace=False, p=p))(keys))


def _norm(uv, fx, fy, cx, cy):
    return np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1).astype(np.float32)


def _jax_null_space(pts, uvn, w):
    cws = jepnp._choose_control_points(pts, w)
    alphas = jepnp._barycentric(pts, cws)
    _, evecs = jnp.linalg.eigh(jepnp._fill_MtM(alphas, uvn, w))
    return cws, alphas, jnp.swapaxes(evecs[..., :4], -1, -2)


def test_epnp_exact_matches_jax(rng):
    """12 exact points (a one-vector null space): the same pose as JAX and
    the ground truth within test_epnp.py's 1e-3."""
    pts, uv, T, (fx, fy, cx, cy), _ = make_pnp(rng, n=12)
    uvn = _norm(uv, fx, fy, cx, cy)
    pj = np.asarray(jax.jit(jepnp.epnp)(jnp.asarray(pts)[None], jnp.asarray(uvn)[None],
                                        jnp.ones((1, 12), jnp.float32)))[0]
    pt = tepnp.epnp(_t(pts)[None], _t(uvn)[None], torch.ones(1, 12)).numpy()[0]
    assert _pose_err(pt, pj) <= POSE_TOL
    assert _pose_err(pt, T) < 1e-3


def test_epnp_minimal_4pt_matches_jax(rng):
    """test_epnp.py's minimal 4-point set: M^T M has a 4-dimensional null
    space whose basis each eigensolver picks its own way. The two spaces
    are equal (projectors within 1e-4), and from JAX's basis the port's
    pose stage gives JAX's pose (1e-4) within test_epnp.py's 5e-2 of the
    truth."""
    pts, uv, T, (fx, fy, cx, cy), _ = make_pnp(rng, n=4)
    uvn = _norm(uv, fx, fy, cx, cy)
    P, U, W = jnp.asarray(pts)[None], jnp.asarray(uvn)[None], jnp.ones((1, 4), jnp.float32)
    cws, alphas, V = (np.asarray(x) for x in jax.jit(_jax_null_space)(P, U, W))
    pj = np.asarray(jax.jit(jepnp.epnp)(P, U, W))[0]
    _, _, Vt = tepnp._null_space(_t(pts)[None], _t(uvn)[None], torch.ones(1, 4))
    Vt = Vt.numpy()[0]
    np.testing.assert_allclose(Vt.T @ Vt, V[0].T @ V[0], atol=1e-4)
    pt = tepnp._pose_from_null_space(_t(cws), _t(alphas), _t(V), _t(pts)[None],
                                     _t(uvn)[None], torch.ones(1, 4)).numpy()[0]
    assert _pose_err(pt, pj) <= 1e-4
    assert _pose_err(pt, T) < 5e-2


def test_epnp_minimal_sets_recover_the_pose_as_often(rng):
    """Over 500 minimal sets of one exact scene, each package's own
    eigensolver: the port's share of sets whose pose lands within 1 cm of
    the truth is no lower than JAX's (~0.71) by more than 0.05, about two
    standard errors of the difference at 500 sets."""
    pts, uv, T, (fx, fy, cx, cy), _ = make_pnp(rng, n=200)
    uvn = _norm(uv, fx, fy, cx, cy)
    idx = np.stack([rng.choice(200, 4, replace=False) for _ in range(500)])
    pj = np.asarray(jax.jit(jepnp.epnp)(jnp.asarray(pts[idx]), jnp.asarray(uvn[idx]),
                                        jnp.ones((500, 4), jnp.float32)))
    pt = tepnp.epnp(_t(pts[idx]), _t(uvn[idx]), torch.ones(500, 4)).numpy()
    hit_j, hit_t = (float(np.mean(np.abs(p[:, :3, 3] - T[:3, 3]).max(-1) < 1e-2))
                    for p in (pj, pt))
    assert hit_j > 0.5 and hit_t >= hit_j - 0.05, (hit_t, hit_j)


def test_epnp_noisy_sets_match_jax(rng):
    """64 sets of 8 points of one scene with pixel noise, in one batch (a
    one-vector null space): every pose as JAX's."""
    pts, uv, _, (fx, fy, cx, cy), _ = make_pnp(rng, n=60, noise=0.3)
    uvn = _norm(uv, fx, fy, cx, cy)
    idx = np.stack([rng.choice(60, 8, replace=False) for _ in range(64)])
    pj = np.asarray(jax.jit(jepnp.epnp)(jnp.asarray(pts[idx]), jnp.asarray(uvn[idx]),
                                        jnp.ones((64, 8), jnp.float32)))
    pt = tepnp.epnp(_t(pts[idx]), _t(uvn[idx]), torch.ones(64, 8)).numpy()
    errs = [_pose_err(a, b) for a, b in zip(pt, pj)]
    assert max(errs) <= POSE_TOL, errs


def _ransac_both(key, pts, uv, max_err2, valid, n_hyp, cam):
    fx, fy, cx, cy = cam
    jout = jax.jit(jepnp.ransac_pnp, static_argnums=(5,))(
        key, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(max_err2), jnp.asarray(valid),
        n_hyp, fx, fy, cx, cy)
    hyp = jax_hypotheses(key, valid, n_hyp)
    tout = tepnp.ransac_pnp(_t(pts), _t(uv), _t(max_err2), _t(valid), _t(hyp),
                            fx=fx, fy=fy, cx=cx, cy=cy)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def test_ransac_pnp_with_outliers_matches_jax(rng):
    pts, uv, T, cam, n_out = make_pnp(rng, n=80, noise=0.5, outlier_frac=0.3)
    (pj, ij, nj, okj), (pt, it, nt, okt) = _ransac_both(
        jax.random.PRNGKey(0), pts, uv, np.full(80, 5.991, np.float32), np.ones(80, bool),
        300, cam)
    assert bool(okj) and bool(okt) and int(nt) == int(nj) > 40
    np.testing.assert_array_equal(it, ij)
    assert it[:n_out].sum() <= 2
    assert _pose_err(pt, pj) <= POSE_TOL and _pose_err(pt, T) < 2e-2


def test_ransac_pnp_respects_valid_matches_jax(rng):
    pts, uv, T, cam, _ = make_pnp(rng, n=60, noise=0.2)
    valid = np.ones(60, bool)
    valid[:20] = False
    pts[:20] = 1e3  # garbage, must be ignored
    (pj, ij, nj, okj), (pt, it, nt, okt) = _ransac_both(
        jax.random.PRNGKey(1), pts, uv, np.full(60, 5.991, np.float32), valid, 200, cam)
    assert bool(okj) and bool(okt) and int(nt) == int(nj)
    np.testing.assert_array_equal(it, ij)
    assert not it[:20].any()
    assert _pose_err(pt, pj) <= POSE_TOL and _pose_err(pt, T) < 2e-2


def test_ransac_pnp_batched_equals_one_by_one(rng):
    """Three problems with a leading batch (the relocalizer's candidate
    axis) give what three single calls give."""
    probs = [make_pnp(rng, n=50, noise=0.3, outlier_frac=0.2) for _ in range(3)]
    cam = probs[0][3]
    valid = np.ones((3, 50), bool)
    valid[1, :10] = False
    hyp = np.stack([jax_hypotheses(jax.random.PRNGKey(7 + c), valid[c], 100) for c in range(3)])
    args = [np.stack([p[i] for p in probs]) for i in (0, 1)]
    max_err2 = np.full((3, 50), 5.991, np.float32)
    batched = tepnp.ransac_pnp(_t(args[0]), _t(args[1]), _t(max_err2), _t(valid), _t(hyp),
                               *cam)
    for c in range(3):
        one = tepnp.ransac_pnp(_t(args[0][c]), _t(args[1][c]), _t(max_err2[c]),
                               _t(valid[c]), _t(hyp[c]), *cam)
        np.testing.assert_array_equal(batched[1][c].numpy(), one[1].numpy())
        assert int(batched[2][c]) == int(one[2]) and bool(batched[3][c]) == bool(one[3])
        np.testing.assert_allclose(batched[0][c].numpy(), one[0].numpy(), atol=1e-5)


def test_draw_hypotheses():
    """4 distinct valid rows per hypothesis, every valid row drawn."""
    valid = torch.zeros(40, dtype=torch.bool)
    valid[torch.arange(3, 40, 3)] = True
    gen = torch.Generator()
    gen.manual_seed(3)
    idx = tepnp.draw_hypotheses(valid, 300, gen)
    assert idx.shape == (300, 4)
    assert bool(valid[idx].all())
    assert all(len(set(r)) == 4 for r in idx.tolist())
    assert set(idx.flatten().tolist()) == set(torch.nonzero(valid).flatten().tolist())
