"""Parity: the port's SE3 / projection / LM solve against the JAX package.

Same seeded numpy inputs to both; float32 on the CPU; atol 1e-6. Outputs in
pixels (values up to ~650, where one float32 ulp is 6e-5) are held to a
relative 1e-6 instead: the two frameworks round the same f32 formulas
differently in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.optim import lm as jlm
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.geometry import se3 as tse3
from orbslam_mapsave_tpu_torch.optim import lm as tlm

torch.set_num_threads(2)
ATOL = 1e-6


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol, atol=atol)


def _xi(seed, n=64, rot=0.8, trans=1.0):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.uniform(-trans, trans, (n, 3)),
                         rng.uniform(-rot, rot, (n, 3))], -1).astype(np.float32)
    xi[0] = 0.0  # theta = 0 exactly
    xi[1, 3:] = [1e-5, -2e-5, 1e-5]  # Taylor branch
    return xi


@pytest.mark.parametrize("fn", ["se3_exp", "so3_exp", "hat"])
def test_exp_and_hat(fn):
    xi = _xi(0)
    arg = xi if fn == "se3_exp" else xi[:, 3:]
    _close(getattr(jse3, fn)(jnp.asarray(arg)),
           getattr(tse3, fn)(torch.from_numpy(arg)))


def test_log_inv_transform_orthonormalize():
    xi = _xi(1)
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    Tt = torch.from_numpy(T)
    _close(jse3.se3_log(jnp.asarray(T)), tse3.se3_log(Tt), atol=2e-6)
    _close(jse3.se3_inv(jnp.asarray(T)), tse3.se3_inv(Tt))
    pts = np.random.default_rng(2).normal(size=(64, 10, 3)).astype(np.float32)
    _close(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts)),
           tse3.transform_points(Tt, torch.from_numpy(pts)), atol=2e-6)
    noisy = T.copy()
    noisy[:, :3, :3] += np.random.default_rng(3).normal(0, 1e-3, (64, 3, 3))
    _close(jse3.orthonormalize(jnp.asarray(noisy)),
           tse3.orthonormalize(torch.from_numpy(noisy)))


@pytest.mark.parametrize("dist", [False, True])
def test_project_undistort_backproject(dist):
    d = dict(k1=-0.2, k2=0.05, p1=1e-3, p2=-5e-4, k3=0.01) if dist else {}
    args = (520.0, 515.0, 320.0, 240.0)
    jc = jproj.Camera.create(*args, bf=41.6, **d)
    tc = tproj.Camera.create(*args, bf=41.6, **d)
    rng = np.random.default_rng(4)
    uv = rng.uniform([0, 0], [640, 480], (256, 2)).astype(np.float32)
    pts = rng.uniform([-2, -2, 0.5], [2, 2, 6], (256, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 6, 256).astype(np.float32)
    # 10 fixed-point iterations amplify last-bit differences near the
    # corners under strong distortion: measured 3.1e-5 px
    _close(jproj.undistort_points(jc, jnp.asarray(uv)),
           tproj.undistort_points(tc, torch.from_numpy(uv)),
           atol=1e-4 if dist else ATOL, rtol=1e-6)
    for a, b in zip(jproj.project(jc, jnp.asarray(pts)),
                    tproj.project(tc, torch.from_numpy(pts))):
        _close(a, b, rtol=1e-6)
    _close(jproj.backproject(jc, jnp.asarray(uv), jnp.asarray(depth)),
           tproj.backproject(tc, torch.from_numpy(uv), torch.from_numpy(depth)))
    np.testing.assert_array_equal(jproj.compute_image_bounds(jc),
                                  tproj.compute_image_bounds(tc))


def _spd(seed, scale):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(40, 6)) * scale
    return (J.T @ J).astype(np.float32), rng.normal(size=6).astype(np.float32)


@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_solve_spd(lam):
    H, g = _spd(5, np.array([1e3, 1e3, 1e2, 1e4, 1e4, 1e5]))
    a = np.asarray(jlm.solve_spd(jnp.asarray(H), jnp.asarray(g), jnp.float32(lam)))
    b = tlm.solve_spd(torch.from_numpy(H), torch.from_numpy(g),
                      torch.tensor(lam, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=ATOL)


def test_solve_spd_not_spd_gives_zero():
    H = np.diag([1.0, -4.0, 2.0, 3.0, 1.0, 5.0]).astype(np.float32)
    H[0, 1] = H[1, 0] = 3.0
    g = np.ones(6, np.float32)
    lam = 1e-4
    a = np.asarray(jlm.solve_spd(jnp.asarray(H), jnp.asarray(g), jnp.float32(lam)))
    b = tlm.solve_spd(torch.from_numpy(H), torch.from_numpy(g),
                      torch.tensor(lam)).numpy()
    np.testing.assert_array_equal(b, np.zeros(6, np.float32))
    np.testing.assert_array_equal(a, b)


def test_lm_jacobians_and_huber():
    rng = np.random.default_rng(6)
    p = rng.uniform([-2, -2, 0.5], [2, 2, 6], (128, 3)).astype(np.float32)
    _close(jlm.proj_jacobian(jnp.asarray(p), 520.0, 515.0),
           tlm.proj_jacobian(torch.from_numpy(p), 520.0, 515.0), rtol=1e-6)
    _close(jlm.point_pose_jacobian(jnp.asarray(p)),
           tlm.point_pose_jacobian(torch.from_numpy(p)))
    chi2 = rng.uniform(0, 20, 128).astype(np.float32)
    d2 = np.where(rng.random(128) < 0.3, 7.815, 5.991).astype(np.float32)
    _close(jlm.huber_weight(jnp.asarray(chi2), jnp.asarray(d2)),
           tlm.huber_weight(torch.from_numpy(chi2), torch.from_numpy(d2)))


def test_quaternions_match_jax():
    """quat_to_rot / rot_to_quat on random rotations plus the identity and
    half turns about each axis (each of Shepperd's four branches wins
    somewhere), and unnormalized and zero quaternions: within 1e-6."""
    rng = np.random.default_rng(4)
    w = rng.normal(0, 1.5, (64, 3))
    R = np.asarray(jse3.so3_exp(jnp.asarray(w, jnp.float32)))
    half = [np.diag(d).astype(np.float32) for d in ([1, 1, 1], [1, -1, -1], [-1, 1, -1],
                                                    [-1, -1, 1])]
    R = np.concatenate([R, np.stack(half)])
    qj = np.asarray(jse3.rot_to_quat(jnp.asarray(R)))
    qt = tse3.rot_to_quat(torch.from_numpy(R)).numpy()
    assert np.abs(qj - qt).max() <= 1e-6
    q = np.concatenate([rng.normal(0, 2, (32, 4)), np.zeros((1, 4))]).astype(np.float32)
    Rj = np.asarray(jse3.quat_to_rot(jnp.asarray(q)))
    Rt = tse3.quat_to_rot(torch.from_numpy(q)).numpy()
    assert np.abs(Rj - Rt).max() <= 1e-6
    back = tse3.quat_to_rot(tse3.rot_to_quat(torch.from_numpy(R))).numpy()
    assert np.abs(back - R).max() <= 1e-5


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_rt_to_mat_equals_the_host_scalar_construction(batch):
    """`rt_to_mat` sets the homogeneous 1 with a device fill; the values are
    those of the construction that wrote it as a host scalar, and the JAX
    package's."""
    rng = np.random.default_rng(7)
    R = torch.from_numpy(rng.normal(size=batch + (3, 3)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=batch + (3,)).astype(np.float32))
    bottom = torch.zeros(batch + (1, 4))
    bottom[..., 0, 3] = 1.0
    old = torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)
    new = tse3.rt_to_mat(R, t)
    assert new.shape == batch + (4, 4) and new.dtype == old.dtype
    assert torch.equal(new, old)
    np.testing.assert_array_equal(
        np.asarray(jse3.rt_to_mat(jnp.asarray(R.numpy()), jnp.asarray(t.numpy()))), new.numpy())
