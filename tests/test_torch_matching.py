"""Parity: the port's projection / descriptor searches against the JAX
package on a seeded scene — identical match arrays and counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.geometry import projection as jproj
from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.ops import hamming as jh
from orbslam_mapsave_tpu.ops import matching as jm
from orbslam_mapsave_tpu_torch.geometry import projection as tproj
from orbslam_mapsave_tpu_torch.ops import hamming as th
from orbslam_mapsave_tpu_torch.ops import matching as tm

torch.set_num_threads(2)
ARGS = (520.0, 520.0, 320.0, 240.0)
JCAM = jproj.Camera.create(*ARGS, bf=41.6)
TCAM = tproj.Camera.create(*ARGS, bf=41.6)
BOUNDS = jproj.compute_image_bounds(JCAM)
SF = np.array([1.5**i for i in range(4)], np.float32)


def _scene(seed, P=600, N=512):
    """P world points, their descriptors, and a frame of N keypoints: most
    are noisy projections of the points (descriptor bits flipped at 5%),
    the rest clutter."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2.5, -2, 1.0], [2.5, 2, 7.0], (P, 3)).astype(np.float32)
    desc = rng.integers(0, 256, (P, 32), dtype=np.uint8)
    xi = np.array([0.03, -0.01, 0.02, 0.01, -0.015, 0.005], np.float32)
    pose = np.array(jse3.se3_exp(jnp.asarray(xi)))
    pc = pts @ pose[:3, :3].T + pose[:3, 3]
    uv = np.stack([520 * pc[:, 0] / pc[:, 2] + 320, 520 * pc[:, 1] / pc[:, 2] + 240], -1)
    src = rng.permutation(P)[:N]
    kp_xy = (uv[src] + rng.normal(0, 1.0, (N, 2))).astype(np.float32)
    clutter = rng.random(N) < 0.15
    kp_xy[clutter] = rng.uniform([0, 0], [640, 480], (clutter.sum(), 2))
    kp_desc = desc[src] ^ (rng.random((N, 32)) < 0.03).astype(np.uint8) * \
        rng.integers(1, 256, (N, 32), dtype=np.uint8)
    kp_oct = rng.integers(0, 4, N).astype(np.int32)
    kp_ang = rng.uniform(0, 360, N).astype(np.float32)
    kp_valid = rng.random(N) < 0.95
    pt_oct = np.zeros(P, np.int32)
    pt_oct[src] = kp_oct
    pt_ang = np.zeros(P, np.float32)
    pt_ang[src] = np.mod(kp_ang + np.where(rng.random(N) < 0.8, 3.0,
                                           rng.uniform(0, 360, N)), 360)
    center = -pose[:3, :3].T @ pose[:3, 3]
    dist = np.linalg.norm(pts - center, axis=-1)
    normal = (pts - center) / dist[:, None]
    normal += rng.normal(0, 0.2, normal.shape)
    pt_max = (dist * SF[rng.integers(0, 4, P)] * rng.uniform(0.9, 1.3, P)).astype(np.float32)
    return dict(
        pose=pose, pts=pts, desc=desc, pt_oct=pt_oct, pt_ang=pt_ang,
        pt_valid=rng.random(P) < 0.9, normal=normal.astype(np.float32),
        pt_max=pt_max, pt_min=(pt_max / SF[3]).astype(np.float32),
        kp_xy=kp_xy, kp_desc=kp_desc, kp_oct=kp_oct, kp_ang=kp_ang,
        kp_valid=kp_valid, kp_matched=rng.random(N) < 0.1)


def _j(s, k):
    return jnp.asarray(s[k])


def _t(s, k):
    return torch.from_numpy(np.ascontiguousarray(s[k]))


def _eq(ja, ta):
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("th_", [15.0, 30.0])
def test_search_by_projection_last(seed, th_):
    s = _scene(seed)
    # perturb the predicted pose so windows matter
    pose = s["pose"].copy()
    pose[:3, 3] += np.array([0.01, -0.005, 0.0], np.float32)
    s["pred"] = pose
    ja = jm.search_by_projection_last(
        JCAM, _j(s, "pred"), _j(s, "kp_xy"), _j(s, "kp_oct"), _j(s, "kp_ang"),
        jh.unpack_bits(_j(s, "kp_desc")), _j(s, "kp_valid"),
        _j(s, "pts"), _j(s, "pt_oct"), _j(s, "pt_ang"),
        jh.unpack_bits(_j(s, "desc")), _j(s, "pt_valid"), BOUNDS, SF, th=th_)
    ta = tm.search_by_projection_last(
        TCAM, _t(s, "pred"), _t(s, "kp_xy"), _t(s, "kp_oct"), _t(s, "kp_ang"),
        th.unpack_bits(_t(s, "kp_desc")), _t(s, "kp_valid"),
        _t(s, "pts"), _t(s, "pt_oct"), _t(s, "pt_ang"),
        th.unpack_bits(_t(s, "desc")), _t(s, "pt_valid"), BOUNDS, SF, th=th_)
    _eq(ja, ta)
    assert int(ja[1]) > 50


@pytest.mark.parametrize("seed", [2, 3])
def test_search_by_projection_points(seed):
    s = _scene(seed)
    common = lambda m, b: (  # noqa: E731
        m(s, "kp_xy"), m(s, "kp_oct"), b(m(s, "kp_desc")), m(s, "kp_valid"),
        m(s, "kp_matched"), m(s, "pts"), m(s, "normal"), m(s, "pt_min"),
        m(s, "pt_max"), b(m(s, "desc")), m(s, "pt_valid"))
    ja = jm.search_by_projection_points(
        JCAM, _j(s, "pose"), *common(_j, jh.unpack_bits), BOUNDS, SF, th=3.0)
    ta = tm.search_by_projection_points(
        TCAM, _t(s, "pose"), *common(_t, th.unpack_bits), BOUNDS, SF, th=3.0)
    _eq(ja, ta)
    assert int(ja[1]) > 50


@pytest.mark.parametrize("rotation", [True, False])
def test_search_by_descriptor(rotation):
    s = _scene(4)
    ja = jm.search_by_descriptor(
        jh.unpack_bits(_j(s, "kp_desc")), _j(s, "kp_valid"),
        jh.unpack_bits(_j(s, "desc")), _j(s, "pt_valid"),
        _j(s, "kp_ang"), _j(s, "pt_ang"), check_rotation=rotation)
    ta = tm.search_by_descriptor(
        th.unpack_bits(_t(s, "kp_desc")), _t(s, "kp_valid"),
        th.unpack_bits(_t(s, "desc")), _t(s, "pt_valid"),
        _t(s, "kp_ang"), _t(s, "pt_ang"), check_rotation=rotation)
    _eq(ja, ta)
    assert int(ja[1]) > 50


def test_frustum_and_predict_scale():
    s = _scene(5)
    ja = jm.frustum_check(JCAM, _j(s, "pose"), _j(s, "pts"), _j(s, "normal"),
                          _j(s, "pt_min"), _j(s, "pt_max"), BOUNDS)
    ta = tm.frustum_check(TCAM, _t(s, "pose"), _t(s, "pts"), _t(s, "normal"),
                          _t(s, "pt_min"), _t(s, "pt_max"),
                          torch.from_numpy(BOUNDS))
    ok = np.asarray(ja[0])
    np.testing.assert_array_equal(ok, ta[0].numpy())
    # values on in-frustum rows (points near z = 0 project anywhere); pixel
    # coords keep the last-bit difference of fx*x/z (~300 px, one f32 ulp
    # 3e-5) after adding cx, hence 1e-4 absolute
    for x, y in zip(ja[1:], ta[1:]):
        np.testing.assert_allclose(np.asarray(x)[ok], y.numpy()[ok],
                                   rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(
        np.asarray(jm.predict_scale(ja[3], _j(s, "pt_max"), 1.5, 4)),
        tm.predict_scale(ta[3], _t(s, "pt_max"), 1.5, 4).numpy())
