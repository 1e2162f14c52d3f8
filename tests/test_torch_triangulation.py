"""Parity: the port's triangulation (`ops/initializer.triangulate_dlt`,
`ops/matching.search_for_triangulation`, `pipeline/triangulation.py`)
against the JAX package. The map state is the perturbed pre-mapping state
of `test_torch_local_mapping.py` (a JAX run, handed over through
`interop`), on which a fifth of the points the new keyframe shares with a
neighbour were erased, so their features are triangulation candidates.
The port runs all neighbours in one batched pass, the JAX package vmaps
(or loops) over them: matches, masks and slots must be equal, new points
(and the normals and scale bands derived from them) within 2e-4 relative
(1e-5 on well-conditioned views)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_local_mapping import perturb, premap_case, to_port

from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.ops import hamming as jham
from orbslam_mapsave_tpu.ops import initializer as jinit
from orbslam_mapsave_tpu.ops import matching as jmatch
from orbslam_mapsave_tpu.pipeline import triangulation as jtri
from orbslam_mapsave_tpu.slammap import mapstate as jms
from orbslam_mapsave_tpu_torch import interop
from orbslam_mapsave_tpu_torch.ops import hamming as tham
from orbslam_mapsave_tpu_torch.ops import initializer as tinit
from orbslam_mapsave_tpu_torch.ops import matching as tmatch
from orbslam_mapsave_tpu_torch.pipeline import triangulation as ttri

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    js, st, kf, recent_start, _ = premap_case()
    st = perturb(st, kf, recent_start)
    neigh = jms.covisible_keyframes(st, kf, 10)
    return dict(js=js, state=st, tstate=to_port(st), kf=kf, neigh=np.asarray(neigh))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_triangulate_dlt():
    """Random well-conditioned views; the port broadcasts a batch of second
    cameras, the JAX function is called once per camera."""
    rng = np.random.default_rng(0)
    K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]])
    X = rng.uniform([-1, -1, 3], [1, 1, 6], (50, 3))

    def proj(T):
        P = (K @ T[:3, :4]).astype(np.float32)
        x = (P @ np.c_[X, np.ones(50)].T).T
        return P, (x[:, :2] / x[:, 2:] + rng.normal(size=(50, 2)) * 0.05).astype(np.float32)

    P1, uv1 = proj(np.eye(4))
    cams = [proj(np.asarray(jse3.se3_exp(jnp.asarray(
        np.r_[rng.normal(size=3) * 0.5, rng.normal(size=3) * 0.05]))))
        for _ in range(4)]
    P2 = np.stack([c[0] for c in cams])
    uv2 = np.stack([c[1] for c in cams])
    out = tinit.triangulate_dlt(_t(P1), _t(P2), _t(uv1), _t(uv2)).numpy()
    f64 = tinit.triangulate_dlt(*[_t(a).double() for a in (P1, P2, uv1, uv2)]).numpy()
    for r in range(4):
        ref = np.asarray(jinit.triangulate_dlt(jnp.asarray(P1), jnp.asarray(P2[r]),
                                               jnp.asarray(uv1), jnp.asarray(uv2[r])))
        np.testing.assert_allclose(out[r], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out[r], f64[r], rtol=1e-5, atol=1e-5)


def test_compute_f12_and_median_depth(case):
    js, st, ts, kf, neigh = case["js"], case["state"], case["tstate"], case["kf"], case["neigh"]
    nb = neigh[neigh >= 0]
    F = ttri.compute_f12(js.cam, ts.kf_pose[kf], ts.kf_pose[_t(nb).long()]).numpy()
    for i, k in enumerate(nb):
        ref = np.asarray(jtri.compute_f12(js.cam, st.kf_pose[kf], st.kf_pose[int(k)]))
        np.testing.assert_allclose(F[i], ref, rtol=1e-5, atol=1e-7 * np.abs(ref).max())
    med = ttri._median_scene_depth(ts, _t(np.r_[kf, nb]), js.cam).numpy()
    ref = [float(jtri._median_scene_depth(st, int(k), js.cam)) for k in np.r_[kf, nb]]
    np.testing.assert_allclose(med, ref, rtol=1e-6)


_jit_search = jax.jit(jmatch.search_for_triangulation,
                      static_argnames="check_epipole_dist")


@pytest.mark.parametrize("mono", [False, True])
def test_search_for_triangulation(case, mono):
    """All neighbours in one batched call against the JAX function pair by
    pair (mono adds the epipole-distance gate)."""
    js, st, ts, kf, neigh = case["js"], case["state"], case["tstate"], case["kf"], case["neigh"]
    nb = neigh[neigh >= 0]
    ls2 = 1.0 / js.builder.inv_level_sigma2
    un1 = st.kf_kp_valid[kf] & (st.kf_kp_point[kf] < 0)
    T1 = st.kf_pose[kf]
    O1 = jse3.se3_inv(T1)[:3, 3]
    from orbslam_mapsave_tpu.geometry import projection as jproj

    refs, F, ep = [], [], []
    for k in nb:
        k = int(k)
        T2 = st.kf_pose[k]
        F12 = jtri.compute_f12(js.cam, T1, T2)
        e, _ = jproj.project(js.cam, jse3.transform_points(T2, O1[None])[0])
        F.append(np.asarray(F12))
        ep.append(np.asarray(e))
        m, n = _jit_search(
            st.kf_kp_xy[kf], st.kf_kp_octave[kf], jham.unpack_bits(st.kf_desc[kf]), un1,
            st.kf_kp_xy[k], st.kf_kp_octave[k], jham.unpack_bits(st.kf_desc[k]),
            st.kf_kp_valid[k] & (st.kf_kp_point[k] < 0), F12, e, ls2,
            check_epipole_dist=mono, angle_1=st.kf_kp_angle[kf], angle_2=st.kf_kp_angle[k])
        refs.append((np.asarray(m), int(n)))
    nbl = _t(nb).long()
    m, n = tmatch.search_for_triangulation(
        ts.kf_kp_xy[kf], ts.kf_kp_octave[kf], tham.unpack_bits(ts.kf_desc[kf]), _t(un1),
        ts.kf_kp_xy[nbl], ts.kf_kp_octave[nbl], tham.unpack_bits(ts.kf_desc[nbl]),
        ts.kf_kp_valid[nbl] & (ts.kf_kp_point[nbl] < 0), _t(np.stack(F)), _t(np.stack(ep)),
        _t(ls2), check_epipole_dist=mono, angle_1=ts.kf_kp_angle[kf],
        angle_2=ts.kf_kp_angle[nbl])
    for i, (mj, nj) in enumerate(refs):
        np.testing.assert_array_equal(m[i].numpy(), mj, err_msg=str(i))
        assert int(n[i]) == nj
    assert int(n.sum()) > 20


@pytest.mark.parametrize("mono", [False, True])
def test_triangulate_batched_and_finalize(case, mono):
    """The whole batched pass — candidates over every neighbour, first
    matching neighbour per feature, one allocation + both observations —
    then descriptors and normals of the new points."""
    js, st, ts, kf, neigh = case["js"], case["state"], case["tstate"], case["kf"], case["neigh"]
    args = (js.builder.scale_factors, 1.0 / js.builder.inv_level_sigma2, 4, 1.5, mono)
    jt = jtri.make_triangulator(js.cam, *args)
    tt = ttri.make_triangulator(js.cam, *args)
    jst, jslots = jax.jit(jt.batched)(st, jnp.asarray(kf, jnp.int32), jnp.asarray(neigh))
    tst, tslots = tt.batched(ts, kf, _t(neigh))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    if not mono:
        assert int((tslots >= 0).sum()) > 20
    jst = jt.finalize_idx(jst, jnp.clip(jslots, 0), jslots >= 0)
    tst = tt.finalize_idx(tst, torch.clamp(tslots, min=0), tslots >= 0)
    a, b = {k: np.asarray(v) for k, v in jst._asdict().items()}, interop.map_state_to_numpy(tst)
    for k in a:
        if a[k].dtype.kind == "f":
            # linear triangulation solves 3x3 normal equations in float32:
            # near the parallax limit they lose digits on both sides, and the
            # new points' normals and scale bands follow their positions
            rtol = 2e-4 if k in ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist") else 1e-5
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
