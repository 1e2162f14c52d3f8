"""Parity: the port's ORB extraction against the JAX package at 320x240 and
640x480, 4 levels, on rendered BoxRoom frames.

What is exact and what is not, as measured:
- resize matrices: the JAX ones come out of an XLA fusion that rounds the
  sample positions differently from a plain float32 evaluation; its rows
  sum to 1 within 3.2e-6, the port's within 1.2e-7. Held to 5e-6.
- pyramid: the resize is two float32 matrix products rounded to integers.
  XLA and PyTorch sum the products in different orders, so a pixel whose
  exact value sits on a half-integer (within 1e-4) can round either way:
  a handful per level. Every other pixel is bit-exact.
- the descriptor blur is rounded to integers too: XLA fuses its shift-adds
  with FMAs, so a blurred value on a half-integer may round the other way
  (2 pixels in 700k measured).
- FAST score map, NMS, cell top-k, patch cut, IC angle and BRIEF are exact
  on the same level image (angles within 1e-3 deg).
- end to end, keypoint sets (x, y, octave) are identical; a response (its
  tie-breaker), an angle or a descriptor may differ only where the
  keypoint's 49x49 patch covers one of the tie pixels above; >= 99.5% of
  descriptors are bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu.ops import orb as jorb
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.ops import orb as torb
from orbslam_mapsave_tpu_torch.ops.orb_pattern import BIT_PATTERN_31

torch.set_num_threads(2)
SIZES = [(320, 240, 600), (640, 480, 2000)]


def _image(W, H, frame=3):
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1.0]])
    room = synthetic.BoxRoom(half_size=2.0, seed=11)
    g, _ = room.render(K, synthetic.circle_trajectory(10)[frame], W, H)
    return np.clip(g, 0, 255).astype(np.uint8).astype(np.float32)


def _specs(W, H, nf):
    kw = dict(n_features=nf, n_levels=4, scale_factor=1.5,
              max_kp=2048 if nf > 1000 else 768)
    return jorb.ORBSpec.create(H, W, **kw), torb.ORBSpec.create(H, W, **kw)


@pytest.fixture(scope="module", params=SIZES, ids=["320x240", "640x480"])
def case(request):
    W, H, nf = request.param
    img = _image(W, H)
    jspec, tspec = _specs(W, H, nf)
    jpyr = [np.array(a) for a in jax.jit(
        lambda im: jorb.build_pyramid(jspec, im))(jnp.asarray(img))]
    kj = {k: np.asarray(v) for k, v in jax.jit(
        lambda im: jorb.extract(jspec, im))(jnp.asarray(img)).items()}
    kt = {k: v.numpy() for k, v in torb.extract(tspec, torch.from_numpy(img)).items()}
    return dict(img=img, jspec=jspec, tspec=tspec, jpyr=jpyr, kj=kj, kt=kt)


@pytest.mark.parametrize("size", [(480, 320), (320, 213), (213, 142), (240, 160),
                                  (160, 107), (107, 71)])
def test_resize_matrices(size):
    n_in, n_out = size
    Rj = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32),
                                     (n_out, n_in), method="linear"))
    Rt = torb.resize_matrix(n_in, n_out)
    assert Rt.shape == Rj.shape and Rt.dtype == np.float32
    assert np.abs(Rj - Rt).max() <= 5e-6
    assert np.abs(Rt.sum(1) - 1.0).max() <= 2e-7
    assert np.array_equal(Rj != 0, Rt != 0)


def _tie_pixels(prev, R_h, R_w, a, b):
    """Pixels where a != b must differ by 1 and sit on a half-integer."""
    diff = a != b
    exact = R_h.astype(np.float64) @ prev.astype(np.float64) @ R_w.astype(np.float64).T
    frac = np.abs(exact[diff] - np.floor(exact[diff]) - 0.5)
    assert np.all(np.abs(a - b)[diff] == 1.0)
    assert np.all(frac < 1e-4), frac.max()
    return int(diff.sum())


def test_pyramid_levels(case):
    """Each level, computed by the port from the JAX version's previous
    level, is bit-exact except for half-integer rounding ties."""
    jpyr, tspec = case["jpyr"], case["tspec"]
    E = torb.EDGE
    prev = case["img"]
    n_ties = 0
    for lvl, ls in enumerate(tspec.levels):
        ref = jpyr[lvl]
        if lvl == 0:
            got = torb.reflect101_pad(torch.from_numpy(prev), E).numpy()
            np.testing.assert_array_equal(got, ref)
            continue
        R_h = torb.resize_matrix(prev.shape[0], ls.height)
        R_w = torb.resize_matrix(prev.shape[1], ls.width)
        got = torch.round(torch.from_numpy(R_h) @ torch.from_numpy(prev)
                          @ torch.from_numpy(R_w).T).numpy()
        inner = ref[E:-E, E:-E]
        n_ties += _tie_pixels(prev, R_h, R_w, inner, got)
        np.testing.assert_array_equal(
            torb.reflect101_pad(torch.from_numpy(inner), E).numpy(), ref)
        prev = inner
    assert n_ties <= 10


def test_fast_nms_and_cells_on_same_level(case):
    jspec, tspec, jpyr = case["jspec"], case["tspec"], case["jpyr"]
    E = torb.EDGE
    fast = jax.jit(lambda im: jorb.fast_score_map(im, jspec.min_th))
    for lvl, (jls, tls) in enumerate(zip(jspec.levels, tspec.levels)):
        inner = jpyr[lvl][E:E + jls.height, E:E + jls.width]
        sj = np.array(fast(jnp.asarray(inner)))
        st = torb.fast_score_map(torch.from_numpy(inner), tspec.min_th).numpy()
        assert np.abs(sj - st).max() <= 1e-6
        np.testing.assert_array_equal(np.asarray(jax.jit(jorb._nms3)(jnp.asarray(sj))),
                                      torb._nms3(torch.from_numpy(sj)).numpy())
        xj, vj = jax.jit(lambda p, ls=jls: jorb.detect_level(jspec, ls, p))(
            jnp.asarray(jpyr[lvl]))
        xt, vt = torb.detect_level(tspec, tls, torch.from_numpy(jpyr[lvl]))
        np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_angles_and_brief_on_same_level(case):
    """IC angle + BRIEF from the same level and keypoints: angles within
    1e-3 deg, descriptors bit-exact."""
    jspec, jpyr = case["jspec"], case["jpyr"]
    W43 = 2 * torb.DESC_PAD + 1

    @jax.jit
    def jax_side(padded, xy):
        stack = jnp.stack([padded, jnp.rint(jorb.gaussian_blur7(padded))])
        pj = jorb.cut_patches_2ch(stack, xy)
        aj = jorb.ic_angles_from_patches(pj[:, 0].astype(jnp.float32))
        dj = jorb.brief_from_patches(pj[:, 1, 3:3 + W43, 3:3 + W43], aj)
        return stack, pj.astype(jnp.float32), aj, dj

    for lvl, ls in enumerate(jspec.levels):
        xy, score = jax.jit(lambda p, ls=ls: jorb.detect_level(jspec, ls, p))(
            jnp.asarray(jpyr[lvl]))
        sel = np.argsort(-np.asarray(score), kind="stable")[:ls.budget]
        xy = np.asarray(xy)[sel]
        stack, pj, aj, dj = [np.asarray(a) for a in jax_side(jnp.asarray(jpyr[lvl]),
                                                             jnp.asarray(xy))]
        # the blur is rounded to integers; XLA fuses its shift-adds with
        # FMAs, so a value on a half-integer may round the other way
        blur = torb.gaussian_blur7(torch.from_numpy(jpyr[lvl])).numpy()
        diff = stack[1] != np.round(blur)
        assert np.all(np.abs(blur[diff] - np.floor(blur[diff]) - 0.5) < 1e-4)
        assert diff.sum() <= 5
        # the rest of the chain on the same stack: exact
        pt = torb.cut_patches_2ch(torch.from_numpy(stack), torch.from_numpy(xy))
        np.testing.assert_array_equal(pj, pt.numpy())
        at = torb.ic_angles_from_patches(pt[:, 0])
        assert np.abs(aj - at.numpy()).max() <= 1e-3
        dt = torb.brief_from_patches(pt[:, 1, 3:3 + W43, 3:3 + W43],
                                     torch.from_numpy(aj)).numpy()
        np.testing.assert_array_equal(dj, dt)


def _touched(case, kj) -> np.ndarray:
    """Keypoints whose patch touches a pyramid pixel that differs between
    the packages (a rounding tie)."""
    tspec, jpyr = case["tspec"], case["jpyr"]
    tpyr = torb.build_pyramid(tspec, torch.from_numpy(case["img"]))
    touched = np.zeros(kj["valid"].shape, bool)
    r = torb.DESC_PAD + 3
    for lvl, ls in enumerate(tspec.levels):
        dy, dx = np.nonzero(jpyr[lvl] != tpyr[lvl].numpy())
        on = kj["valid"] & (kj["octave"] == lvl)
        lx = np.round(kj["xy"][:, 0] / ls.scale) + torb.EDGE
        ly = np.round(kj["xy"][:, 1] / ls.scale) + torb.EDGE
        for y, x in zip(dy, dx):
            touched |= on & (np.abs(lx - x) <= r) & (np.abs(ly - y) <= r)
    return touched


def test_extract_end_to_end(case):
    kj, kt, jpyr, tspec = case["kj"], case["kt"], case["jpyr"], case["tspec"]
    vj, vt = kj["valid"], kt["valid"]
    np.testing.assert_array_equal(vj, vt)
    key = lambda k, v: set(map(tuple, np.c_[k["xy"][v], k["octave"][v]].tolist()))  # noqa: E731
    assert key(kj, vj) == key(kt, vt)
    np.testing.assert_array_equal(kj["xy"], kt["xy"])
    np.testing.assert_array_equal(kj["octave"], kt["octave"])
    ok = vj & ~_touched(case, kj)
    np.testing.assert_allclose(kj["response"][ok], kt["response"][ok], rtol=0, atol=1e-6)
    assert np.abs(kj["angle_deg"][ok] - kt["angle_deg"][ok]).max() <= 1e-3
    same = (kj["desc"] == kt["desc"]).all(-1)
    assert same[ok].all()
    assert same[vj].mean() >= 0.995


def _level_sizes(H, W, n_levels=4, scale=1.5):
    return [(int(round(H / scale**i)), int(round(W / scale**i))) for i in range(1, n_levels)]


@pytest.mark.parametrize("n_in", [480, 640, 240, 320, 96, 1241, 376])
def test_nearest_index_matches_jax(n_in):
    """The mask's level sampling is `jax.image.resize(..., "nearest")`'s,
    index for index, at every level size of the scale-1.5 pyramid (the
    bench spec's 320x427, 213x284 and 142x190 among them)."""
    for n_out in {s for hw in _level_sizes(n_in, n_in, 7) for s in hw if s >= 2}:
        ref = np.asarray(jax.jit(lambda x, n=n_out: jax.image.resize(x, (n,), "nearest"))(
            jnp.arange(n_in, dtype=jnp.float32))).astype(np.int64)
        np.testing.assert_array_equal(torb.nearest_index(n_in, n_out), ref, err_msg=str(n_out))
    m = np.random.default_rng(0).random((n_in, 64)) > 0.5
    for h, _ in _level_sizes(n_in, 64):
        ref = np.asarray(jax.image.resize(jnp.asarray(m, jnp.float32), (h, 64), "nearest"))
        got = torb.resize_mask_nearest(torch.from_numpy(m.astype(np.float32)), h, 64)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.fixture(scope="module", params=["half", "off-grid"])
def masked(case, request):
    """Masked extraction in both packages: the right half zeroed as in
    test_orb.py's mask test, or every column from W/2 - 3 on, an edge that
    falls off the 1.5-scale grid, so that nearest sampling decides which
    level pixels are masked."""
    img, jspec, tspec = case["img"], case["jspec"], case["tspec"]
    H, W = img.shape
    mask = np.ones((H, W), np.float32)
    mask[:, W // 2 - (3 if request.param == "off-grid" else 0):] = 0.0
    kj = {k: np.asarray(v) for k, v in jax.jit(
        lambda im, m: jorb.extract(jspec, im, m))(jnp.asarray(img), jnp.asarray(mask)).items()}
    kt = {k: v.numpy() for k, v in torb.extract(tspec, torch.from_numpy(img),
                                                torch.from_numpy(mask)).items()}
    return dict(mask=mask, kj=kj, kt=kt)


def test_masked_extract_matches_jax(masked):
    """The same keypoints (x, y, octave, order) and the same descriptors as
    the JAX version's masked extraction. (Unmasked, a descriptor whose patch
    covers a pyramid rounding tie may differ; on these frames and masks
    none does.) Angles within 1e-2 deg: measured 0.008 at keypoints whose
    patch covers a tie, as unmasked."""
    kj, kt = masked["kj"], masked["kt"]
    v = kj["valid"]
    np.testing.assert_array_equal(v, kt["valid"])
    np.testing.assert_array_equal(kj["xy"], kt["xy"])
    np.testing.assert_array_equal(kj["octave"], kt["octave"])
    np.testing.assert_array_equal(kj["desc"][v], kt["desc"][v])
    assert np.abs(kj["angle_deg"][v] - kt["angle_deg"][v]).max() <= 1e-2


def test_masked_extract_keeps_out_of_the_mask(case, masked):
    """No valid keypoint's level pixel lies in the masked region at its
    level's nearest resize; the level budgets refill from unmasked corners
    (more keypoints on the open half than the unmasked run keeps there)."""
    kt, mask, tspec = masked["kt"], masked["mask"], case["tspec"]
    v = kt["valid"]
    for lvl, ls in enumerate(tspec.levels):
        m = torb.resize_mask_nearest(torch.from_numpy(mask), ls.height, ls.width).numpy()
        on = v & (kt["octave"] == lvl)
        lx = np.round(kt["xy"][on, 0] / ls.scale).astype(int)
        ly = np.round(kt["xy"][on, 1] / ls.scale).astype(int)
        assert (m[ly, lx] > 0).all(), lvl
    W = mask.shape[1]
    open_half = case["kt"]["valid"] & (case["kt"]["xy"][:, 0] < W // 2 - 3)
    assert v.sum() > open_half.sum()
    assert (kt["xy"][v, 0] < W // 2 + 2).all()


@pytest.mark.parametrize("hw", [(720, 1280), (480, 640), (240, 320)])
def test_device_tables_equal_the_per_call_tables(hw):
    """The tables ORB keeps on its device equal what each call used to copy
    there: the resize matrices at every level pair, the mask's nearest rows
    at every level, the IC moments, the BRIEF pattern and the bit weights;
    each is built once per device."""
    H, W = hw
    cpu = torch.device("cpu")
    spec = torb.ORBSpec.create(H, W, n_features=2000)
    prev_h, prev_w = H, W
    for ls in spec.levels[1:]:
        for n_in, n_out in ((prev_h, ls.height), (prev_w, ls.width)):
            got = torb.resize_matrix_on(n_in, n_out, cpu)
            assert torch.equal(got, torch.from_numpy(torb.resize_matrix(n_in, n_out)))
            assert torb.resize_matrix_on(n_in, n_out, cpu) is got
        prev_h, prev_w = ls.height, ls.width
    for ls in spec.levels[1:]:
        for n_in, n_out in ((H, ls.height), (W, ls.width)):
            got = torb.nearest_index_on(n_in, n_out, cpu)
            assert torch.equal(got, torch.from_numpy(torb.nearest_index(n_in, n_out)))
    t = torb.angle_brief_tables(cpu)
    assert torb.angle_brief_tables(cpu) is t
    assert torch.equal(t.ic_du, torch.from_numpy(torb._IC_DU))
    assert torch.equal(t.ic_dv, torch.from_numpy(torb._IC_DV))
    pat = torch.from_numpy(np.asarray(BIT_PATTERN_31, np.float32))
    assert torch.equal(t.px, torch.cat([pat[:, 0], pat[:, 2]]))
    assert torch.equal(t.py, torch.cat([pat[:, 1], pat[:, 3]]))
    assert torch.equal(t.bit_weights, torch.tensor([1, 2, 4, 8, 16, 32, 64, 128],
                                                   dtype=torch.int32))


@pytest.mark.parametrize("sensor", ["rgbd", "mono", "masked"])
def test_build_from_sensor_dtypes_equals_build_from_f32(sensor):
    """FrameBuilder.build from the sensor's u8 image and f16 depth equals the
    build from their float32 casts, field for field."""
    from orbslam_mapsave_tpu_torch.geometry import projection
    from orbslam_mapsave_tpu_torch.pipeline import frame

    W, H = 320, 240
    img = _image(W, H).astype(np.uint8)
    depth = np.linspace(0.5, 4.0, H * W, dtype=np.float32).reshape(H, W).astype(np.float16)
    depth[::7, ::5] = 0.0  # holes
    mask = None
    if sensor == "masked":
        mask = np.ones((H, W), np.float32)
        mask[60:200, 100:180] = 0.0
    cam = projection.Camera.create(0.8 * W, 0.8 * W, W / 2, H / 2, bf=0.8 * W * 0.08,
                                   width=W, height=H)
    builder = frame.FrameBuilder(cam, _specs(W, H, 600)[1], "cpu")
    frames = [builder.build(im, 0.25, None if sensor == "mono" else d, mask)
              for im, d in ((img, depth), (img.astype(np.float32), depth.astype(np.float32)))]
    for name, a, b in zip(frame.FrameData._fields, *frames):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(frames[0].valid.sum()) > 100
