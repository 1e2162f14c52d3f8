"""FrameBuilder on the card, where each ORB extraction is one CUDA graph
replay, against the same builds with ORB's eager body (`orb._extract`)
and the inputs copied from pageable memory, as the builder did before it
captured graphs.

Eight consecutive frames of the benchmark's room through its 1280x720
camera (`slambench/configs/rgbd-1280x720-orb2000.json`): every FrameData
field is bit-identical to the eager build, for RGB-D from the sensor's u8
image and f16 depth, from their f32 casts and from device tensors, for
monocular, human-masked and stereo builds. A frame stays as built while
later frames are built and the caller reuses its arrays; one graph is
captured for one input kind and replayed once a frame; a steady build
makes no host sync.

Needs a CUDA device; skipped elsewhere. On the card (`tests/conftest.py`
imports jax, which the card lacks):
    python -m pytest tests/test_torch_frame_graph.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu_torch.geometry import projection
from orbslam_mapsave_tpu_torch.io import synthetic
from orbslam_mapsave_tpu_torch.ops import orb
from orbslam_mapsave_tpu_torch.pipeline import frame
from orbslam_mapsave_tpu_torch.utils import metrics

pytestmark = pytest.mark.cuda

W, H, N = 1280, 720, 8
CAM = projection.Camera.create(929.764, 930.318, 645.6, 358.178, bf=33.0, width=W, height=H)
SPEC = orb.ORBSpec.create(H, W, n_features=2000, n_levels=4, scale_factor=1.5,
                          ini_th=15, min_th=3, max_kp=2048)
MASK = np.ones((H, W), np.float32)
MASK[150:600, 500:760] = 0.0  # a person in front of the camera


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames():
    """N frames of the benchmark's room: (u8 image, f16 depth in m rounded
    to mm, u8 right image at the camera's baseline)."""
    room = synthetic.BoxRoom(1.5, seed=11)
    traj = synthetic.circle_trajectory(240)
    base = CAM.bf / CAM.fx
    out = []
    for Twc in traj[40:40 + N]:
        g, d = room.render(CAM.K.astype(np.float64), Twc, W, H)
        right = Twc.copy()
        right[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([base, 0.0, 0.0])
        gr, _ = room.render(CAM.K.astype(np.float64), right, W, H)
        out.append((np.clip(np.round(g), 0, 255).astype(np.uint8),
                    (np.round(d * 1000.0) / 1000.0).astype(np.float16),
                    np.clip(np.round(gr), 0, 255).astype(np.uint8)))
    return out


def _eager(dev) -> frame.FrameBuilder:
    """A builder that runs ORB's eager body and copies from pageable memory."""
    b = frame.FrameBuilder(CAM, SPEC, dev)

    def eager_orb(image, mask=None):
        image = torch.as_tensor(image).to(dev, torch.float32)
        if mask is not None:
            mask = torch.as_tensor(mask).to(dev, torch.float32)
        return orb._extract(SPEC, image, mask)

    b.orb = eager_orb
    b.staging = lambda name, x, out=None: torch.as_tensor(x).to(dev)
    return b


def _build(b: frame.FrameBuilder, kind: str, fr, k: int, dev=None):
    img, dep, right = fr
    t = k / 30.0
    if kind == "rgbd_f32":
        return b.build(img.astype(np.float32), t, dep.astype(np.float32))
    if kind == "rgbd_device":
        return b.build(torch.from_numpy(img).to(dev), t, torch.from_numpy(dep).to(dev))
    if kind == "mono":
        return b.build(img, t)
    if kind == "masked":
        return b.build(img, t, dep, MASK)
    if kind == "stereo":
        return b.build_stereo(img, right, t)
    return b.build(img, t, dep)


def _assert_same(got, want, what):
    for name, a, b in zip(frame.FrameData._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert torch.equal(a, b), (what, name, (a != b).sum().item())


@pytest.mark.parametrize("kind", ["rgbd", "rgbd_f32", "rgbd_device", "mono", "masked",
                                  "stereo"])
def test_graph_build_is_bit_identical_to_eager(dev, frames, kind):
    g, e = frame.FrameBuilder(CAM, SPEC, dev), _eager(dev)
    for k, fr in enumerate(frames):
        want = _build(e, "rgbd" if kind.startswith("rgbd") else kind, fr, k)
        got = _build(g, kind, fr, k, dev)
        _assert_same(got, want, (kind, k))
        assert int(got.valid.sum()) > 1000, (kind, k)
    if kind == "stereo":  # both sides' extractions, the right one last
        for side in (frames[-1][0], frames[-1][2]):
            got, want = g.orb(side), e.orb(side)
            for name in want:
                assert torch.equal(got[name], want[name]), name


def test_frame_stays_as_built_through_later_builds(dev, frames):
    g, e = frame.FrameBuilder(CAM, SPEC, dev), _eager(dev)
    g.build(frames[0][0], 0.0, frames[0][1])  # the capture
    torch.cuda.synchronize()
    built = []
    for k in range(1, 4):  # back to back, no sync between
        img, dep = frames[k][0].copy(), frames[k][1].copy()
        built.append(g.build(img, k / 30.0, dep))
        img[:] = 0  # the caller reuses its arrays at once
        dep[:] = 0
    torch.cuda.synchronize()
    for k, fr in zip(range(1, 4), built):
        _assert_same(fr, _build(e, "rgbd", frames[k], k), k)


def test_one_capture_and_one_replay_a_frame(dev, frames):
    metrics.reset()
    metrics.enable()
    try:
        g = frame.FrameBuilder(CAM, SPEC, dev)
        for k, fr in enumerate(frames):
            _build(g, "rgbd", fr, k)
        torch.cuda.synchronize()
        s = metrics.summary()
    finally:
        metrics.disable()
        metrics.reset()
    assert s["counters"]["orb.graph_captures"] == 1
    assert s["counters"]["orb.graph_replays"] == N
    assert s["spans"]["orb.extract"]["calls"] == N
    # the stage spans open in the warm-up and the capture only
    assert s["spans"]["orb.pyramid"]["calls"] == 2


def test_steady_build_makes_no_host_sync(dev, frames):
    g = frame.FrameBuilder(CAM, SPEC, dev)
    for k in range(2):  # the capture; every staging buffer allocated
        _build(g, "rgbd", frames[k], k)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(2, N):
            _build(g, "rgbd", frames[k], k)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
